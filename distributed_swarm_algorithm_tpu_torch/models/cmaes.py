"""User-facing CMA-ES optimizer model."""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..ops import _family
from ..ops import cmaes as _k
from ..ops.objectives import get_objective
from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device


class CMAES:
    """Covariance-matrix-adaptation evolution strategy on the CUDA card, or
    on the CPU with ``device="cpu"``.

    ``n`` is the sample count a generation (lambda); Hansen's ``4 + 3 ln
    D`` when omitted.  ``half_width`` (from the objective registry for a
    named objective) box-projects samples before evaluation.  Without a
    ``mean``, a named objective's search starts from a uniform draw in half
    the domain, from a generator seeded with ``seed ^ 0xC3A`` (not the JAX
    package's numbers for that seed).

    >>> opt = CMAES("rosenbrock", dim=10, seed=0, device="cpu")
    >>> opt.run(400)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        dim: int,
        n: Optional[int] = None,
        half_width: Optional[float] = None,
        sigma: Optional[float] = None,
        mean: Optional[torch.Tensor] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if isinstance(objective, str):
            fn, default_hw = get_objective(objective)
        else:
            fn, default_hw = objective, None
        self.objective = fn
        self.half_width = (
            float(half_width) if half_width is not None
            else (float(default_hw) if default_hw is not None else None)
        )
        self.params = _k.cmaes_params(dim, popsize=n)
        if sigma is None:
            # Hansen's rule of thumb: ~0.3x the search-domain width.
            sigma = (0.3 * 2.0 * self.half_width
                     if self.half_width is not None else 0.3)
        self.device = resolve_device(device)
        if mean is None and self.half_width is not None:
            mean = _family.uniform(
                _generator(self.device, seed ^ 0xC3A), (dim,), torch.float32,
                self.device, -0.5 * self.half_width, 0.5 * self.half_width)
        self.state = _k.cmaes_init(dim, sigma=float(sigma), mean=mean,
                                   seed=seed, device=self.device)

    def step(
        self,
        eig: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        z: Optional[torch.Tensor] = None,
    ) -> _k.CMAESState:
        """One generation; ``eig`` and ``z`` replace the eigendecomposition
        and the normal draw (see ``ops.cmaes.cmaes_step``)."""
        self.state = _k.cmaes_step(self.state, self.objective, self.params,
                                   self.half_width, eig=eig, z=z)
        return self.state

    def run(self, n_steps: int) -> _k.CMAESState:
        """Advance ``n_steps`` generations and return the new state (each
        generation's ``eigh`` waits for the card once)."""
        self.state = _k.cmaes_run(self.state, self.objective, self.params,
                                  n_steps, self.half_width)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
