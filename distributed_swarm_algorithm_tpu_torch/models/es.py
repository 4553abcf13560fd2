"""User-facing OpenAI-ES model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import es as _k
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class ES:
    """OpenAI-style evolution strategy (Salimans et al. 2017) on the CUDA
    card, or on the CPU with ``device="cpu"``: antithetic Gaussian
    sampling, centered-rank shaping, momentum SGD on the search mean.
    ``n`` is the population a generation (even).

    >>> opt = ES("sphere", n=256, dim=6, seed=0, device="cpu")
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        sigma: float = _k.SIGMA,
        lr: float = _k.LR,
        momentum: float = _k.MOMENTUM,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        if isinstance(objective, str):
            fn, default_hw = get_objective(objective)
        else:
            fn, default_hw = objective, 5.12
        self.objective = fn
        self.half_width = float(
            half_width if half_width is not None else default_hw
        )
        if n < 2 or n % 2:
            raise ValueError(f"n ({n}) must be even and >= 2 (antithetic)")
        self.n = int(n)
        self.sigma, self.lr = float(sigma), float(lr)
        self.momentum = float(momentum)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.es_init(fn, dim, self.half_width, seed=seed,
                                device=self.device, **kwargs)

    def step(self, eps_half: Optional[torch.Tensor] = None) -> _k.ESState:
        """One generation; ``eps_half`` [n/2, D] replaces the normal draw."""
        self.state = _k.es_step(
            self.state, self.objective, self.n, self.half_width, self.sigma,
            self.lr, self.momentum, eps_half=eps_half)
        return self.state

    def run(self, n_steps: int) -> _k.ESState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        self.state = _k.es_run(
            self.state, self.objective, n_steps, self.n, self.half_width,
            self.sigma, self.lr, self.momentum)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
