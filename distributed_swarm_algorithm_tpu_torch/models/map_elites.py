"""User-facing MAP-Elites model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops import map_elites as _k
from ..ops._numerics import recip_mul
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class MAPElites:
    """MAP-Elites quality-diversity search (Mouret & Clune 2015) on the
    CUDA card, or on the CPU with ``device="cpu"``.

    ``descriptor`` maps solutions [K, D] -> behaviors [K, B] expected in
    [lo, hi]; the archive is a ``bins**B`` grid keeping the best solution
    of each behavior cell.  The default descriptor is the first B solution
    coordinates normalized to [0, 1], ``(x + hw) / (2 hw)`` computed as the
    JAX package's compiled generation computes it (a product with the f32
    reciprocal), so that a coordinate on a bin edge finds the same cell.

    >>> opt = MAPElites("rastrigin", dim=6, bins=16, seed=0, device="cpu")
    >>> opt.run(200)
    >>> opt.coverage, opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        dim: int,
        bins: int = 16,
        descriptor: Optional[Callable] = None,
        behavior_dims: int = 2,
        half_width: Optional[float] = None,
        lo: float = 0.0,
        hi: float = 1.0,
        batch: int = 256,
        sigma_mut: float = _k.SIGMA_MUT,
        n_init: int = 256,
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
        if bins < 1:
            raise ValueError(f"bins ({bins}) must be >= 1")
        if descriptor is None:
            if dim < behavior_dims:
                raise ValueError(
                    f"default descriptor needs dim >= {behavior_dims}"
                )
            hw, nb = self.half_width, behavior_dims

            def descriptor(x):
                return recip_mul(x[:, :nb] + hw, 2.0 * hw)

        self.descriptor = descriptor
        self.bins = int(bins)
        self.behavior_dims = int(behavior_dims)
        self.lo, self.hi = float(lo), float(hi)
        self.batch = int(batch)
        self.sigma_mut = float(sigma_mut)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.me_init(
            fn, self.descriptor, dim, self.bins, self.behavior_dims,
            self.half_width, self.lo, self.hi, n_init=n_init, seed=seed,
            device=self.device, **kwargs)

    def step(self, draws: Optional[_k.MEDraws] = None) -> _k.MapElitesState:
        """One generation; ``draws`` replaces the generator's (see
        ``ops.map_elites.MEDraws``)."""
        self.state = _k.me_step(
            self.state, self.objective, self.descriptor, self.bins,
            self.half_width, self.lo, self.hi, self.batch, self.sigma_mut,
            draws=draws)
        return self.state

    def run(self, n_steps: int) -> _k.MapElitesState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        self.state = _k.me_run(
            self.state, self.objective, self.descriptor, n_steps, self.bins,
            self.half_width, self.lo, self.hi, self.batch, self.sigma_mut)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.archive_fit.min())

    @property
    def coverage(self) -> float:
        return float(_k.coverage(self.state))

    def qd_score(self, offset: float = 0.0) -> float:
        return float(_k.qd_score(self.state, offset))

    def elites(self) -> tuple:
        """(positions [K, D], fitnesses [K]) of the filled cells."""
        fit = self.state.archive_fit.cpu().numpy()
        mask = np.isfinite(fit)
        return self.state.archive_pos.cpu().numpy()[mask], fit[mask]
