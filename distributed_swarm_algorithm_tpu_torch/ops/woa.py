"""Whale optimization algorithm (Mirjalili & Lewis 2016) in plain PyTorch.

Counterpart of ``ops/woa.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/woa_fused.py``.

Per whale, with a: 2 -> 0 over ``t_max`` and p, l, r1, r2 batched draws:
  p < 0.5, |A| <  1:  X' = X*   - A * |C X*   - X|      (encircle)
  p < 0.5, |A| >= 1:  X' = Xr   - A * |C Xr   - X|      (explore)
  p >= 0.5:           X' = |X* - X| e^{b l} cos(2 pi l) + X*   (spiral)
where A = 2a r1 - a, C = 2 r2, Xr a random whale, b the spiral constant.
|A| >= 1 is taken per element, as the batched draws make A elementwise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import div

SPIRAL_B = 1.0   # logarithmic-spiral shape constant (canonical b = 1)


@dataclass
class WOAState(_family.FamilyState):
    """Struct-of-tensors whale pod. N whales, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


WOA_TENSOR_FIELDS = _family.tensor_fields(WOAState)

# One step's draws: r [2, N, D] (A's and C's uniforms), p [N, 1],
# l [N, 1] in [-1, 1), rand_idx [N] (the random peers).
WOADraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def woa_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> WOAState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return WOAState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def woa_draws(state: WOAState) -> WOADraws:
    """One step's draws from ``state.gen``."""
    n, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen
    return (_family.uniform(gen, (2, n, d), dt, dev, 0.0, 1.0),
            _family.uniform(gen, (n, 1), dt, dev, 0.0, 1.0),
            _family.uniform(gen, (n, 1), dt, dev, -1.0, 1.0),
            torch.randint(0, n, (n,), generator=gen, device=dev))


def woa_step(
    state: WOAState,
    objective: Callable,
    half_width: float = 5.12,
    t_max: int = 500,
    spiral_b: float = SPIRAL_B,
    draws: Optional[WOADraws] = None,
) -> WOAState:
    """One pod update, with no read from the device.  ``t_max`` sets the
    a: 2 -> 0 schedule; past it the pod stays in full exploitation (a=0).
    ``draws = (r, p, l, rand_idx)`` replaces the draws from ``state.gen``."""
    if t_max < 1:
        raise ValueError(f"t_max must be >= 1, got {t_max}")
    dt = state.pos.dtype
    r, p, l, rand_idx = woa_draws(state) if draws is None else draws
    frac = torch.clamp(div(state.iteration.to(dt), t_max), max=1.0)
    a = 2.0 * (1.0 - frac)
    big_a = 2.0 * a * r[0] - a                       # [N, D]
    big_c = 2.0 * r[1]                               # [N, D]

    best = state.best_pos[None, :]                   # [1, D]
    x_rand = state.pos[rand_idx.long()]              # [N, D]
    explore = torch.abs(big_a) >= 1.0
    prey = torch.where(explore, x_rand, best)
    contract = prey - big_a * torch.abs(big_c * prey - state.pos)

    dist_best = torch.abs(best - state.pos)
    spiral = (dist_best * torch.exp(spiral_b * l)
              * torch.cos(2.0 * math.pi * l) + best)

    pos = torch.clamp(torch.where(p < 0.5, contract, spiral), -half_width,
                      half_width)
    fit = objective(pos)
    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return WOAState(pos=pos, fit=fit, best_pos=best_pos, best_fit=best_fit,
                    gen=state.gen, iteration=state.iteration + 1)


def woa_run(
    state: WOAState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = 500,
    spiral_b: float = SPIRAL_B,
    draws: Optional[Sequence[WOADraws]] = None,
) -> WOAState:
    """``n_steps`` pod updates; ``draws[i]`` replaces step i's draws."""
    for i in range(n_steps):
        state = woa_step(state, objective, half_width, t_max, spiral_b,
                         draws=None if draws is None else draws[i])
    return state


def woa_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> WOAState:
    """A WOAState from numpy arrays named like its fields."""
    return _family.state_from_numpy(WOAState, arrays, device, seed)


def woa_state_to_numpy(state: WOAState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
