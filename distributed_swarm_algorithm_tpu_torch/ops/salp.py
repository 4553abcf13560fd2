"""Salp swarm algorithm (Mirjalili et al. 2017) in plain PyTorch.

Counterpart of ``ops/salp.py`` of the JAX package: the portable path, on
any device, for any callable objective.  The fused path for named
objectives is ``ops/cuda/salp_fused.py``.

Per generation t (T = schedule horizon, lb/ub = +-half_width):
    c1 = 2 * exp(-(4t/T)^2)
    x_0 = F + sign(c3 - 0.5) * c1 * ((ub - lb) * c2 + lb)   (leader)
    x_i = (x_i + x_{i-1}) / 2                    for i >= 1 (followers)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import div

T_MAX = 1000  # default schedule horizon for the c1 decay


@dataclass
class SalpState(_family.FamilyState):
    """Struct-of-tensors salp chain. N salps, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D]: the food source F
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


SALP_TENSOR_FIELDS = _family.tensor_fields(SalpState)


def salp_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> SalpState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return SalpState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def salp_step(
    state: SalpState,
    objective: Callable,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    c2: Optional[torch.Tensor] = None,
    c3: Optional[torch.Tensor] = None,
) -> SalpState:
    """One generation, with no read from the device: the leader explores
    around the food source under the decaying c1 envelope, the followers
    average down the chain, the food updates greedily.  ``c2``/``c3`` [D]
    replace the leader's draws from ``state.gen``."""
    n, d = state.pos.shape
    dt, dev = state.pos.dtype, state.device
    if c2 is None:
        c2 = torch.rand((d,), generator=state.gen, dtype=dt, device=dev)
    if c3 is None:
        c3 = torch.rand((d,), generator=state.gen, dtype=dt, device=dev)

    t = (state.iteration + 1).to(dt)
    c1 = 2.0 * torch.exp(-(div(4.0 * t, t_max) ** 2))
    lb, ub = -half_width, half_width
    sign = torch.where(c3 >= 0.5, 1.0, -1.0).to(dt)
    leader = state.best_pos + sign * c1 * ((ub - lb) * c2 + lb)

    # Followers: one shifted add down the chain.
    followers = 0.5 * (state.pos[1:] + state.pos[:-1])
    pos = torch.cat([leader[None, :], followers], dim=0)
    pos = torch.clamp(pos, -half_width, half_width)

    fit = objective(pos)
    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return SalpState(pos=pos, fit=fit, best_pos=best_pos, best_fit=best_fit,
                     gen=state.gen, iteration=state.iteration + 1)


def salp_run(
    state: SalpState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> SalpState:
    """``n_steps`` generations; ``draws = (c2, c3)``, each [n_steps, D],
    replaces the leader's draws."""
    for i in range(n_steps):
        c2, c3 = (None, None) if draws is None else (draws[0][i],
                                                     draws[1][i])
        state = salp_step(state, objective, half_width, t_max, c2, c3)
    return state


def salp_state_from_numpy(arrays: Mapping[str, np.ndarray],
                          device: DeviceLike = None, seed: int = 0
                          ) -> SalpState:
    """A SalpState from numpy arrays named like its fields."""
    return _family.state_from_numpy(SalpState, arrays, device, seed)


def salp_state_to_numpy(state: SalpState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
