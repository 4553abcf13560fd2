"""Moth-flame optimization (Mirjalili 2015) in plain PyTorch.

Counterpart of ``ops/mfo.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/mfo_fused.py``.

Per moth i, generation t (T = horizon, b = spiral constant):
    n_flames = round(N - t * (N - 1) / T)
    j        = min(i, n_flames - 1)                  (assigned flame)
    l        ~ U(r, 1),  r = -1 - t/T                (goes -1 -> -2)
    M_i      = |F_j - M_i| * exp(b*l) * cos(2*pi*l) + F_j
    flames   = best N of (old flames ++ new moths), a stable sort
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import fma

T_MAX = 1000    # default schedule horizon (flame count + l range decay)
SPIRAL_B = 1.0  # logarithmic-spiral shape constant


@dataclass
class MFOState(_family.FamilyState):
    """Struct-of-tensors moth/flame population. N moths, D dims.  Flames
    are kept sorted by fitness, ascending: flame 0 is the best position
    ever seen."""

    pos: torch.Tensor        # [N, D] moths
    fit: torch.Tensor        # [N]
    flame_pos: torch.Tensor  # [N, D] sorted elite memory
    flame_fit: torch.Tensor  # [N]
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


MFO_TENSOR_FIELDS = _family.tensor_fields(MFOState)


def schedule(iteration: torch.Tensor, n: int, t_max: int, dtype):
    """``(frac, n_flames)`` of the generation after ``iteration``: ``frac =
    clip((iteration + 1) / t_max, 0, 1)`` and ``n_flames = round(n -
    frac (n - 1))`` (half to even), on the device, as the JAX package's
    compiled step computes them: XLA divides by the constant ``t_max`` as a
    product with its f32 reciprocal and fuses ``n - frac (n - 1)`` into one
    multiply-add.  ``n_flames`` is discrete, so the port does the same."""
    t = (iteration + 1).to(dtype)
    frac = torch.clamp(t * (1.0 / t_max), 0.0, 1.0)
    full = torch.full_like(frac, float(n))
    n_flames = torch.round(fma(-frac, torch.full_like(frac, float(n - 1)),
                               full)).to(torch.int32)
    return frac, n_flames


def mfo_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> MFOState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    order = torch.sort(fit, stable=True).indices
    return MFOState(
        pos=pos, fit=fit, flame_pos=pos[order], flame_fit=fit[order],
        gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def mfo_step(
    state: MFOState,
    objective: Callable,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    b: float = SPIRAL_B,
    l: Optional[torch.Tensor] = None,
) -> MFOState:
    """One generation, with no read from the device: spiral flights around
    each moth's flame, then the elitist merge of flames and moths.  ``l``
    [N, D] in [r, 1) replaces the draws from ``state.gen``."""
    n, d = state.pos.shape
    dt = state.pos.dtype
    frac, n_flames = schedule(state.iteration, n, t_max, dt)
    j = torch.minimum(torch.arange(n, device=state.device),
                      (n_flames - 1).long())
    flame = state.flame_pos[j]                          # [N, D]
    r = -1.0 - frac
    if l is None:
        u = torch.rand((n, d), generator=state.gen, dtype=dt,
                       device=state.device)
        l = r + (1.0 - r) * u
    dist = torch.abs(flame - state.pos)
    pos = dist * torch.exp(b * l) * torch.cos(2.0 * math.pi * l) + flame
    pos = torch.clamp(pos, -half_width, half_width)
    fit = objective(pos)

    # Elitist memory: best N of (old flames ++ new moths), a stable sort.
    all_fit = torch.cat([state.flame_fit, fit])
    all_pos = torch.cat([state.flame_pos, pos], dim=0)
    order = torch.sort(all_fit, stable=True).indices[:n]
    return MFOState(pos=pos, fit=fit, flame_pos=all_pos[order],
                    flame_fit=all_fit[order], gen=state.gen,
                    iteration=state.iteration + 1)


def mfo_run(
    state: MFOState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    b: float = SPIRAL_B,
    l: Optional[Sequence[torch.Tensor]] = None,
) -> MFOState:
    """``n_steps`` generations; ``l[i]`` replaces generation i's draws."""
    for i in range(n_steps):
        state = mfo_step(state, objective, half_width, t_max, b,
                         l=None if l is None else l[i])
    return state


def mfo_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> MFOState:
    """An MFOState from numpy arrays named like its fields."""
    return _family.state_from_numpy(MFOState, arrays, device, seed)


def mfo_state_to_numpy(state: MFOState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
