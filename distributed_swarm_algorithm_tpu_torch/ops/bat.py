"""Bat algorithm (Yang 2010) in plain PyTorch.

Counterpart of ``ops/bat.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/bat_fused.py``.

Per bat i per generation (f in [f_min, f_max]; beta, eps, u batched):
    f_i = f_min + (f_max - f_min) * beta
    v_i = v_i + (x_i - x*) * f_i;  cand = x_i + v_i
    if u1 > r_i:  cand = x* + sigma_local * half_width * mean(A) * eps
    accept iff f(cand) <= f(x_i) and u2 < A_i
    on accept: A_i *= alpha;  r_i = r0 * (1 - exp(-gamma * t))

Draws come from ``state.gen`` unless the caller hands them in (``draws``):
PyTorch's generator and JAX's keys give different numbers from one seed,
so a test computes JAX's draws and injects them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family

# Yang's canonical defaults.
F_MIN = 0.0
F_MAX = 2.0
ALPHA = 0.9         # loudness decay on success
GAMMA = 0.9         # pulse-rate growth constant
A0 = 1.0            # initial loudness
R0 = 0.5            # asymptotic pulse rate
SIGMA_LOCAL = 0.1   # local-walk scale (fraction of domain half-width)


@dataclass
class BatState(_family.FamilyState):
    """Struct-of-tensors bat colony. N bats, D dims."""

    pos: torch.Tensor        # [N, D]
    vel: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    loudness: torch.Tensor   # [N]
    pulse: torch.Tensor      # [N]
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


BAT_TENSOR_FIELDS = _family.tensor_fields(BatState)

# One step's draws: beta [N, 1], u_walk [N], eps [N, D] in [-1, 1),
# u_acc [N].
BatDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bat_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> BatState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return BatState(
        pos=pos,
        vel=torch.zeros_like(pos),
        fit=fit,
        loudness=torch.full((n,), A0, dtype=dtype, device=pos.device),
        pulse=torch.zeros((n,), dtype=dtype, device=pos.device),
        best_pos=pos[b],
        best_fit=fit[b],
        gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def bat_draws(state: BatState) -> BatDraws:
    """One step's draws from ``state.gen``."""
    n, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen
    return (_family.uniform(gen, (n, 1), dt, dev, 0.0, 1.0),
            _family.uniform(gen, (n,), dt, dev, 0.0, 1.0),
            _family.uniform(gen, (n, d), dt, dev, -1.0, 1.0),
            _family.uniform(gen, (n,), dt, dev, 0.0, 1.0))


def bat_step(
    state: BatState,
    objective: Callable,
    half_width: float = 5.12,
    f_min: float = F_MIN,
    f_max: float = F_MAX,
    alpha: float = ALPHA,
    gamma: float = GAMMA,
    r0: float = R0,
    sigma_local: float = SIGMA_LOCAL,
    draws: Optional[BatDraws] = None,
) -> BatState:
    """One generation, with no read from the device: frequency flight,
    pulse-gated local walk, loud greedy acceptance, per-bat loudness and
    pulse adaptation.  ``draws`` replaces the draws from ``state.gen``."""
    beta, u_walk, eps, u_acc = bat_draws(state) if draws is None else draws
    dt = state.pos.dtype

    freq = f_min + (f_max - f_min) * beta
    vel = state.vel + (state.pos - state.best_pos) * freq
    cand = state.pos + vel

    # Pulse-gated local walk around the incumbent best: it fires when the
    # draw exceeds the pulse rate.
    walk = u_walk > state.pulse
    mean_a = torch.mean(state.loudness)
    local = state.best_pos + sigma_local * half_width * mean_a * eps
    cand = torch.where(walk[:, None], local, cand)
    cand = torch.clamp(cand, -half_width, half_width)

    cand_fit = objective(cand)
    accept = (cand_fit <= state.fit) & (u_acc < state.loudness)

    pos = torch.where(accept[:, None], cand, state.pos)
    fit = torch.where(accept, cand_fit, state.fit)
    vel = torch.where(accept[:, None], vel, state.vel)
    t = (state.iteration + 1).to(dt)
    loudness = torch.where(accept, state.loudness * alpha, state.loudness)
    pulse = torch.where(accept, r0 * (1.0 - torch.exp(-gamma * t)),
                        state.pulse)

    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return BatState(pos=pos, vel=vel, fit=fit, loudness=loudness,
                    pulse=pulse, best_pos=best_pos, best_fit=best_fit,
                    gen=state.gen, iteration=state.iteration + 1)


def bat_run(
    state: BatState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    f_min: float = F_MIN,
    f_max: float = F_MAX,
    alpha: float = ALPHA,
    gamma: float = GAMMA,
    r0: float = R0,
    sigma_local: float = SIGMA_LOCAL,
    draws: Optional[Sequence[BatDraws]] = None,
) -> BatState:
    """``n_steps`` generations; ``draws[i]`` replaces step i's draws."""
    for i in range(n_steps):
        state = bat_step(state, objective, half_width, f_min, f_max, alpha,
                         gamma, r0, sigma_local,
                         draws=None if draws is None else draws[i])
    return state


def bat_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> BatState:
    """A BatState from numpy arrays named like its fields."""
    return _family.state_from_numpy(BatState, arrays, device, seed)


def bat_state_to_numpy(state: BatState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
