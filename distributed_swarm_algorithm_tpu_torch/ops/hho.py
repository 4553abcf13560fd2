"""Harris hawks optimization (Heidari et al. 2019) in plain PyTorch.

Counterpart of ``ops/hho.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/hho_fused.py``.

Per hawk, generation t (T = horizon, rabbit = best so far):
    E = 2 E0 (1 - min(t / T, 1)),  E0 ~ U(-1, 1);  J = 2 (1 - U(0, 1))
    |E| >= 1: explore   (a random hawk's perch or the mean-referenced one)
    |E| <  1: besiege   soft / hard, or a Levy rapid dive (greedy accept)
All six behaviours are computed for every hawk and combined by masks; the
dive's trial points Y and Z are evaluated for the whole population.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from .cuckoo import levy_steps

T_MAX = 1000      # default schedule horizon for the escape-energy decay
LEVY_BETA = 1.5   # Levy exponent for the rapid dives


@dataclass
class HHOState(_family.FamilyState):
    """Struct-of-tensors hawk population. N hawks, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D] the rabbit
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


HHO_TENSOR_FIELDS = _family.tensor_fields(HHOState)

# One generation's twelve draws, in the order of the JAX package's key
# split: e0 [N] in [-1, 1), the jump, perch and dive uniforms u_j, q, r
# [N, 1], the random hawk rand_idx [N] in [0, N), r1..r4 and s [N, D], and
# the Levy dive's two standard normal planes [N, D].
HHODraws = Tuple[torch.Tensor, ...]


def energy_fraction(iteration: torch.Tensor, t_max: int, dtype):
    """``clip((iteration + 1) / t_max, 0, 1)`` as the JAX package's compiled
    step computes it: XLA divides by the constant ``t_max`` as a product
    with its f32 reciprocal.  ``|E| >= 1`` and ``|E| >= 1/2`` are discrete
    decisions made on it, so the port does the same."""
    t = (iteration + 1).to(dtype)
    return torch.clamp(t * (1.0 / t_max), 0.0, 1.0)


def hho_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> HHOState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return HHOState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def hho_draws(state: HHOState) -> HHODraws:
    """One generation's draws from ``state.gen``."""
    n, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen
    u = lambda *s: torch.rand(s, generator=gen, dtype=dt,  # noqa: E731
                              device=dev)
    e0 = -1.0 + 2.0 * u(n)
    rand_idx = torch.randint(0, n, (n,), generator=gen, device=dev)
    normals = [torch.randn((n, d), generator=gen, dtype=dt, device=dev)
               for _ in range(2)]
    return (e0, u(n, 1), u(n, 1), u(n, 1), rand_idx,
            u(n, d), u(n, d), u(n, d), u(n, d), u(n, d), *normals)


def hho_step(
    state: HHOState,
    objective: Callable,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    levy_beta: float = LEVY_BETA,
    draws: Optional[HHODraws] = None,
) -> HHOState:
    """One generation, with no read from the device: the energy-gated
    switch over the six behaviours, with greedy acceptance on the Levy
    dives.  ``draws`` replaces the draws from ``state.gen`` (see
    ``HHODraws``)."""
    n, d = state.pos.shape
    lb, ub = -half_width, half_width
    rabbit = state.best_pos
    (e0, u_j, q, r, rand_idx, r1, r2, r3, r4, s, n_u, n_v) = (
        hho_draws(state) if draws is None else draws)

    frac = energy_fraction(state.iteration, t_max, state.pos.dtype)
    energy = 2.0 * e0 * (1.0 - frac)                    # [N]
    abs_e = torch.abs(energy)[:, None]
    e = energy[:, None]
    jump = 2.0 * (1.0 - u_j)

    # --- exploration (|E| >= 1): perch on a random hawk or below the
    # family mean (Heidari eq. 1) --------------------------------------
    x_rand = state.pos[rand_idx.long()]
    mean = torch.mean(state.pos, dim=0)
    explore_a = x_rand - r1 * torch.abs(x_rand - 2.0 * r2 * state.pos)
    explore_b = (rabbit - mean) - r3 * (lb + r4 * (ub - lb))
    explore = torch.where(q >= 0.5, explore_a, explore_b)

    # --- besiege without dives (r >= 0.5, eqs. 4 & 6) ------------------
    delta = rabbit - state.pos
    soft = delta - e * torch.abs(jump * rabbit - state.pos)
    hard = rabbit - e * torch.abs(delta)
    besiege = torch.where(abs_e >= 0.5, soft, hard)

    # --- besiege with Levy rapid dives (r < 0.5, eqs. 10-13) -----------
    y_soft = rabbit - e * torch.abs(jump * rabbit - state.pos)
    y_hard = rabbit - e * torch.abs(jump * rabbit - mean)
    y = torch.where(abs_e >= 0.5, y_soft, y_hard)
    z = y + s * levy_steps(state.gen, (n, d), levy_beta, state.pos.dtype,
                           state.device, normals=(n_u, n_v))
    y = torch.clamp(y, lb, ub)
    z = torch.clamp(z, lb, ub)
    fy = objective(y)
    fz = objective(z)
    dive = torch.where((fy < state.fit)[:, None], y,
                       torch.where((fz < state.fit)[:, None], z, state.pos))

    exploit = torch.where(r >= 0.5, besiege, dive)
    pos = torch.clamp(torch.where(abs_e >= 1.0, explore, exploit), lb, ub)
    fit = objective(pos)
    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return HHOState(pos=pos, fit=fit, best_pos=best_pos, best_fit=best_fit,
                    gen=state.gen, iteration=state.iteration + 1)


def hho_run(
    state: HHOState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    levy_beta: float = LEVY_BETA,
    draws: Optional[Sequence[HHODraws]] = None,
) -> HHOState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = hho_step(state, objective, half_width, t_max, levy_beta,
                         draws=None if draws is None else draws[i])
    return state


def hho_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> HHOState:
    """An HHOState from numpy arrays named like its fields."""
    return _family.state_from_numpy(HHOState, arrays, device, seed)


def hho_state_to_numpy(state: HHOState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
