"""Real-coded genetic algorithm in plain PyTorch.

Counterpart of ``ops/ga.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/ga_fused.py``.

Binary-tournament selection, SBX crossover and polynomial mutation (both
from ``ops/nsga2.py``) and k-elitist replacement: the best ``n_elite``
parents replace the worst children, ranked as ``lax.top_k`` ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import top_k
from .nsga2 import (
    ETA_C,
    ETA_M,
    P_CROSS,
    NSGA2Draws,
    polynomial_mutation,
    sbx_crossover,
    variation_draws,
)

N_ELITE = 2  # unconditionally surviving best individuals


@dataclass
class GAState(_family.FamilyState):
    """Struct-of-tensors population. N individuals, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


GA_TENSOR_FIELDS = _family.tensor_fields(GAState)

# One generation's draws, NSGA-II's layout: H = ceil(N / 2), the two
# tournaments' index pairs t1, t2 [2, H] in [0, N); SBX's (u [H, D],
# do [H, 1]); the mutation's (u [N, D], do [N, D]).
GADraws = NSGA2Draws


def ga_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> GAState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return GAState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def ga_draws(state: GAState) -> GADraws:
    """One generation's draws from ``state.gen``."""
    return variation_draws(state.pos, state.gen)


def ga_step(
    state: GAState,
    objective: Callable,
    half_width: float = 5.12,
    eta_c: float = ETA_C,
    eta_m: float = ETA_M,
    p_cross: float = P_CROSS,
    p_mut: Optional[float] = None,
    n_elite: int = N_ELITE,
    draws: Optional[GADraws] = None,
) -> GAState:
    """One generation, with no read from the device: tournament mating,
    SBX and polynomial mutation, generational replacement with k-elitism.
    ``draws`` replaces the draws from ``state.gen`` (see ``GADraws``)."""
    n, d = state.pos.shape
    if p_mut is None:
        p_mut = 1.0 / d
    lb, ub = -half_width, half_width
    t1, t2, sbx_draws, mut_draws = ga_draws(state) if draws is None else draws

    def tournament(idx):
        a, b = idx[0].long(), idx[1].long()
        return torch.where(state.fit[a] <= state.fit[b], a, b)

    pa = state.pos[tournament(t1)]
    pb = state.pos[tournament(t2)]
    c1, c2 = sbx_crossover(pa, pb, lb, ub, eta_c, p_cross, draws=sbx_draws)
    children = torch.cat([c1, c2], dim=0)[:n]
    children = polynomial_mutation(children, lb, ub, eta_m, p_mut,
                                   draws=mut_draws)
    child_fit = objective(children)

    # k-elitism: the best n_elite parents replace the worst children.
    elite = top_k(-state.fit, n_elite)
    worst = top_k(child_fit, n_elite)
    pos = children.index_copy(0, worst, state.pos[elite])
    fit = child_fit.index_copy(0, worst, state.fit[elite])
    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return GAState(pos=pos, fit=fit, best_pos=best_pos, best_fit=best_fit,
                   gen=state.gen, iteration=state.iteration + 1)


def ga_run(
    state: GAState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    eta_c: float = ETA_C,
    eta_m: float = ETA_M,
    p_cross: float = P_CROSS,
    p_mut: Optional[float] = None,
    n_elite: int = N_ELITE,
    draws: Optional[Sequence[GADraws]] = None,
) -> GAState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = ga_step(state, objective, half_width, eta_c, eta_m, p_cross,
                        p_mut, n_elite,
                        draws=None if draws is None else draws[i])
    return state


def ga_state_from_numpy(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike = None, seed: int = 0) -> GAState:
    """A GAState from numpy arrays named like its fields."""
    return _family.state_from_numpy(GAState, arrays, device, seed)


def ga_state_to_numpy(state: GAState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
