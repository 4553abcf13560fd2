"""Cuckoo search (Yang & Deb 2009) in plain PyTorch.

Counterpart of ``ops/cuckoo.py`` of the JAX package: the portable path, on
any device, for any callable objective.  The fused path for named
objectives is ``ops/cuda/cuckoo_fused.py``.

One generation:
  1. Levy flight per nest:  x' = x + step_scale * levy * (x - best);
     egg i lands in a random nest t(i) and replaces it if f(x'_i) < f(x_t):
     among eggs that land in one nest the best wins, ties to the lowest
     cuckoo row;
  2. abandonment: each nest is abandoned with probability ``pa`` and
     rebuilt by a biased random walk x + u * (x_p1 - x_p2) over two
     permutations of the nests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family

# Canonical defaults (Yang & Deb 2009).
PA = 0.25           # abandonment probability
STEP_SCALE = 0.01   # Levy step scale (fraction of domain dynamics)
LEVY_BETA = 1.5     # Levy exponent


@dataclass
class CuckooState(_family.FamilyState):
    """Struct-of-tensors nest population. N nests, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


CUCKOO_TENSOR_FIELDS = _family.tensor_fields(CuckooState)

# One generation's draws: the Levy flight's two standard normal planes
# (u, v) [N, D], the egg targets [N] in [0, N), the abandonment uniforms
# [N], the two peer permutations p1, p2 [N] and the walk uniforms [N, D].
CuckooDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor, torch.Tensor, torch.Tensor]


def mantegna_sigma(beta: float) -> float:
    """sigma_u of Mantegna's Levy generator (closed form, in Python
    doubles; a kernel casts it to f32 at use)."""
    num = math.gamma(1.0 + beta) * math.sin(math.pi * beta / 2.0)
    den = (math.gamma((1.0 + beta) / 2.0) * beta
           * 2.0 ** ((beta - 1.0) / 2.0))
    return (num / den) ** (1.0 / beta)


def levy_steps(gen: torch.Generator, shape, beta: float, dtype, device,
               normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Levy(beta) steps ``sigma u / |v|^(1/beta)`` by Mantegna's algorithm,
    ``u`` and ``v`` standard normals (``normals`` replaces the draws from
    ``gen``)."""
    if normals is None:
        normals = tuple(torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device) for _ in range(2))
    u, v = normals
    return (mantegna_sigma(beta) * u) / torch.pow(torch.abs(v) + 1e-12,
                                                  1.0 / beta)


def cuckoo_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> CuckooState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return CuckooState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def cuckoo_draws(state: CuckooState) -> CuckooDraws:
    """One generation's draws from ``state.gen``."""
    n, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen
    normal = lambda: torch.randn((n, d), generator=gen, dtype=dt,  # noqa
                                 device=dev)
    perm = lambda: torch.randperm(n, generator=gen, device=dev)  # noqa
    return (normal(), normal(),
            torch.randint(0, n, (n,), generator=gen, device=dev),
            torch.rand((n,), generator=gen, dtype=dt, device=dev),
            perm(), perm(),
            torch.rand((n, d), generator=gen, dtype=dt, device=dev))


def egg_drop(cand: torch.Tensor, cand_fit: torch.Tensor,
             target: torch.Tensor, fit: torch.Tensor):
    """``(accept [N], egg [N, D], seg_best [N])``: per nest, the best egg
    that lands there (a segment minimum, ties to the lowest cuckoo row),
    accepted where strictly better than the nest; an untargeted nest sees
    +inf and rejects."""
    n = cand_fit.shape[0]
    target = target.long()
    seg_best = torch.full_like(cand_fit, float("inf")).scatter_reduce(
        0, target, cand_fit, "amin")
    rows = torch.arange(n, device=cand_fit.device)
    is_winner = cand_fit == seg_best[target]
    winner_row = torch.full_like(rows, n).scatter_reduce(
        0, target, torch.where(is_winner, rows, torch.full_like(rows, n)),
        "amin")
    accept = seg_best < fit
    return accept, cand[torch.clamp(winner_row, 0, n - 1)], seg_best


def cuckoo_step(
    state: CuckooState,
    objective: Callable,
    half_width: float = 5.12,
    pa: float = PA,
    step_scale: float = STEP_SCALE,
    levy_beta: float = LEVY_BETA,
    draws: Optional[CuckooDraws] = None,
) -> CuckooState:
    """One generation, with no read from the device: Levy flights into
    random nests, then abandonment.  ``draws`` replaces the draws from
    ``state.gen`` (see ``CuckooDraws``)."""
    n, d = state.pos.shape
    n_u, n_v, target, u_ab, p1, p2, u_walk = (
        cuckoo_draws(state) if draws is None else draws)

    # --- 1. Levy flights; egg i lands in nest target[i] ------------------
    levy = levy_steps(state.gen, (n, d), levy_beta, state.pos.dtype,
                      state.device, normals=(n_u, n_v))
    cand = state.pos + step_scale * levy * (state.pos - state.best_pos)
    cand = torch.clamp(cand, -half_width, half_width)
    accept, egg, seg_best = egg_drop(cand, objective(cand), target,
                                     state.fit)
    pos = torch.where(accept[:, None], egg, state.pos)
    fit = torch.where(accept, seg_best, state.fit)

    # --- 2. Abandon a fraction pa, rebuild by biased random walk ---------
    abandon = u_ab < pa
    walk = u_walk * (pos[p1.long()] - pos[p2.long()])
    fresh = torch.clamp(pos + walk, -half_width, half_width)
    fresh_fit = objective(fresh)
    pos = torch.where(abandon[:, None], fresh, pos)
    fit = torch.where(abandon, fresh_fit, fit)

    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return CuckooState(pos=pos, fit=fit, best_pos=best_pos,
                       best_fit=best_fit, gen=state.gen,
                       iteration=state.iteration + 1)


def cuckoo_run(
    state: CuckooState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    pa: float = PA,
    step_scale: float = STEP_SCALE,
    levy_beta: float = LEVY_BETA,
    draws: Optional[Sequence[CuckooDraws]] = None,
) -> CuckooState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = cuckoo_step(state, objective, half_width, pa, step_scale,
                            levy_beta,
                            draws=None if draws is None else draws[i])
    return state


def cuckoo_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike = None, seed: int = 0
                            ) -> CuckooState:
    """A CuckooState from numpy arrays named like its fields."""
    return _family.state_from_numpy(CuckooState, arrays, device, seed)


def cuckoo_state_to_numpy(state: CuckooState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
