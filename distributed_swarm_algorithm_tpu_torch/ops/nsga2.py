"""The variation operators of NSGA-II (Deb et al. 2002) in plain PyTorch.

Counterpart of the part of ``ops/nsga2.py`` of the JAX package that the
genetic algorithm (``ops/ga.py``) reuses: the distribution indices, the
crossover probability, simulated binary crossover and polynomial mutation.
Each operator takes its draws as an argument or draws them from a
generator.  The rest of NSGA-II (non-dominated sorting, crowding, the
multi-objective state and step) is still to port: ROADMAP Queue A item
19.5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._numerics import rdiv

ETA_C = 15.0   # SBX crossover distribution index
ETA_M = 20.0   # polynomial-mutation distribution index
P_CROSS = 0.9  # per-pair crossover probability


def _rand(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def sbx_crossover(
    parents_a: torch.Tensor,
    parents_b: torch.Tensor,
    lb: float,
    ub: float,
    eta_c: float,
    p_cross: float,
    gen: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated binary crossover, batched over [K, D] parent pairs.
    ``draws = (u [K, D], do [K, 1])`` are the uniforms of the spread factor
    and of the per-pair crossover test; without them they come from
    ``gen``."""
    if draws is None:
        draws = (_rand(gen, parents_a.shape, parents_a),
                 _rand(gen, (parents_a.shape[0], 1), parents_a))
    u, u_do = draws
    inv = 1.0 / (eta_c + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** inv,
                       rdiv(1.0, 2.0 * (1.0 - u)) ** inv)
    c1 = 0.5 * ((1 + beta) * parents_a + (1 - beta) * parents_b)
    c2 = 0.5 * ((1 - beta) * parents_a + (1 + beta) * parents_b)
    do = u_do < p_cross
    c1 = torch.where(do, c1, parents_a)
    c2 = torch.where(do, c2, parents_b)
    return torch.clamp(c1, lb, ub), torch.clamp(c2, lb, ub)


def polynomial_mutation(
    pos: torch.Tensor,
    lb: float,
    ub: float,
    eta_m: float,
    p_mut: float,
    gen: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Polynomial mutation, batched over [K, D].  ``draws = (u, do)``, both
    [K, D]: the perturbation's uniforms and the per-gene mutation test's;
    without them they come from ``gen``."""
    if draws is None:
        draws = (_rand(gen, pos.shape, pos), _rand(gen, pos.shape, pos))
    u, u_do = draws
    inv = 1.0 / (eta_m + 1.0)
    delta = torch.where(u < 0.5, (2.0 * u) ** inv - 1.0,
                        1.0 - (2.0 * (1.0 - u)) ** inv)
    out = pos + torch.where(u_do < p_mut, delta * (ub - lb),
                            torch.zeros_like(delta))
    return torch.clamp(out, lb, ub)
