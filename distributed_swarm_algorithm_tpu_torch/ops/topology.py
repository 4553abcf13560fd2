"""Swarm neighborhood topologies (social networks) for lbest PSO.

Counterpart of ``ops/topology.py`` of the JAX package.  A neighborhood
best over a static topology is a min-dilation: the min over a few
``torch.roll`` shifts of the fitness vector.  Ties go to the first shift,
as ``jnp.argmin`` over the stacked shifts gives.

Each function returns ``(nbest_pos [N, D], nbest_fit [N])``: the
per-particle best over its neighborhood *including itself* (so lbest is
monotone).
"""

from __future__ import annotations

from typing import Tuple

import torch

TOPOLOGIES = ("gbest", "ring", "vonneumann")


def _select_min(
    fits: torch.Tensor, poss: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce a stacked [K, N] fitness / [K, N, D] position set over K."""
    idx = torch.argmin(fits, dim=0)                      # [N]
    ar = torch.arange(fits.shape[1], device=fits.device)
    return poss[idx, ar], fits[idx, ar]


def ring_best(
    pbest_fit: torch.Tensor,
    pbest_pos: torch.Tensor,
    radius: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """lbest over a ring: particle i sees i-radius ... i+radius (mod N).

    ``2*radius + 1`` rolls; radius=1 is the classic lbest ring.
    """
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    shifts = range(-radius, radius + 1)
    fits = torch.stack([torch.roll(pbest_fit, s, 0) for s in shifts])
    poss = torch.stack([torch.roll(pbest_pos, s, 0) for s in shifts])
    return _select_min(fits, poss)


def von_neumann_best(
    pbest_fit: torch.Tensor,
    pbest_pos: torch.Tensor,
    cols: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """lbest over a torus grid: self + N/S/E/W neighbors.

    Particles are arranged row-major on a ``(N // cols, cols)`` torus;
    N must divide evenly.
    """
    n = pbest_fit.shape[0]
    if cols < 1 or n % cols:
        raise ValueError(f"cols={cols} must divide swarm size {n}")
    rows = n // cols
    fit2 = pbest_fit.reshape(rows, cols)
    pos2 = pbest_pos.reshape(rows, cols, -1)
    stacks_f, stacks_p = [fit2], [pos2]
    for axis in (0, 1):
        for s in (-1, 1):
            stacks_f.append(torch.roll(fit2, s, axis))
            stacks_p.append(torch.roll(pos2, s, axis))
    fits = torch.stack([f.reshape(n) for f in stacks_f])
    poss = torch.stack([p.reshape(n, -1) for p in stacks_p])
    return _select_min(fits, poss)


def neighbor_best(
    pbest_fit: torch.Tensor,
    pbest_pos: torch.Tensor,
    topology: str,
    radius: int = 1,
    cols: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-particle social attractor for the given topology.

    ``gbest`` broadcasts the single global argmin; ``ring`` and
    ``vonneumann`` are local.
    """
    if topology == "gbest":
        best = torch.argmin(pbest_fit)
        n = pbest_fit.shape[0]
        return (
            pbest_pos[best].expand(pbest_pos.shape),
            pbest_fit[best].expand(n),
        )
    if topology == "ring":
        return ring_best(pbest_fit, pbest_pos, radius)
    if topology == "vonneumann":
        c = cols if cols else _default_cols(pbest_fit.shape[0])
        return von_neumann_best(pbest_fit, pbest_pos, c)
    raise ValueError(
        f"unknown topology {topology!r}; available: {TOPOLOGIES}"
    )


def _default_cols(n: int) -> int:
    """Most-square factorization of n (largest divisor <= sqrt(n))."""
    c = int(n ** 0.5)
    while c > 1 and n % c:
        c -= 1
    return max(c, 1)
