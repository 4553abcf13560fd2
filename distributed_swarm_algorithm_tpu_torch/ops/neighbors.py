"""Neighbor separation, all pairs: the counterpart of ``separation_dense``
in ``ops/neighbors.py`` of the JAX package.

"Neighbors" are every other alive agent; agents beyond the personal space
contribute nothing, so all pairs is exact.  Every norm is clamped at
``eps``, so co-located agents get a finite force.  The ``[N, N, D]``
broadcast suits small swarms; ``ops/cuda/separation.py`` computes the
same force without pairwise intermediates.
"""

from __future__ import annotations

import torch

from ._numerics import norm, rdiv


def separation_dense(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
) -> torch.Tensor:
    """All-pairs separation force, [N, D]."""
    n = pos.shape[0]
    diff = pos[:, None, :] - pos[None, :, :]          # [N, N, D], i minus j
    dist = norm(diff)                                 # [N, N]
    dist_c = dist.clamp(min=eps)
    near = (
        alive[:, None]
        & alive[None, :]
        & ~torch.eye(n, dtype=torch.bool, device=pos.device)
        & (dist < personal_space)
    )
    mag = rdiv(k_sep, dist_c * dist_c)
    unit = diff / dist_c[..., None]
    force = torch.where(near[..., None], mag[..., None] * unit, 0.0)
    return force.sum(1)
