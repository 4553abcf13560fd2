"""Neighbor separation: the counterpart of ``ops/neighbors.py`` of the JAX
package.

- ``separation_dense``: all pairs by broadcast.  "Neighbors" are every
  other alive agent; agents beyond the personal space contribute nothing,
  so all pairs is exact.  The ``[N, N, D]`` broadcast suits small swarms;
  ``ops/cuda/separation.py`` computes the same force without pairwise
  intermediates.
- ``separation_window``: agents sorted by Morton key, each compared with
  its +-``window`` neighbours in that order.  Exact in precision (the
  distance test rejects every false pair), approximate in recall (a true
  neighbour further than ``window`` slots away in Z-order is missed).
  This is the plain version of the CUDA kernel in
  ``ops/cuda/window_separation.py``.

Every norm is clamped at ``eps``, so co-located agents get a finite force.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ._numerics import norm, rdiv

_HALF = 1 << 15   # cell coordinates are offset by this into [0, 0xFFFF]


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


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` (int64) into even bit positions."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_keys(pos: torch.Tensor, cell: float) -> torch.Tensor:
    """Morton (Z-order) key per 2-D position at ``cell`` resolution, [N].

    The JAX package's keys are uint32; these are the same values as int64
    (PyTorch's uint32 lacks shifts and sorts on many builds), so they sort
    in the same order.  The cell coordinate is ``floor(pos / cell)`` by a
    true division (a CUDA division by a Python scalar may multiply by the
    reciprocal instead), clipped to +-32768 cells after the integer cast:
    beyond that the world saturates at its boundary.  The float is bounded
    before the cast, which changes no key and keeps the cast defined.
    Subnormal positions and quotients count as zero, as XLA flushes them
    (a position of -1e-45 is in cell 0 there, not in cell -1).
    """
    tiny = torch.finfo(pos.dtype).tiny
    p = pos[:, :2]
    p = torch.where(p.abs() < tiny, 0.0, p)
    q = p / torch.full_like(p, cell)
    cells = torch.floor(torch.where(q.abs() < tiny, 0.0, q))
    c = cells.clamp(-2.0 * _HALF, 2.0 * _HALF).to(torch.int32) + _HALF
    c = c.clamp(0, 0xFFFF).to(torch.int64)
    return _part1by1(c[:, 0]) | (_part1by1(c[:, 1]) << 1)


def window_shifts(
    n: int, window: int, device: Optional[torch.device] = None
) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield ``(s, valid)`` per sliding-window shift, in the order +1, -1,
    +2, -2, ..., +-window: ``s`` is the signed roll amount and ``valid``
    ([n] bool) marks the rows whose partner ``i - s`` is a real slot, not
    one wrapped around the end of the array."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    for shift in range(1, window + 1):
        for sgn in (1, -1):
            s = sgn * shift
            src = idx - s
            yield s, (src >= 0) & (src < n)


def _window_sweep(spos, salive, k_sep, personal_space, eps, window,
                  rank=None, absolute=False):
    """The force of the +-``window`` roll sweep over sorted arrays.  With
    ``rank`` ([n] int), a pair counts only when its two ranks lie more
    than ``window`` apart (the second pass's de-duplication).  With
    ``absolute``, the sum of the terms' absolute values instead."""
    force = torch.zeros_like(spos)
    for s, not_wrapped in window_shifts(spos.shape[0], window, spos.device):
        npos = torch.roll(spos, s, 0)
        nalive = torch.roll(salive, s, 0)
        diff = spos - npos
        dist = norm(diff)
        dist_c = dist.clamp(min=eps)
        near = not_wrapped & salive & nalive & (dist < personal_space)
        if rank is not None:
            near = near & ((rank - torch.roll(rank, s, 0)).abs() > window)
        mag = rdiv(k_sep, dist_c * dist_c)
        term = mag[:, None] * diff / dist_c[:, None]
        force = force + torch.where(
            near[:, None], term.abs() if absolute else term, 0.0
        )
    return force


def separation_window(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    cell: float,
    window: int,
    presorted: bool = False,
    passes: int = 1,
    absolute: bool = False,
) -> torch.Tensor:
    """Morton-sorted sliding-window separation force, [N, D], on any
    device.  2-D only: other dimensions get ``separation_dense``.

    The agents are stably sorted by Morton key, each is compared with its
    +-``window`` neighbours in sorted order by ``torch.roll`` shifts, and
    the force is scattered back.  ``presorted=True`` promises the caller
    keeps the agent axis itself (approximately) Morton-sorted, so the
    first pass runs on the arrays as they are.  ``passes=2`` adds a second
    sweep under the ordering of a grid shifted by half a cell, counting
    only the pairs the first ordering could not have seen (ranks more
    than ``window`` apart), so no pair counts twice.

    ``absolute=True`` returns ``sum |term|`` per agent and axis instead of
    the force: two sums of the same f32 terms that differ by a few ulps
    each, or that are summed in another order, differ by a small multiple
    of it, so comparisons of this force are banded relative to it.
    """
    n, d = pos.shape
    if d != 2:
        return separation_dense(pos, alive, k_sep, personal_space, eps)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if passes not in (1, 2):
        raise ValueError(f"passes must be 1 or 2, got {passes}")
    alive = alive.bool()

    if presorted:
        force = _window_sweep(pos, alive, k_sep, personal_space, eps, window,
                              absolute=absolute)
    else:
        order = torch.sort(morton_keys(pos, cell), stable=True).indices
        force = torch.zeros_like(pos)
        force[order] = _window_sweep(
            pos[order], alive[order], k_sep, personal_space, eps, window,
            absolute=absolute,
        )

    if passes == 2:
        ids = torch.arange(n, dtype=torch.int32, device=pos.device)
        if presorted:
            rank1 = ids
        else:
            rank1 = torch.empty_like(ids)
            rank1[order] = ids
        order2 = torch.sort(
            morton_keys(pos + 0.5 * cell, cell), stable=True
        ).indices
        force2 = torch.zeros_like(pos)
        force2[order2] = _window_sweep(
            pos[order2], alive[order2], k_sep, personal_space, eps, window,
            rank=rank1[order2], absolute=absolute,
        )
        force = force + force2
    return force


def neighbor_counts_sampled(*args, **kwargs):
    """Not ported yet: the density probe behind ``suggest_window``."""
    raise NotImplementedError(
        "neighbor_counts_sampled is not ported yet (ROADMAP Queue A item "
        "6: the window sizing helpers)"
    )


def suggest_window(*args, **kwargs):
    """Not ported yet: sizes ``window_size`` from the measured density."""
    raise NotImplementedError(
        "suggest_window is not ported yet (ROADMAP Queue A item 6: the "
        "window sizing helpers)"
    )
