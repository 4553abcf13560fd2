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

- ``separation_grid``: the spatial hash (separation mode "grid"), each
  agent gathering a ``max_per_cell`` window of each of its 9 surrounding
  cells; with ``torus_hw`` the grid tiles the torus ``[-hw, hw)^2`` and
  displacements wrap.
- ``torus_cell_xy`` / ``torus_cell_tables``: the one binning formula of
  the torus grid, shared by the hashgrid plan and every consumer.
- ``separation_grid_plan``: the portable hashgrid sweep off a shared
  ``HashgridPlan`` (``ops/hashgrid_plan.py``): the 3x3 stencil over the
  plan's CSR tables, or the union sweep over its candidate table.

Every norm is clamped at ``eps``, so co-located agents get a finite force.
The grid sweeps round their distances as the JAX package does on the CPU
(``_numerics.sq_norm2``), so both take the same cuts at the personal space.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ._numerics import norm, rdiv, sq_norm2, torus_wrap, wrap_select

_HALF = 1 << 15   # cell coordinates are offset by this into [0, 0xFFFF]
_GRID_BASE = 1 << 16   # "grid" mode's packed key: cx * base + cy (int32)


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


def _floor_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``floor(x / d)`` cast to int32, by a true division (a CUDA division
    by a Python scalar may multiply by the reciprocal).  The float is
    bounded first, which changes no in-range value and keeps the cast
    defined; XLA's cast saturates there."""
    q = torch.floor(x / torch.full_like(x, d))
    return q.clamp(-2.0**31, 2.0**31 - 128).to(torch.int32)


def torus_cell_xy(pos: torch.Tensor, torus_hw: float, g: int):
    """(cx, cy) int32: per-agent cell coordinates on the ``g x g`` grid
    tiling the torus ``[-hw, hw)^2``, clipped to the grid."""
    cell_eff = 2.0 * torus_hw / g
    cx = _floor_div(pos[:, 0] + torus_hw, cell_eff).clamp(0, g - 1)
    cy = _floor_div(pos[:, 1] + torus_hw, cell_eff).clamp(0, g - 1)
    return cx, cy


def cell_counts(key: torch.Tensor, n_cells: int) -> torch.Tensor:
    """[n_cells] int32 occupancy of ``key`` (int32, in [0, n_cells]);
    keys equal to ``n_cells`` are dropped.  One scatter, no wait for the
    device."""
    counts = torch.zeros(n_cells + 1, dtype=torch.int32, device=key.device)
    counts.scatter_add_(0, key.long(), torch.ones_like(key))
    return counts[:n_cells]


def exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0, dtype=torch.int32) - counts


def torus_cell_tables(pos: torch.Tensor, torus_hw: float, g: int):
    """(cx, cy, key, counts, starts): cell coordinates, row-major key and
    the CSR occupancy tables over the ``g * g`` cells, all int32."""
    cx, cy = torus_cell_xy(pos, torus_hw, g)
    key = cx * g + cy
    counts = cell_counts(key, g * g)
    return cx, cy, key, counts, exclusive_cumsum(counts)


def _stencil_terms(pos, alive, k_sep, personal_space, eps, npos, near,
                   wrap):
    """Force of one 3x3-stencil gather, [N, 2]: ``mag * diff / d`` over
    the ``near`` partners ``npos`` [N, K, 2], in the JAX package's
    rounding (norm, clamp, ``k / d^2``, divide by ``d``)."""
    diff = wrap(pos[:, None, :] - npos)
    dist = torch.sqrt(sq_norm2(diff[..., 0], diff[..., 1]))
    dist_c = dist.clamp(min=eps)
    near = near & alive[:, None] & (dist < personal_space)
    mag = rdiv(k_sep, dist_c * dist_c)
    unit = diff / dist_c[..., None]
    return torch.where(near[..., None], mag[..., None] * unit, 0.0).sum(1)


def separation_grid(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    cell: float,
    max_per_cell: int,
    torus_hw: Optional[float] = None,
) -> torch.Tensor:
    """Spatial-hash separation force, [N, D]; other dimensions than 2 get
    ``separation_dense``.

    Agents are stably sorted by cell key; each gathers a ``max_per_cell``
    window from each of its 9 surrounding cells.  Cells holding more agents
    are truncated per gather (the first ``max_per_cell`` in sort order).
    Without ``torus_hw`` the key packs ``cx * 65536 + cy`` in int32 (it
    wraps, as in the JAX package, and still names each cell once) and the
    windows start at ``searchsorted``; with it, the ``g x g`` grid tiles
    the torus, the stencil and displacements wrap, and the windows start
    at the CSR table."""
    n, d = pos.shape
    if d != 2:
        return separation_dense(pos, alive, k_sep, personal_space, eps)
    if cell < personal_space:
        raise ValueError(
            f"grid cell ({cell}) must be >= personal_space "
            f"({personal_space}) for the 3x3 stencil to cover the "
            "separation radius"
        )
    alive = alive.bool()
    if torus_hw is not None:
        g = max(1, int(2.0 * torus_hw / cell))
        if g < 3:
            raise ValueError(
                f"torus [-{torus_hw}, {torus_hw}) tiled by cell {cell} "
                f"gives a {g}-cell grid; the wrapping 3x3 stencil needs "
                "g >= 3 (use dense separation for such tiny worlds)"
            )
        cx, cy, keys, _, cell_starts = torus_cell_tables(pos, torus_hw, g)

        def neighbor_key(dx, dy):
            return torch.remainder(cx + dx, g) * g + torch.remainder(cy + dy,
                                                                     g)

        def wrap(diff):
            return torus_wrap(diff, torus_hw)
    else:
        cx = _floor_div(pos[:, 0], cell) + _HALF
        cy = _floor_div(pos[:, 1], cell) + _HALF
        keys = cx * _GRID_BASE + cy

        def neighbor_key(dx, dy):
            return (cx + dx) * _GRID_BASE + (cy + dy)

        def wrap(diff):
            return diff

    skeys, order = torch.sort(keys, stable=True)
    spos = pos[order]
    salive = alive[order]
    window = torch.arange(max_per_cell, device=pos.device)
    me = torch.arange(n, device=pos.device)
    force = torch.zeros_like(pos)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nkey = neighbor_key(dx, dy)
            if torus_hw is not None:
                start = cell_starts[nkey.long()]
            else:
                start = torch.searchsorted(skeys, nkey)
            idx = start[:, None] + window[None, :]              # [N, K]
            idx_c = idx.clamp(max=n - 1)
            in_cell = (idx < n) & (skeys[idx_c] == nkey[:, None])
            near = in_cell & salive[idx_c] & (order[idx_c] != me[:, None])
            force = force + _stencil_terms(
                pos, alive, k_sep, personal_space, eps, spos[idx_c], near,
                wrap,
            )
    return force


def separation_grid_plan(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    plan,
) -> torch.Tensor:
    """Torus spatial-hash separation force off a shared ``HashgridPlan``,
    [N, 2]: the portable hashgrid path.

    The plan may be stale within its Verlet window, so partners' positions
    are the CURRENT ``pos`` read through ``plan.order``, and the distance
    test is at the true ``personal_space``.  With the candidate table
    (``plan.has_list``) each agent sweeps its own cell's row
    (:func:`separation_union_sweep`); else the 3x3 stencil over the CSR
    tables, where a slot counts when ``slot < counts[cell]`` (live agents
    only: dead ones are keyed past the grid) and each stencil cell is
    truncated at ``plan.max_per_cell``."""
    n = pos.shape[0]
    if plan.cell_eff < personal_space + plan.skin:
        raise ValueError(
            f"plan cell ({plan.cell_eff}) must be >= personal_space "
            f"+ skin ({personal_space} + {plan.skin}) for the 3x3 "
            "stencil (and its union candidate table) to cover the "
            "separation radius across the Verlet reuse window"
        )
    alive = alive.bool()
    if plan.has_list:
        return separation_union_sweep(pos, alive, k_sep, personal_space, eps,
                                      plan)
    if plan.counts is None:
        raise ValueError(
            "separation_grid_plan needs a plan built with need_csr=True "
            "or neighbor_cap > 0"
        )
    g = plan.g
    if g < 3:
        raise ValueError(
            f"torus tiled into a {g}-cell grid; the wrapping 3x3 stencil "
            "needs g >= 3 (use dense separation for such tiny worlds)"
        )
    hw = plan.torus_hw
    order = plan.order.long()
    spos = pos[order]
    counts, starts = plan.counts, plan.starts
    window = torch.arange(plan.max_per_cell, device=pos.device)
    me = torch.arange(n, device=pos.device)
    force = torch.zeros_like(pos)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nkey = (torch.remainder(plan.cx + dx, g) * g
                    + torch.remainder(plan.cy + dy, g)).long()
            occ = counts[nkey]
            idx = starts[nkey][:, None] + window[None, :]
            idx_c = idx.clamp(max=n - 1)
            near = (window[None, :] < occ[:, None]) & (
                order[idx_c] != me[:, None])
            force = force + _stencil_terms(
                pos, alive, k_sep, personal_space, eps, spos[idx_c], near,
                lambda diff: torus_wrap(diff, hw),
            )
    return force


def union_sweep_rows(
    pos: torch.Tensor,
    agents: torch.Tensor,
    rows: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    hw: float,
    absolute: bool = False,
    sequential: bool = False,
) -> torch.Tensor:
    """[M, 2]: the force on each of ``agents`` ([M] indices) from the
    candidates of its row ``rows`` ([M, W], padded with ``n``), at the
    CURRENT positions: select-form wrap, ``d = sqrt(dx^2 + dy^2)``,
    ``k / max(d, eps)^3 * diff`` over the candidates closer than
    ``personal_space`` other than the agent itself.  With ``absolute``,
    ``sum |term|`` instead; with ``sequential``, the terms are summed one
    column after another, in row order (the candidate kernel's order)."""
    n = pos.shape[0]
    valid = rows < n
    npos = pos[rows.clamp(max=n - 1).long()]                  # [M, W, 2]
    diff = wrap_select(pos[agents.long()][:, None, :] - npos, hw)
    dist = torch.sqrt(sq_norm2(diff[..., 0], diff[..., 1]))
    dist_c = dist.clamp(min=eps)
    near = valid & (dist < personal_space) & (rows != agents[:, None])
    scale = rdiv(k_sep, dist_c * dist_c * dist_c)
    term = scale[..., None] * diff
    if absolute:
        term = term.abs()
    term = torch.where(near[..., None], term, 0.0)
    if not sequential:
        return term.sum(1)
    force = torch.zeros_like(term[:, 0])
    for w in range(term.shape[1]):
        force = force + term[:, w]
    return force


def separation_union_sweep(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    plan,
) -> torch.Tensor:
    """The union sweep, [N, 2]: each agent reads its own cell's row of the
    plan's stencil-union candidate table, one ``[N, W]`` gather in place
    of the nine stencil gathers.  Dead agents (keyed past the grid) read
    row ``g*g - 1`` and are masked."""
    n = pos.shape[0]
    g2 = plan.g * plan.g
    rows = plan.cand[plan.key.clamp(max=g2 - 1).long()]
    me = torch.arange(n, dtype=torch.int32, device=pos.device)
    force = union_sweep_rows(pos, me, rows, k_sep, personal_space, eps,
                             plan.torus_hw)
    return torch.where(alive.bool()[:, None], force, 0.0)


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
