"""The shared spatial index of the hashgrid tick: the counterpart of
``ops/hashgrid_plan.py`` of the JAX package, whose module doc tells its
story (one build per tick, Verlet reuse, the partial refresh, the
plan-native operands).

:class:`HashgridPlan` holds what every hashgrid force term reads:

- the per-agent cell assignment (``cx``, ``cy``, ``key``) from
  ``ops/neighbors.torus_cell_xy``, dead agents keyed past the grid
  (``key == g*g``);
- the stable cell sort (``order``, ``skey``, ``rank``, ``ok``, ``sx``,
  ``sy``);
- the live-only CSR occupancy (``counts``, ``starts``) for the portable
  3x3 stencil;
- the stencil-union candidate table ``cand [g*g, W]`` and the receiver
  table ``recv [g*g, RK]`` (the candidate kernel's operands), each with
  its overflow count;
- the Verlet snapshot ``ref_pos`` / ``ref_alive`` and the counters
  ``age``, ``rebuilds``, ``cells_rebuilt``, ``cap_overflow``.

Every field has the JAX plan's name, shape and dtype (int32 indices and
counters, bool flags, f32 positions), so a plan crosses between the two
packages through numpy (:func:`plan_to_numpy` / :func:`plan_from_numpy`)
and the tests compare them field for field.

Where JAX decides under ``lax.cond`` / ``lax.switch`` on a device scalar,
the port decides on the host in an eager tick: :func:`refresh_plan` and
:func:`refresh_plan_partial` read one value from the device per call.
:func:`refresh_plan_on_device` keeps the decision on the device for a
tick captured in a CUDA graph: it always takes the cheap tier (keep, or
the partial refresh, whose result with no trigger equals keep field for
field) and returns whether the tick needed a full rebuild instead, so
the caller reads one flag per chunk of ticks and reruns a chunk that
needed one.  A plan built every tick (``hashgrid_skin == 0``) never
waits.  The occupancy (``counts``, ``starts``) comes from a searchsorted
of the sorted keys, not a scatter-add.

The moments field's binning rides the plan when the field's fine grid is
the plan's (``field_sep_cell``): ``fkey``/``xt``/``yt`` follow
``grid_moments.fine_cell_keys`` (positions wrapped onto the torus first),
the separation keys ``torus_cell_xy`` (clipped); the two agree for every
agent inside ``[-hw, hw)``.  :func:`plan_cell_sums` sums per-agent rows
over the plan's own cell sort (the ``field_deposit="sorted"`` deposit).

Not ported: the ``tiebreak`` sort key of the spatially-sharded tick
(ROADMAP Queue A item 16).  It raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike, resolve_device
from ._numerics import sq_norm2, torus_wrap
from .grid_moments import (
    commensurate_geometry,
    fine_cell_keys,
    sorted_cell_sums,
)
from .neighbors import torus_cell_xy

I32 = torch.int32

_ITEM_16 = ("is not ported yet (ROADMAP Queue A item 16: "
            "parallel/spatial.py, the spatially-sharded tick)")


def plan_geometry(torus_hw: float, cell: float) -> Tuple[int, float]:
    """(g, cell_eff) of the plan grid tiling ``[-hw, hw)^2``:
    ``floor(2hw/cell)`` rounded down to a multiple of 16 where that leaves
    at least 16 cells, else ``floor(2hw/cell)``."""
    g16 = (int(2.0 * torus_hw / cell) // 16) * 16
    if g16 >= 16:
        return g16, 2.0 * torus_hw / g16
    g = max(1, int(2.0 * torus_hw / cell))
    return g, 2.0 * torus_hw / g


@dataclass
class HashgridPlan:
    """The spatial index of one hashgrid tick (module doc).  Optional
    tables are ``None`` when not built."""

    # geometry (the JAX plan's static aux data)
    g: int
    cell_eff: float
    torus_hw: float
    max_per_cell: int
    # the binning and the sort
    cx: torch.Tensor              # [N] i32
    cy: torch.Tensor              # [N] i32
    key: torch.Tensor             # [N] i32, g*g for dead agents
    order: torch.Tensor           # [N] i32 sorted slot -> agent
    skey: torch.Tensor            # [N] i32
    rank: torch.Tensor            # [N] i32 rank within the cell
    ok: torch.Tensor              # [N] bool in-grid (rank < K, live)
    sx: torch.Tensor              # [N] f32 snapshot x in sort order
    sy: torch.Tensor              # [N] f32
    counts: Optional[torch.Tensor] = None      # [g*g] i32 live occupancy
    starts: Optional[torch.Tensor] = None      # [g*g] i32
    fkey: Optional[torch.Tensor] = None        # [N] i32 field keys, g*g dead
    xt: Optional[torch.Tensor] = None          # [N] f32 fine-cell-local x
    yt: Optional[torch.Tensor] = None
    ref_pos: Optional[torch.Tensor] = None     # [N, 2] build snapshot
    ref_alive: Optional[torch.Tensor] = None   # [N] bool
    age: Optional[torch.Tensor] = None         # i32 scalar
    rebuilds: Optional[torch.Tensor] = None    # i32 scalar
    cells_rebuilt: Optional[torch.Tensor] = None   # i32 scalar
    cand: Optional[torch.Tensor] = None        # [g*g, W] i32, padded n
    cand_overflow: Optional[torch.Tensor] = None   # i32 scalar
    cap_overflow: Optional[torch.Tensor] = None    # i32 scalar
    recv: Optional[torch.Tensor] = None        # [g*g, RK] i32, padded n
    recv_overflow: Optional[torch.Tensor] = None   # i32 scalar
    skin: float = 0.0
    field_sep_cell: Optional[float] = None
    field_align_cell: Optional[float] = None

    ARRAY_FIELDS = (
        "cx", "cy", "key", "order", "skey", "rank", "ok", "sx", "sy",
        "counts", "starts", "fkey", "xt", "yt",
        "ref_pos", "ref_alive", "age", "rebuilds", "cells_rebuilt",
        "cand", "cand_overflow", "cap_overflow",
        "recv", "recv_overflow",
    )
    AUX_FIELDS = (
        "g", "cell_eff", "torus_hw", "max_per_cell",
        "skin", "field_sep_cell", "field_align_cell",
    )

    @property
    def has_csr(self) -> bool:
        return self.counts is not None

    @property
    def has_field(self) -> bool:
        return self.fkey is not None

    @property
    def has_list(self) -> bool:
        return self.cand is not None

    @property
    def has_recv(self) -> bool:
        return self.recv is not None

    def replace(self, **kw) -> "HashgridPlan":
        """A copy with the named array fields replaced (the geometry is
        the plan's identity: a different geometry is a new build)."""
        bad = set(kw) - set(self.ARRAY_FIELDS)
        if bad:
            raise ValueError(f"not array fields of a plan: {sorted(bad)}")
        return dataclasses.replace(self, **kw)


def plan_to_numpy(plan: HashgridPlan) -> dict:
    """The plan as a dict: each built array field as numpy, each aux
    field as its Python value (the inverse of :func:`plan_from_numpy`)."""
    out = {f: getattr(plan, f) for f in HashgridPlan.AUX_FIELDS}
    for f in HashgridPlan.ARRAY_FIELDS:
        v = getattr(plan, f)
        if v is not None:
            out[f] = v.cpu().numpy()
    return out


def plan_from_numpy(arrays: Mapping, device: DeviceLike = None
                    ) -> HashgridPlan:
    """A plan from a dict named like the fields (a JAX plan's array
    fields as numpy plus its aux values); missing array fields are
    ``None``.  Dtypes are kept as given."""
    dev = resolve_device(device)
    kw = {f: arrays[f] for f in HashgridPlan.AUX_FIELDS if f in arrays}
    for f in ("g", "cell_eff", "torus_hw", "max_per_cell"):
        if f not in kw:
            raise ValueError(f"plan_from_numpy: missing aux field {f!r}")
    for f in HashgridPlan.ARRAY_FIELDS:
        v = arrays.get(f)
        kw[f] = (None if v is None
                 else torch.from_numpy(np.array(v, copy=True)).to(dev))
    return HashgridPlan(**kw)


def build_hashgrid_plan(
    pos: torch.Tensor,
    alive: torch.Tensor,
    torus_hw: float,
    cell: float,
    max_per_cell: int,
    need_csr: bool = False,
    field_sep_cell: Optional[float] = None,
    field_align_cell: Optional[float] = None,
    g: Optional[int] = None,
    skin: float = 0.0,
    neighbor_cap: int = 0,
    recv_cap: int = 0,
    tiebreak: Optional[torch.Tensor] = None,
) -> HashgridPlan:
    """Build the shared plan: one binning and one stable cell sort.

    ``g`` given: that grid (``cell_eff = 2hw/g``); else
    :func:`plan_geometry` on ``cell + skin``.  ``need_csr``: also the CSR
    occupancy (built anyway with a candidate or receiver table).
    ``neighbor_cap`` (W > 0): the stencil-union candidate table, each
    cell's run truncated at ``max_per_cell``, rows past W truncated and
    counted in ``cand_overflow``; needs ``g >= 3``.  ``recv_cap`` (RK >
    0): the receiver table, each cell's own live agents in sort order
    (not truncated at ``max_per_cell``), rows past RK counted in
    ``recv_overflow``.  ``field_sep_cell`` (and ``field_align_cell``):
    also bin the swarm onto the moments field's fine grid, which must be
    the plan's (else this raises: the plan carries one binning).  Nothing
    here waits for the device."""
    if tiebreak is not None:
        raise NotImplementedError(f"build_hashgrid_plan(tiebreak=) "
                                  f"{_ITEM_16}")
    n = pos.shape[0]
    if g is None:
        g, cell_eff = plan_geometry(torus_hw, cell + skin)
    else:
        cell_eff = 2.0 * torus_hw / g
    g2 = g * g
    alive = alive.bool()
    cx, cy = torus_cell_xy(pos, torus_hw, g)
    key = torch.where(alive, cx * g + cy, g2)
    order, skey, rank, ok, sx, sy, cap_overflow = _sorted_view(
        key, pos, g2, max_per_cell)

    counts = starts = None
    if need_csr or neighbor_cap > 0 or recv_cap > 0:
        counts, starts = _sorted_occupancy(skey, g2)

    cand = cand_overflow = None
    if neighbor_cap > 0:
        if g < 3:
            raise ValueError(
                f"the stencil-union candidate table needs g >= 3 (got "
                f"{g}): a smaller wrapped stencil visits the same cell "
                "twice and would double-count pairs"
            )
        cells = torch.arange(g2, dtype=I32, device=pos.device)
        cand, lo = _union_rows(cells, order, counts, starts, g,
                               max_per_cell, neighbor_cap, n)
        cand_overflow = (lo - neighbor_cap).clamp(min=0).sum().to(I32)

    recv = recv_overflow = None
    if recv_cap > 0:
        cells = torch.arange(g2, dtype=I32, device=pos.device)
        recv = _receiver_rows(cells, order, counts, starts, recv_cap, n)
        recv_overflow = (counts - recv_cap).clamp(min=0).sum().to(I32)

    fkey = xt = yt = None
    if field_sep_cell is not None:
        g_fine = commensurate_geometry(torus_hw, field_sep_cell,
                                       field_align_cell)[0]
        if g_fine != g:
            raise ValueError(
                f"moments-field fine grid (g_fine={g_fine}, from "
                f"sep_cell={field_sep_cell}) does not coincide with "
                f"the plan grid (g={g}, from cell={cell}); the shared "
                "plan only carries ONE binning — bin the field "
                "separately (pass field_sep_cell=None) for split "
                "geometries"
            )
        fkey, xt, yt = fine_cell_keys(pos, alive, torus_hw, g_fine)

    zero = torch.zeros((), dtype=I32, device=pos.device)
    return HashgridPlan(
        g=g, cell_eff=cell_eff, torus_hw=torus_hw,
        max_per_cell=max_per_cell, skin=float(skin),
        field_sep_cell=field_sep_cell, field_align_cell=field_align_cell,
        cx=cx, cy=cy, key=key, order=order, skey=skey, rank=rank, ok=ok,
        sx=sx, sy=sy, counts=counts, starts=starts, fkey=fkey, xt=xt, yt=yt,
        ref_pos=pos, ref_alive=alive, age=zero, rebuilds=zero,
        cells_rebuilt=zero, cand=cand, cand_overflow=cand_overflow,
        cap_overflow=cap_overflow, recv=recv, recv_overflow=recv_overflow,
    )


def _sorted_view(key, ref, g2, max_per_cell):
    """(order, skey, rank, ok, sx, sy, cap_overflow) of a stable sort by
    ``key`` (ties in agent order, as JAX's sort with an iota key)."""
    n = key.shape[0]
    skey, order = torch.sort(key, stable=True)
    iota = torch.arange(n, dtype=I32, device=key.device)
    prev = torch.cat([skey[:1] - 1, skey[:-1]])
    run_start = torch.where(skey != prev, iota, 0)
    rank = iota - torch.cummax(run_start, 0).values
    live = skey < g2
    ok = (rank < max_per_cell) & live
    cap_overflow = (live & (rank >= max_per_cell)).sum().to(I32)
    sx, sy = ref[order, 0], ref[order, 1]
    return order.to(I32), skey, rank, ok, sx, sy, cap_overflow


def _sorted_occupancy(skey, g2):
    """(counts, starts) [g2] i32 of the live cells off the sorted keys:
    each cell's run in the sort, found by a searchsorted (the same values
    as a scatter-add of ones and its exclusive cumsum, without atomics)."""
    cells = torch.arange(g2 + 1, dtype=I32, device=skey.device)
    bounds = torch.searchsorted(skey, cells, out_int32=True)
    return bounds[1:] - bounds[:-1], bounds[:-1]


def _stencil_keys(cells, g):
    """The 3x3 stencil's cell keys around each of ``cells``, in scan
    order (dx, then dy, each -1, 0, 1; wrapping), as int64."""
    ccx = torch.div(cells, g, rounding_mode="floor")
    ccy = cells - ccx * g
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            yield (torch.remainder(ccx + dx, g) * g
                   + torch.remainder(ccy + dy, g)).long()


def _union_lengths(cells, counts, g, max_per_cell):
    """[C] i32: each of ``cells``' stencil-union length before the W
    truncation (the nine runs, each truncated at ``max_per_cell``)."""
    lo = torch.zeros_like(cells)
    for nkey in _stencil_keys(cells, g):
        lo = lo + counts[nkey].clamp(max=max_per_cell)
    return lo


def _union_rows(cells, order, counts, starts, g, max_per_cell, w, n):
    """(rows [C, W] i32, lo [C] i32): the stencil-union candidate rows of
    ``cells`` — each its 3x3 neighborhood's runs in stencil scan order,
    each run truncated at ``max_per_cell``, padded with ``n`` — and each
    row's untruncated length.  Nine interval selects and one gather."""
    wiota = torch.arange(w, dtype=I32, device=cells.device)[None, :]
    src = torch.full((cells.shape[0], w), n, dtype=I32, device=cells.device)
    lo = torch.zeros_like(cells)
    for nkey in _stencil_keys(cells, g):
        hi = lo + counts[nkey].clamp(max=max_per_cell)
        m = (wiota >= lo[:, None]) & (wiota < hi[:, None])
        src = torch.where(m, starts[nkey][:, None] + (wiota - lo[:, None]),
                          src)
        lo = hi
    rows = torch.where(src < n, order[src.clamp(max=n - 1).long()], n)
    return rows, lo


def _receiver_rows(cells, order, counts, starts, rk, n):
    """[C, RK] i32: each of ``cells``' own occupancy run in sort order,
    padded with ``n``."""
    riota = torch.arange(rk, dtype=I32, device=cells.device)[None, :]
    c = cells.long()
    m = riota < counts[c].clamp(max=rk)[:, None]
    src = starts[c][:, None] + riota
    return torch.where(m, order[src.clamp(max=order.shape[0] - 1).long()],
                       n)


def _displacement2(pos: torch.Tensor, plan: HashgridPlan) -> torch.Tensor:
    """[N] squared minimum-image displacement from ``plan.ref_pos``, in
    the JAX package's rounding (mod-form wrap, ``fma(dy, dy, dx*dx)``):
    the Verlet trigger compares it with ``skin^2 / 4``, so an ulp off
    would flip a rebuild."""
    d = torus_wrap(pos - plan.ref_pos, plan.torus_hw)
    return sq_norm2(d[:, 0], d[:, 1])


def plan_staleness(pos: torch.Tensor, alive: torch.Tensor,
                   plan: HashgridPlan):
    """(d2max, alive_changed) as device scalars: the largest squared
    displacement from the snapshot, and whether the alive set changed."""
    return (_displacement2(pos, plan).max(),
            (alive.bool() != plan.ref_alive).any())


def _rebuild(pos, alive, plan):
    p = build_hashgrid_plan(
        pos, alive, plan.torus_hw, plan.cell_eff, plan.max_per_cell,
        need_csr=plan.has_csr, g=plan.g, skin=plan.skin,
        field_sep_cell=plan.field_sep_cell,
        field_align_cell=plan.field_align_cell,
        neighbor_cap=plan.cand.shape[1] if plan.has_list else 0,
        recv_cap=plan.recv.shape[1] if plan.has_recv else 0,
    )
    return p.replace(rebuilds=plan.rebuilds + 1,
                     cells_rebuilt=plan.cells_rebuilt + plan.g * plan.g)


def _stale(pos, alive, plan, rebuild_every):
    """Whether :func:`refresh_plan` rebuilds, as a device scalar."""
    d2max, alive_changed = plan_staleness(pos, alive, plan)
    skin = plan.skin
    stale = alive_changed | (4.0 * d2max > skin * skin)
    if rebuild_every > 0:
        stale = stale | (plan.age + 1 >= rebuild_every)
    return stale


def refresh_plan(
    pos: torch.Tensor,
    alive: torch.Tensor,
    plan: HashgridPlan,
    rebuild_every: int = 0,
) -> HashgridPlan:
    """The Verlet trigger: rebuild when some agent moved more than
    ``skin/2`` from the snapshot (``4 d2max > skin^2``), the alive set
    changed, or (``rebuild_every > 0``) the plan is ``rebuild_every - 1``
    ticks old; else keep it with ``age + 1``.  One read from the device
    decides."""
    if bool(_stale(pos, alive, plan, rebuild_every)):
        return _rebuild(pos, alive, plan)
    return plan.replace(age=plan.age + 1)


def _partial_capable(plan: HashgridPlan, n: int) -> bool:
    g2 = plan.g * plan.g
    return (plan.has_list and plan.skin > 0.0 and not plan.has_field
            and n * (g2 + 1) < 2**31)


class _Tiers(NamedTuple):
    """The partial refresh's trigger, as device tensors."""

    full_needed: torch.Tensor     # bool scalar: the full tier
    trigger: torch.Tensor         # bool scalar: some agent violated
    viol: torch.Tensor            # [N] bool, moved past skin/2
    crossed: torch.Tensor         # [N] bool, violated and changed cell
    ccx: torch.Tensor             # [N] i32 current cells
    ccy: torch.Tensor
    key_cur: torch.Tensor         # [N] i32 current keys
    refresh: torch.Tensor         # [g*g] bool rows to recompute
    n_rows: torch.Tensor          # i32 scalar


def _partial_tiers(pos, alive, plan, rebuild_every, crosser_cap):
    g = plan.g
    g2 = g * g
    skin = plan.skin
    viol = 4.0 * _displacement2(pos, plan) > skin * skin
    ccx, ccy = torus_cell_xy(pos, plan.torus_hw, g)
    key_cur = torch.where(alive, ccx * g + ccy, g2)
    crossed = viol & (key_cur != plan.key)
    n_cross = crossed.sum()
    # Trigger cells (old and new homes of crossers), 3x3-dilated to the
    # rows whose stencil union they can appear in.
    # (index_fill_ with a scalar: an indexed assignment of True would copy
    # a host scalar to the card and wait for it.)
    trig = torch.zeros(g2 + 1, dtype=torch.bool, device=pos.device)
    trig.index_fill_(0, torch.where(crossed, plan.key, g2).long(), True)
    trig.index_fill_(0, torch.where(crossed, key_cur, g2).long(), True)
    tg = trig[:g2].reshape(g, g)
    dil = tg.clone()
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                dil |= torch.roll(tg, (dx, dy), (0, 1))
    refresh = dil.reshape(-1)
    n_rows = refresh.sum().to(I32)
    full_needed = (alive != plan.ref_alive).any()
    if rebuild_every > 0:
        full_needed = full_needed | (plan.age + 1 >= rebuild_every)
    trigger = viol.any()
    ccap = min(int(crosser_cap), pos.shape[0])
    full_needed = full_needed | (trigger & ((n_cross > ccap)
                                            | (n_rows > max(1, g2 // 4))))
    return _Tiers(full_needed, trigger, viol, crossed, ccx, ccy, key_cur,
                  refresh, n_rows)


def _partial_plan(pos, plan, t: _Tiers):
    """The partial tier off the trigger ``t``.  With no trigger it equals
    the kept plan (``age + 1``) field for field: the sort, the occupancy
    and the tables recomputed from the same keys and snapshot, the padded
    rows landing on row ``g*g - 1`` with that row's own content."""
    n = pos.shape[0]
    g = plan.g
    g2 = g * g
    K = plan.max_per_cell
    dev = pos.device
    row_cap = max(1, g2 // 4)
    new_ref = torch.where(t.viol[:, None], pos, plan.ref_pos)
    key_new = torch.where(t.crossed, t.key_cur, plan.key)
    order, skey, rank, ok, sx, sy, cap_overflow = _sorted_view(
        key_new, new_ref, g2, K)
    counts, starts = _sorted_occupancy(skey, g2)

    # The refreshed rows, compacted into a fixed block of row_cap (ranks
    # are monotone, so searchsorted inverts the cumsum); padding is g*g.
    rranks = torch.cumsum(t.refresh, 0, dtype=I32)
    rows = torch.searchsorted(
        rranks, torch.arange(1, row_cap + 1, dtype=I32, device=dev))
    rvalid = rows < g2
    rc = rows.clamp(max=g2 - 1).to(I32)
    w = plan.cand.shape[1]
    rows_cand, lo = _union_rows(rc, order, counts, starts, g, K, w, n)
    cand = plan.cand.clone()
    cand[rc.long()] = rows_cand
    # cand_overflow changes only inside the refreshed rows: swap their old
    # excess for the new.
    lo_old = _union_lengths(rc, plan.counts, g, K)
    ex_old = torch.where(rvalid, (lo_old - w).clamp(min=0), 0)
    ex_new = torch.where(rvalid, (lo - w).clamp(min=0), 0)
    cand_overflow = (plan.cand_overflow + ex_new.sum()
                     - ex_old.sum()).to(I32)
    extra = {}
    if plan.has_recv:
        rk = plan.recv.shape[1]
        recv = plan.recv.clone()
        recv[rc.long()] = _receiver_rows(rc, order, counts, starts, rk, n)
        extra["recv"] = recv
        extra["recv_overflow"] = (counts - rk).clamp(min=0).sum().to(I32)
    return plan.replace(
        cx=torch.where(t.crossed, t.ccx, plan.cx),
        cy=torch.where(t.crossed, t.ccy, plan.cy),
        key=key_new, order=order, skey=skey, rank=rank, ok=ok, sx=sx,
        sy=sy, counts=counts, starts=starts, cand=cand,
        cand_overflow=cand_overflow, cap_overflow=cap_overflow,
        ref_pos=new_ref, age=plan.age + 1,
        cells_rebuilt=plan.cells_rebuilt + t.n_rows, **extra,
    )


def refresh_plan_partial(
    pos: torch.Tensor,
    alive: torch.Tensor,
    plan: HashgridPlan,
    rebuild_every: int = 0,
    crosser_cap: int = 512,
) -> HashgridPlan:
    """The locality-aware trigger, with per-agent anchors (the JAX
    package's ``refresh_plan_partial`` documents the soundness argument).
    Three tiers, chosen by one read from the device:

    - keep: no agent moved more than ``skin/2`` from its anchor; age + 1.
    - partial: violators re-anchor at their current position; those that
      crossed a cell line move in the sort order, and only the candidate
      (and receiver) rows whose 3x3 stencil touches a crosser's old or
      new cell are recomputed.  The plan equals a fresh build at the
      mixed reference ``where(violated, pos, ref_pos)``, with ``age + 1``
      and ``cells_rebuilt`` raised by the rows recomputed.
    - full: the alive set changed, the ``rebuild_every`` ceiling hit, or
      a trigger with more than ``crosser_cap`` crossers or more than
      ``g*g // 4`` rows to recompute.

    The JAX package merges the crossers into the sort order with a few
    ``searchsorted`` passes; here one stable sort by the new keys gives
    the same order (by key, ties by agent), a sort of N keys being cheap
    on the card.  The rows are recomputed in a fixed ``[g*g // 4, W]``
    block as in JAX, padded rows landing on row ``g*g - 1`` with that
    row's own fresh content.  Plans without a candidate table or skin
    fall back to :func:`refresh_plan`."""
    if not _partial_capable(plan, pos.shape[0]):
        return refresh_plan(pos, alive, plan, rebuild_every)
    alive = alive.bool()
    t = _partial_tiers(pos, alive, plan, rebuild_every, crosser_cap)
    full, partial = torch.stack([t.full_needed, t.trigger]).tolist()
    if full:
        return _rebuild(pos, alive, plan)
    if not partial:
        return plan.replace(age=plan.age + 1)
    return _partial_plan(pos, plan, t)


def refresh_plan_on_device(
    pos: torch.Tensor,
    alive: torch.Tensor,
    plan: HashgridPlan,
    rebuild_every: int = 0,
    crosser_cap: int = 512,
    partial: bool = True,
) -> Tuple[HashgridPlan, torch.Tensor]:
    """``(plan', full_needed)`` with no read from the device, for a tick
    captured in a CUDA graph.  ``plan'`` is the cheap tier the eager
    refresh takes whenever ``full_needed`` is false: with ``partial`` (and
    a plan the partial refresh takes), :func:`refresh_plan_partial`'s
    keep or partial tier, both as the partial refresh (with no trigger it
    equals keep field for field); else :func:`refresh_plan`'s keep.
    ``full_needed`` (a bool device scalar) says that the eager refresh
    would have rebuilt the plan instead, and then ``plan'`` is not its
    result."""
    alive = alive.bool()
    if partial and _partial_capable(plan, pos.shape[0]):
        t = _partial_tiers(pos, alive, plan, rebuild_every, crosser_cap)
        return _partial_plan(pos, plan, t), t.full_needed
    return (plan.replace(age=plan.age + 1),
            _stale(pos, alive, plan, rebuild_every))


def plan_field_keys(plan: HashgridPlan):
    """The ``keys=(key, x~, y~)`` triple the moments field takes, or
    ``None`` when the plan was built without the field binning."""
    if plan.fkey is None:
        return None
    return plan.fkey, plan.xt, plan.yt


def plan_cell_sums(plan: HashgridPlan, vals: torch.Tensor) -> torch.Tensor:
    """[g*g, C] per-cell sums of the per-agent ``vals`` [N, C] over the
    plan's existing cell sort (its separation cells: clipped binning, dead
    agents dropped), each cell's run summed by
    ``grid_moments.sorted_cell_sums``: a fixed order, no scatter.  For the
    moments deposit these are the field's cells for every agent inside
    the torus (the hashgrid caller's contract)."""
    svals = vals.index_select(0, plan.order.long())
    return sorted_cell_sums(plan.skey, svals, plan.g * plan.g)
