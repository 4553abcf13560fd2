"""Hashgrid separation off the plan's cell sort, overflow rescue included.

Replaces the TPU kernel ``ops/pallas/grid_separation.py:
separation_hashgrid_pallas`` of the JAX package (its two ``pallas_call``
sites, the whole-row and the lane-tiled slot-plane sweep, and the LOCAL
overflow rescue that function runs after them), the kernel path of
``separation_mode="hashgrid"`` with ``hashgrid_kernel="slots"``.

The torus ``[-hw, hw)^2`` is tiled by a ``g x g`` cell grid.  Each cell's
first ``K`` live agents (in the plan's sort order) are in the grid; the
rest are capped out, and the first ``overflow_budget`` of those in sort
order are rescued.  For each in-grid or rescued agent ``p`` the sweep
returns

    f_p = sum_q near * k_sep * rsqrt(max(d2, eps^2))^3 * (p_p - p_q)
    near = d2 < personal_space^2, q != p in the (2R+1)^2 stencil cells

over the in-grid agents ``q`` and then over the rescued ones, with the
select-form minimum image on both axes, ``R`` the stencil radius in cells
(1, or 2 for half cells).  Dead and unrescued capped-out agents get zero
and are seen by no one.  That is the JAX function's result: its slot
planes hold the in-grid agents, and its rescue pairs each rescued agent
with its stencil's slots and with the other rescued agents, applying each
reaction to the in-grid partner.  Rescued pairs are taken over the
stencil here, where JAX takes them over all rescued pairs: the stencil
covers the personal space (plus the plan's skin), so every near pair is
in it, as the in-grid sweep already assumes.

- :func:`sweep_operands` gathers the kernel's operands off the plan: the
  CURRENT positions in sort order (so a stale skinned plan stays exact),
  each cell's run in the sort (a searchsorted of the sorted keys) and the
  capped-out agents before each cell (a cumsum);
- :func:`grid_sweep_cuda` launches the hand-written CUDA kernel
  ``csrc/grid_separation.cu`` on CUDA tensors and raises on anything else;
- :func:`grid_sweep_plain` is the same function in plain PyTorch, its
  terms summed one after another in the kernel's order;
- :func:`separation_hashgrid` is the tick's entry (the plain version on a
  CPU tensor, the kernel on a CUDA tensor).  Nothing falls back, and
  nothing reads the device: with no agent capped out, the rescue costs the
  kernel one comparison a stencil cell, as ``lax.cond`` skips it in JAX.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import hashgrid_plan as _hp
from .._numerics import fma, wrap_select
from . import _build

# Launches of the CUDA kernel since the count was last set to 0.  Only
# grid_sweep_cuda adds to it, once per launch; a launch while the stream
# captures a CUDA graph adds to _captured instead, and each replay of a
# captured rollout adds what its capture recorded.
LAUNCHES = 0
_captured = 0

# The envelope on this card (hashgrid_supported), that of the JAX
# package's slot planes: g*g*K slots indexable in int32.
MAX_SLOTS = 1 << 28

_fn = None   # the C entry, bound at the first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("grid_separation").dsa_grid_sweep_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _stencil_radius(cell_eff: float, personal_space: float) -> int:
    """R in cells the sweep must reach so the stencil covers the
    separation radius: 1 for full cells, 2 for half cells."""
    if cell_eff >= personal_space:
        return 1
    if 2.0 * cell_eff >= personal_space:
        return 2
    raise ValueError(
        f"grid cell ({cell_eff}) must be >= personal_space/2 "
        f"({personal_space / 2}) so the 5x5 stencil covers the "
        "separation radius (>= personal_space gives the cheaper 3x3)"
    )


def _geometry(torus_hw: float, cell: float):
    """(g, cell_eff): ``floor(2hw/cell)`` rounded down to a multiple of 16,
    the JAX kernel's grid (and so the plan grid of the slots path)."""
    g = (int(2.0 * torus_hw / cell) // 16) * 16
    if g < 16:
        raise ValueError(
            f"torus [-{torus_hw}, {torus_hw}) tiled by cell {cell} gives "
            "fewer than 16 aligned grid rows; use the portable "
            "separation_grid (or dense) for such small worlds"
        )
    return g, 2.0 * torus_hw / g


def hashgrid_supported(dim, dtype, torus_hw, cell, max_per_cell,
                       personal_space=None) -> bool:
    """Whether the configuration is inside the CUDA kernel's envelope: 2-D
    float32, a grid of at least 16 cells a side in multiples of 16, cells
    at least ``personal_space / 2`` (R <= 2), ``max_per_cell >= 1`` and at
    most ``MAX_SLOTS`` slots.  The kernel keeps one receiver in registers
    per thread and reads the stencil's runs through the cache, so neither
    shared memory nor K bounds it; the TPU kernel's VMEM model (K a
    multiple of 8 in [8, 64], the row budget, the lane-tiled R = 2 gate)
    does not apply."""
    if dim != 2 or dtype != torch.float32:
        return False
    g = (int(2.0 * torus_hw / cell) // 16) * 16
    if g < 16 or max_per_cell < 1 or g * g * max_per_cell > MAX_SLOTS:
        return False
    ps = cell if personal_space is None else personal_space
    return 2.0 * (2.0 * torus_hw / g) >= ps


def hashgrid_backend_choice(backend, dim, dtype, torus_hw, cell,
                            max_per_cell, personal_space, knob,
                            on_cuda) -> bool:
    """The dispatch predicate: "portable" never takes the kernel path,
    "pallas" always (raising outside the envelope; on a CPU tensor the
    kernel path is the plain version, as JAX's interpret mode), "auto" on
    CUDA inside the envelope.  Static in the config and the device."""
    if backend not in ("auto", "pallas", "portable"):
        raise ValueError(
            f"unknown {knob} {backend!r}; "
            "expected 'auto', 'pallas', or 'portable'"
        )
    if backend == "portable":
        return False
    supported = hashgrid_supported(dim, dtype, torus_hw, cell, max_per_cell,
                                   personal_space=personal_space)
    if backend == "pallas" and not supported:
        raise ValueError(
            f"{knob}='pallas' but this configuration is outside the "
            "kernel's envelope (needs 2-D f32, >= 16 grid cells across the "
            "world after rounding down to a multiple of 16, cell >= "
            f"personal_space/2, max_per_cell >= 1 and <= {MAX_SLOTS} slots)"
        )
    return supported and (backend == "pallas" or on_cuda)


class SweepOperands(NamedTuple):
    """The sweep's operands off a plan (:func:`sweep_operands`)."""

    spos: torch.Tensor        # [N, 2] f32 current positions in sort order
    skey: torch.Tensor        # [N] i32 sorted cell keys, g*g when dead
    rank: torch.Tensor        # [N] i32 rank within the cell
    order: torch.Tensor       # [N] i32 sorted index -> agent
    bounds: torch.Tensor      # [g*g + 1] i32 first sorted index of a cell
    ovf_before: torch.Tensor  # [g*g] i32 capped-out agents before a cell


def sweep_operands(pos: torch.Tensor, plan) -> SweepOperands:
    """The operands of the sweep at ``pos`` (read through ``plan.order``,
    not the plan's snapshot): a gather, a searchsorted and the overflow's
    exclusive cumsum, a few small operations on the device, no scatter and
    no wait."""
    g2 = plan.g * plan.g
    cells = torch.arange(g2 + 1, dtype=torch.int32, device=pos.device)
    bounds = torch.searchsorted(plan.skey, cells, out_int32=True)
    over = (bounds[1:] - bounds[:-1] - plan.max_per_cell).clamp(min=0)
    ovf_before = torch.cumsum(over, 0, dtype=torch.int32) - over
    return SweepOperands(
        pos.index_select(0, plan.order).to(torch.float32), plan.skey,
        plan.rank, plan.order, bounds, ovf_before)


def _check_operands(ops: SweepOperands, g: int):
    n = ops.spos.shape[0]
    if ops.spos.dtype != torch.float32 or ops.spos.shape != (n, 2):
        raise TypeError("grid_sweep: spos must be [N, 2] float32")
    for name in ("skey", "rank", "order"):
        t = getattr(ops, name)
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"grid_sweep: {name} must be [{n}] int32")
    for name, size in (("bounds", g * g + 1), ("ovf_before", g * g)):
        t = getattr(ops, name)
        if t.dtype != torch.int32 or t.shape != (size,):
            raise ValueError(f"grid_sweep: {name} must be [{size}] int32")
    if any(t.device != ops.spos.device for t in ops):
        raise ValueError("grid_sweep: tensors lie on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("grid_sweep takes contiguous tensors")


def grid_sweep_cuda(ops: SweepOperands, g, k, r, budget, k_sep,
                    personal_space, eps, hw):
    """Launch the CUDA kernel on ``ops`` (contiguous on one CUDA device):
    the force [N, 2] in agent order, zero for the dead and the unrescued,
    without waiting."""
    global LAUNCHES, _captured
    if ops.spos.device.type != "cuda":
        raise ValueError(
            f"grid_sweep_cuda needs CUDA tensors, got {ops.spos.device}")
    if r not in (1, 2) or g < 2 * r + 1 or k < 1 or budget < 0:
        raise ValueError(f"grid_sweep_cuda: stencil radius {r}, K = {k}, "
                         f"budget {budget} on g = {g}")
    _check_operands(ops, g)
    n = ops.spos.shape[0]
    out = torch.empty_like(ops.spos)
    if n == 0:
        return out
    dev = ops.spos.device
    err = _kernel()(
        ops.spos.data_ptr(), ops.skey.data_ptr(), ops.rank.data_ptr(),
        ops.order.data_ptr(), ops.bounds.data_ptr(),
        ops.ovf_before.data_ptr(), out.data_ptr(), n, g, k, r, budget,
        float(k_sep), float(personal_space) ** 2, float(eps) ** 2,
        float(hw), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"grid sweep kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        LAUNCHES += 1
    return out


def _receivers(ops: SweepOperands, g, k, budget):
    """(in_grid, rescued) [N] bool in sort order."""
    live = ops.skey < g * g
    cell = ops.skey.clamp(max=g * g - 1).long()
    in_grid = live & (ops.rank < k)
    rescued = (live & ~in_grid
               & (ops.ovf_before[cell] + ops.rank - k < budget))
    return in_grid, rescued


def _stencil_cells(cell: torch.Tensor, g: int, r: int) -> torch.Tensor:
    """[M, (2R+1)^2] int64: the stencil cells around each of ``cell``
    (int64 keys) in ascending key order, the kernel's order."""
    d = torch.arange(-r, r + 1, device=cell.device)
    cx = torch.div(cell, g, rounding_mode="floor")
    rows = torch.remainder(cx[:, None] + d, g).sort(1).values
    cols = torch.remainder((cell - cx * g)[:, None] + d, g).sort(1).values
    return (rows[:, :, None] * g + cols[:, None, :]).reshape(cell.shape[0],
                                                            -1)


def _pair_terms(dx, dy, near, k_sep, personal_space, eps):
    """(tx, ty): ``k * rsqrt(max(d2, eps^2))^3 * d`` where ``near`` and
    the cut hold, else +0; d2 rounded as the kernel (and XLA) rounds it."""
    d2 = fma(dx, dx, dy * dy)
    near = near & (d2 < float(personal_space) ** 2)
    inv = torch.rsqrt(d2.clamp(min=float(eps) ** 2))
    scale = k_sep * inv * inv * inv
    return (torch.where(near, scale * dx, 0.0),
            torch.where(near, scale * dy, 0.0))


def _sweep_terms(ops: SweepOperands, g, k, r, k_sep, personal_space, eps,
                 hw, receivers):
    """(tx, ty) [M, (2R+1)^2 K]: pass 1, each receiver's terms from the K
    slots of its stencil cells in the kernel's order (ascending cell key,
    then rank), +0 where a slot is empty or the receiver itself."""
    skey = ops.skey[receivers].long()
    nb_cells = _stencil_cells(skey, g, r)                        # [M, C]
    lo = ops.bounds[nb_cells]
    cnt = (ops.bounds[nb_cells + 1] - lo).clamp(max=k)
    slot = torch.arange(k, device=skey.device)
    q = (lo[..., None] + slot).reshape(skey.shape[0], -1)        # [M, S]
    valid = ((slot < cnt[..., None]).reshape(q.shape)
             & (q != receivers[:, None]))
    other = ops.spos[q.clamp(max=ops.spos.shape[0] - 1)]
    me = ops.spos[receivers]
    dx = wrap_select(me[:, 0:1] - other[..., 0], hw)
    dy = wrap_select(me[:, 1:2] - other[..., 1], hw)
    return _pair_terms(dx, dy, valid, k_sep, personal_space, eps)


def _overflow_rescue_local(ops: SweepOperands, g, k, r, budget, k_sep,
                           personal_space, eps, hw, receivers, in_grid):
    """Pass 2, as the kernel gathers it: ``(rows, valid, tx, ty)``, where
    ``rows`` [M2] are the receivers (indices into ``receivers``) with a
    rescued agent in a stencil cell, and ``valid``, ``tx``, ``ty`` [M2, L]
    their rescued partners' terms in the kernel's order: the stencil cells
    in ascending key order, each cell's rescued run (ranks K and up, within
    the budget) in sort order, padded with +0 and the receiver itself
    skipped.  A rescued receiver's term is computed from its own end (the
    rescued-vs-rescued pairs); an in-grid receiver's is the negated term
    on the rescued partner (the reaction JAX scatters onto the partner's
    slot: the select-form wrap is not odd at exactly +-hw).  With nothing
    rescued near a receiver it has no row, so nothing costs more than its
    pairs and a table of the stencil's runs."""
    cells = _stencil_cells(ops.skey[receivers].long(), g, r)     # [M, C]
    first = ops.bounds[cells] + k
    runs = torch.minimum(ops.bounds[cells + 1] - first,
                         budget - ops.ovf_before[cells]).clamp(min=0)
    total = runs.sum(1)
    rows = torch.nonzero(total > 0).flatten()
    width = int(total.max()) if rows.numel() else 0
    first, runs, p = first[rows], runs[rows], receivers[rows]
    ends = torch.cumsum(runs, 1)                                 # [M2, C]
    j = torch.arange(width, device=p.device).expand(rows.shape[0], width)
    t = torch.searchsorted(ends, j.contiguous(), right=True).clamp(
        max=cells.shape[1] - 1)
    v = first.gather(1, t) + j - (ends - runs).gather(1, t)
    valid = (j < total[rows][:, None]) & (v != p[:, None])
    me = ops.spos[p][:, None, :]
    other = ops.spos[torch.where(valid, v, p[:, None])]
    ig = in_grid[p][:, None]
    # wrap(v - p) for an in-grid receiver, wrap(p - v) for a rescued one.
    d = torch.where(ig[..., None], other - me, me - other)
    tx, ty = _pair_terms(wrap_select(d[..., 0], hw),
                         wrap_select(d[..., 1], hw), valid, k_sep,
                         personal_space, eps)
    sign = torch.where(ig, -1.0, 1.0)
    return rows, valid, sign * tx, sign * ty


def _sequential_sum(t: torch.Tensor, acc=None) -> torch.Tensor:
    """Row sums of ``t`` [M, C] taken one column after another, onto
    ``acc`` [M] (or +0)."""
    if acc is None:
        acc = torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    for j in range(t.shape[1]):
        acc = acc + t[:, j]
    return acc


def grid_sweep_plain(ops: SweepOperands, g, k, r, budget, k_sep,
                     personal_space, eps, hw, absolute=False):
    """The kernel's function in plain PyTorch, on any device: the force
    [N, 2] in agent order, each receiver's pass-1 terms and then its
    pass-2 terms summed one after another, as the kernel sums them.  With
    ``absolute``, ``sum |term|`` per agent and axis instead (the scale of
    the band the kernel is held to)."""
    in_grid, rescued = _receivers(ops, g, k, budget)
    receivers = torch.nonzero(in_grid | rescued).flatten()
    t1 = _sweep_terms(ops, g, k, r, k_sep, personal_space, eps, hw,
                      receivers)
    rows, _, *t2 = _overflow_rescue_local(ops, g, k, r, budget, k_sep,
                                          personal_space, eps, hw, receivers,
                                          in_grid)
    f = []
    for a, b in zip(t1, t2):
        if absolute:
            a, b = a.abs(), b.abs()
        acc = _sequential_sum(a)
        acc[rows] = _sequential_sum(b, acc[rows])
        f.append(acc)
    out = torch.zeros_like(ops.spos)
    out[ops.order[receivers].long()] = torch.stack(f, 1)
    return out


def grid_sweep(ops: SweepOperands, g, k, r, budget, k_sep, personal_space,
               eps, hw):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    fn = grid_sweep_plain if ops.spos.device.type == "cpu" else grid_sweep_cuda
    return fn(ops, g, k, r, budget, k_sep, personal_space, eps, hw)


def separation_hashgrid(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    cell: float,
    max_per_cell: int,
    torus_hw: float,
    overflow_budget: int = 512,
    plan=None,
) -> torch.Tensor:
    """The hashgrid separation force of the slots path, [N, 2].

    ``cell`` is the (skin-inflated) cell the plan grid derives from;
    ``plan`` a shared plan of the same ``(g, max_per_cell, torus_hw)``
    built on ``alive`` (as every tick's plan is), or ``None`` to build
    one.  The stencil radius covers ``personal_space + plan.skin``."""
    n, d = pos.shape
    if d != 2:
        raise ValueError("hash-grid separation kernel is 2-D only")
    k = max_per_cell
    g, cell_eff = _geometry(torus_hw, cell)
    r = _stencil_radius(cell_eff,
                        personal_space + (plan.skin if plan is not None
                                          else 0.0))
    if plan is None:
        plan = _hp.build_hashgrid_plan(pos, alive.bool(), torus_hw,
                                       2.0 * torus_hw / g, k, g=g)
    elif (plan.g != g or plan.max_per_cell != k
          or float(plan.torus_hw) != float(torus_hw)):
        raise ValueError(
            f"shared plan geometry (g={plan.g}, K={plan.max_per_cell}, "
            f"hw={plan.torus_hw}) does not match this call (g={g}, K={k}, "
            f"hw={torus_hw})"
        )
    force = grid_sweep(sweep_operands(pos, plan), g, k, r,
                       max(int(overflow_budget), 0), k_sep, personal_space,
                       eps, torus_hw)
    return force.to(pos.dtype)


def hashgrid_overflow(pos, cell, max_per_cell, torus_hw, alive=None):
    """Number of live agents past the per-cell slot cap (they receive
    force only from the rescue), as a device scalar."""
    if alive is None:
        alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    g, _ = _geometry(torus_hw, cell)
    plan = _hp.build_hashgrid_plan(pos, alive, torus_hw, 2.0 * torus_hw / g,
                                   max_per_cell, g=g)
    return (~plan.ok & alive.bool()[plan.order.long()]).sum()
