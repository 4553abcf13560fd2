"""Hashgrid separation over cell-slot planes.

Replaces the TPU kernel ``ops/pallas/grid_separation.py:
separation_hashgrid_pallas`` of the JAX package (its two ``pallas_call``
sites, the whole-row and the lane-tiled kernel), the kernel path of
``separation_mode="hashgrid"`` with ``hashgrid_kernel="slots"``.

The torus ``[-hw, hw)^2`` is tiled by a ``g x g`` cell grid and every cell
owns ``K`` slots.  Planes ``x``, ``y`` [g*g*K] hold the cell-sorted in-grid
agents (a cell's first ``K`` live agents in sort order); empty, dead and
capped-out slots hold the 1e18 sentinel, which fails every distance test.
For each in-grid slot ``i`` the sweep returns

    f_i = sum_j near * k_sep * rsqrt(max(d2, eps^2))^3 * (p_i - p_j)
    near = d2 < personal_space^2, j != i in the (2R+1)^2 stencil cells

with the select-form minimum image on both axes of the torus, ``R`` the
stencil radius in cells (1, or 2 for half cells).

- :func:`grid_sweep_cuda` launches the hand-written CUDA kernel
  ``csrc/grid_separation.cu`` on CUDA tensors and raises on anything else;
- :func:`grid_sweep_plain` is the same function in plain PyTorch;
- :func:`separation_hashgrid` is the tick's entry: it builds the sentinel
  planes from the plan (positions read CURRENT through ``plan.order``, so
  a stale skinned plan stays exact), runs the sweep (the plain version on
  a CPU tensor, the kernel on a CUDA tensor), the overflow rescue and the
  per-agent gather as PyTorch operations around it.  Nothing falls back.

Agents past rank ``K`` in their cell are dropped from the planes: they
exert no force through the sweep and receive theirs from the LOCAL rescue
pass (:func:`_overflow_rescue_local`, the JAX package's, as PyTorch
operations), which pairs each of up to ``overflow_budget`` of them with its
stencil's slots and with the other rescued agents, and applies the
reactions.  JAX runs the rescue under ``lax.cond`` on ``any(overflow)``;
here it always runs, which needs no read from the device: with no overflow
every term is a masked zero, so the force is the same.

Where the JAX kernel computes each pair once and applies the reaction
(rolls that save TPU shifts), the CUDA kernel gathers each receiver's
stencil and computes each pair from both ends: no atomics, no reaction
planes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import hashgrid_plan as _hp
from .._numerics import fma, wrap_select
from . import _build

# Launches of the CUDA kernel since the count was last set to 0.  Only
# grid_sweep_cuda adds to it, once per launch.
LAUNCHES = 0

SENTINEL = 1.0e18     # empty, dead and capped-out slot position
# The kernel's envelope on this card (hashgrid_supported): slot indices
# are int32 and the two planes stay under 2 GiB together.
MAX_SLOTS = 1 << 28

_fn = None   # the C entry, bound at the first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("grid_separation").dsa_grid_sweep_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
    per thread and reads the stencil's slots through the cache, so neither
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


def _check_sweep_args(x, y, slot, g, k):
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"grid_sweep: {name} must be float32")
        if t.shape != (g * g * k,):
            raise ValueError(f"grid_sweep: {name} must be [{g * g * k}]")
    if slot.dtype != torch.int32 or slot.ndim != 1:
        raise ValueError("grid_sweep: slot must be a 1-D int32 tensor")
    if y.device != x.device or slot.device != x.device:
        raise ValueError("grid_sweep: tensors lie on different devices")
    if not (x.is_contiguous() and y.is_contiguous() and slot.is_contiguous()):
        raise ValueError("grid_sweep takes contiguous tensors")


def grid_sweep_cuda(x, y, slot, g, k, r, k_sep, personal_space, eps, hw):
    """Launch the CUDA kernel: planes ``x``, ``y`` [g*g*K] f32 and
    ``slot`` [N] int32 (each in-grid agent's slot, ``g*g*K`` for the
    others), contiguous on one CUDA device.  Returns the force planes
    (fx, fy), zero outside the in-grid slots, without waiting."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"grid_sweep_cuda needs CUDA tensors, got {x.device}")
    if r not in (1, 2) or g < 2 * r + 1:
        raise ValueError(f"grid_sweep_cuda: stencil radius {r} on g = {g}")
    if g * g * k > MAX_SLOTS:
        raise ValueError(f"grid_sweep_cuda: {g * g * k} slots exceed "
                         f"{MAX_SLOTS}")
    _check_sweep_args(x, y, slot, g, k)
    fx, fy = torch.zeros_like(x), torch.zeros_like(y)
    n = slot.shape[0]
    if n == 0:
        return fx, fy
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        x.data_ptr(), y.data_ptr(), slot.data_ptr(), fx.data_ptr(),
        fy.data_ptr(), n, g, k, r, float(k_sep),
        float(personal_space) ** 2, float(eps) ** 2, float(hw),
        x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"grid sweep kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return fx, fy


def _sweep_terms(x, y, slot, g, k, r, k_sep, personal_space, eps, hw):
    """(receiver slots [M], tx [M, S], ty [M, S]): each in-grid receiver's
    terms from its (2R+1)^2 * K stencil slots, in the kernel's order
    (row offset, column offset, rank)."""
    rec = slot[slot < g * g * k].long()
    cell = torch.div(rec, k, rounding_mode="floor")
    cx = torch.div(cell, g, rounding_mode="floor")
    cy = cell - cx * g
    d = torch.arange(-r, r + 1, device=x.device)
    rows = torch.remainder(cx[:, None] + d[None, :], g)          # [M, w]
    cols = torch.remainder(cy[:, None] + d[None, :], g)
    base = (rows[:, :, None] * g + cols[:, None, :]) * k         # [M, w, w]
    nb = (base[..., None] + torch.arange(k, device=x.device)).reshape(
        rec.shape[0], -1)                                        # [M, S]
    dx = wrap_select(x[rec][:, None] - x[nb], hw)
    dy = wrap_select(y[rec][:, None] - y[nb], hw)
    # XLA rounds the TPU kernel's dx*dx + dy*dy as fma(dx, dx, dy*dy).
    d2 = fma(dx, dx, dy * dy)
    near = (d2 < float(personal_space) ** 2) & (nb != rec[:, None])
    inv = torch.rsqrt(d2.clamp(min=float(eps) ** 2))
    scale = k_sep * inv * inv * inv
    return (rec, torch.where(near, scale * dx, 0.0),
            torch.where(near, scale * dy, 0.0))


def grid_sweep_plain(x, y, slot, g, k, r, k_sep, personal_space, eps, hw,
                     absolute=False):
    """The kernel's function in plain PyTorch, on any device: the force
    planes (fx, fy).  With ``absolute``, ``sum |term|`` per slot and axis
    instead (the scale of the band the kernel is held to)."""
    rec, tx, ty = _sweep_terms(x, y, slot, g, k, r, k_sep, personal_space,
                               eps, hw)
    if absolute:
        tx, ty = tx.abs(), ty.abs()
    fx, fy = torch.zeros_like(x), torch.zeros_like(y)
    fx[rec] = tx.sum(1)
    fy[rec] = ty.sum(1)
    return fx, fy


def grid_sweep(x, y, slot, g, k, r, k_sep, personal_space, eps, hw):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return grid_sweep_plain(x, y, slot, g, k, r, k_sep, personal_space,
                                eps, hw)
    return grid_sweep_cuda(x, y, slot, g, k, r, k_sep, personal_space, eps,
                           hw)


def _overflow_rescue_local(pos, alive, cx, cy, order, ok, xr, yr, fx, fy,
                           k_sep, personal_space, eps, hw, budget, g, k, r):
    """(fx', fy', f_v): the JAX package's LOCAL rescue.  Each of the first
    ``budget`` capped-out live agents (in sort order) gathers its stencil's
    plane slots and pairs with the other rescued agents; ``f_v`` [N, 2] is
    the force on them, and the reactions on in-grid partners are added
    into the force planes.  Symmetric: each rescued pair gives both the
    force and the reaction."""
    n = pos.shape[0]
    dev = pos.device
    order = order.long()
    live_ovf = ~ok & alive[order]
    ovf_rank = torch.cumsum(live_ovf, 0) - 1
    v_slot = torch.where(live_ovf & (ovf_rank < budget), ovf_rank, budget)
    vidx = torch.full((budget + 1,), n, dtype=torch.int64, device=dev)
    vidx[v_slot] = order          # duplicates land on the dropped slot
    vidx = vidx[:budget]
    vvalid = vidx < n
    vi = vidx.clamp(max=n - 1)
    vpos = pos[vi]
    w = 2 * r + 1
    d = torch.arange(-r, r + 1, device=dev)
    rows = torch.remainder(cx[vi].long()[:, None] + d[None, :], g)
    cols = torch.remainder(cy[vi].long()[:, None] + d[None, :], g)
    nb = ((rows[:, :, None] * g + cols[:, None, :]) * k)[..., None] + (
        torch.arange(k, device=dev))
    nb = nb.reshape(budget, w * w * k)
    dx = wrap_select(vpos[:, 0:1] - xr[nb], hw)
    dy = wrap_select(vpos[:, 1:2] - yr[nb], hw)
    d2 = fma(dx, dx, dy * dy)
    near = vvalid[:, None] & (d2 < personal_space * personal_space)
    inv = torch.rsqrt(d2.clamp(min=eps * eps))
    scale = k_sep * inv * inv * inv
    cx_ = torch.where(near, scale * dx, 0.0)
    cy_ = torch.where(near, scale * dy, 0.0)
    # Reactions on the in-grid partners (sentinel slots get exact zeros).
    fx = fx.index_put((nb.reshape(-1),), -cx_.reshape(-1), accumulate=True)
    fy = fy.index_put((nb.reshape(-1),), -cy_.reshape(-1), accumulate=True)
    # Rescued against rescued: they are in no plane, so only here.
    dvx = wrap_select(vpos[:, 0][:, None] - vpos[:, 0][None, :], hw)
    dvy = wrap_select(vpos[:, 1][:, None] - vpos[:, 1][None, :], hw)
    dv2 = fma(dvx, dvx, dvy * dvy)
    nearv = (vvalid[:, None] & vvalid[None, :]
             & (dv2 < personal_space * personal_space)
             & ~torch.eye(budget, dtype=torch.bool, device=dev))
    invv = torch.rsqrt(dv2.clamp(min=eps * eps))
    sv = k_sep * invv * invv * invv
    f_vx = cx_.sum(1) + torch.where(nearv, sv * dvx, 0.0).sum(1)
    f_vy = cy_.sum(1) + torch.where(nearv, sv * dvy, 0.0).sum(1)
    f_v = torch.zeros_like(pos).index_put(
        (vi,), torch.where(vvalid[:, None], torch.stack([f_vx, f_vy], 1),
                           0.0), accumulate=True)
    return fx, fy, f_v


def slot_planes(pos: torch.Tensor, plan):
    """(x, y, slot): the sentinel-filled position planes [g*g*K] of the
    plan's in-grid agents at the CURRENT positions (read through
    ``plan.order``, not the plan's snapshot), and each sorted agent's slot
    [N] int32 (``g*g*K`` for the dead and capped-out)."""
    k = plan.max_per_cell
    n_slots = plan.g * plan.g * k
    slot = torch.where(plan.ok, plan.skey * k + plan.rank, n_slots)
    order = plan.order.long()

    def plane(v):
        # One scratch slot past the end takes the dead and capped-out.
        p = torch.full((n_slots + 1,), SENTINEL, dtype=torch.float32,
                       device=pos.device)
        p[slot.long()] = v.to(torch.float32)
        return p[:n_slots]

    return plane(pos[order, 0]), plane(pos[order, 1]), slot


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
    ``plan`` a shared plan of the same ``(g, max_per_cell, torus_hw)``, or
    ``None`` to build one.  The stencil radius covers ``personal_space +
    plan.skin``."""
    n, d = pos.shape
    if d != 2:
        raise ValueError("hash-grid separation kernel is 2-D only")
    k = max_per_cell
    g, cell_eff = _geometry(torus_hw, cell)
    r = _stencil_radius(cell_eff,
                        personal_space + (plan.skin if plan is not None
                                          else 0.0))
    alive = alive.bool()
    if plan is None:
        plan = _hp.build_hashgrid_plan(pos, alive, torus_hw,
                                       2.0 * torus_hw / g, k, g=g)
    elif (plan.g != g or plan.max_per_cell != k
          or float(plan.torus_hw) != float(torus_hw)):
        raise ValueError(
            f"shared plan geometry (g={plan.g}, K={plan.max_per_cell}, "
            f"hw={plan.torus_hw}) does not match this call (g={g}, K={k}, "
            f"hw={torus_hw})"
        )
    order = plan.order.long()
    ok = plan.ok
    xr, yr, slot = slot_planes(pos, plan)
    fx, fy = grid_sweep(xr, yr, slot, g, k, r, k_sep, personal_space, eps,
                        torus_hw)
    f_v = torch.zeros_like(pos)
    if overflow_budget > 0:
        fx, fy, f_v = _overflow_rescue_local(
            pos, alive, plan.cx, plan.cy, order, ok, xr, yr, fx, fy,
            float(k_sep), float(personal_space), float(eps),
            float(torus_hw), int(overflow_budget), g, k, r,
        )
    flat = (plan.skey.clamp(max=g * g - 1) * k
            + plan.rank.clamp(max=k - 1)).long()
    force_s = torch.stack([torch.where(ok, fx[flat], 0.0),
                           torch.where(ok, fy[flat], 0.0)], 1)
    out = torch.zeros_like(pos)
    out[order] = force_s.to(pos.dtype)
    return out + f_v


def hashgrid_overflow(pos, cell, max_per_cell, torus_hw, alive=None):
    """Number of live agents past the per-cell slot cap (they receive
    force only from the rescue), as a device scalar."""
    if alive is None:
        alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    g, _ = _geometry(torus_hw, cell)
    plan = _hp.build_hashgrid_plan(pos, alive, torus_hw, 2.0 * torus_hw / g,
                                   max_per_cell, g=g)
    return (~plan.ok & alive.bool()[plan.order.long()]).sum()
