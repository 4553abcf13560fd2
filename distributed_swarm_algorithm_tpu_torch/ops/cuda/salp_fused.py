"""Fused salp-swarm generations: ``k_steps`` steps of the chain in one
pass, the best position visited recorded at every step.

Replaces the TPU kernel ``ops/pallas/salp_fused.py:fused_salp_step_t`` of
the JAX package.

- :func:`fused_salp_step_cuda` launches the hand-written CUDA kernel
  ``csrc/salp_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_salp_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_salp_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

The tile is part of what this kernel computes: the follower rule runs
within each ``tile_n``-lane tile, and a tile's lane 0 follows the previous
tile's last lane as it was at the launch's start (the chain link, fixed
over a launch, as the food source is).  So ``tile_n`` and the cyclic
padding are the JAX package's.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed; only
global lane 0 draws, c2 with the counter (0, block of four dimensions,
global step, 0), c3 on stream 1.  ``rng="host"`` takes them as operands
``r2``, ``r3`` [D, 1] (one step per call).

A block of the kernel owns ``lanes`` lanes of one tile and runs ``lanes +
16`` threads, the 16 halo columns its own (:func:`salp_geometry` picks the
block, the kernel's entry checks it); it keeps each lane's best fitness
and step only, and rebuilds the block's winner at its best step by
replaying the chain from the launch's input (:func:`winner_replay` is the
same replay in PyTorch).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .._numerics import div
from ..salp import T_MAX, SalpState
from . import family
from .common import ceil_to, cyclic_pad_rows
from .fast_math import (  # noqa: F401  (the old names stay importable)
    LOG2E as _LOG2E,
    exp2_fast,
    exp2_poly as _exp2_poly,
    exp_fast as _exp_fast,
)
from .pso_fused import (
    MAX_SHARED_BYTES,
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    merge_best,
    philox_uniforms,
    run_blocks,
    seed_base,
)

# Launches of the CUDA kernel through fused_salp_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The most steps one launch may take: the kernel's left halo of lanes
# (csrc/salp_fused.cu: kHalo), and the JAX package's cap on
# steps_per_kernel.
MAX_STEPS_PER_KERNEL = 16
# The widest D the kernel takes (the first version's envelope, kept).
MAX_DIM = 452
# Lanes a block may own, most first: a power of two that divides the tile.
SALP_LANES = (512, 256, 128, 64, 32)

# --------------------------------------------------------------------------
# The step: plain version, kernel wrapper, entry
# --------------------------------------------------------------------------


class SalpGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    lanes: int      # lanes a block owns; it runs lanes + 16 threads
    shared: int     # dynamic shared memory a block, bytes


def chain_bytes(dim: int, lanes: int) -> int:
    """Shared memory of a block owning ``lanes`` lanes: the window's
    columns ``[D][lanes + 16]``, each warp's published column for the next
    warp, by the step's parity ``[2][warps][D]`` (rows padded to four),
    and the winner's reduction ``[3][32]``."""
    width = lanes + MAX_STEPS_PER_KERNEL
    warps = -(-width // 32)
    return 4 * (dim * width + 2 * warps * ceil_to(dim, 4) + 3 * 32)


def salp_geometry(dim: int, tile_n: int) -> Optional[SalpGeometry]:
    """The most lanes a block can own (:data:`SALP_LANES`) that divide
    ``tile_n`` and whose bytes fit a block, or None past the envelope (D >
    452).  512 at the main path (D = 30, tiles of 4,096)."""
    if not 0 < dim <= MAX_DIM:
        return None
    for lanes in SALP_LANES:
        shared = chain_bytes(dim, lanes)
        if tile_n % lanes == 0 and shared <= MAX_SHARED_BYTES:
            return SalpGeometry(lanes, shared)
    return None


def kernel_block(dim: int) -> int:
    """Lanes a block of the kernel owns at this D in a tile that any block
    divides, or 0 outside the envelope (D > 452)."""
    geo = salp_geometry(dim, SALP_LANES[0])
    return 0 if geo is None else geo.lanes


def salp_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 452.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def leader_c1(it0: torch.Tensor, step: int, t_max: int) -> torch.Tensor:
    """[1] f32: the envelope ``2 exp_fast(-(4 t / T)^2)`` at
    ``t = it0 + step + 1``."""
    t = (it0 + (step + 1)).to(torch.float32).reshape(1)
    z = div(4.0 * t, float(t_max))
    return 2.0 * _exp_fast(-1.0 * (z * z))


def salp_steps_plain(scalars, food, pos, fit, r2, r3, objective_name,
                     half_width, t_max, tile_n, k_steps, step0):
    """``k_steps`` chain steps on ``[D, N]``; ``r2 is None`` draws from
    Philox.  Returns (pos, fit, best_fit [1, 1], best_pos [D, 1])."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    n_tiles = n // tile_n
    lb, ub = -half_width, half_width
    seed = scalars[0:1]
    # The previous tile's last lane at the launch's start, per tile.
    prev_tile = (torch.arange(n_tiles, device=pos.device) - 1) % n_tiles
    link = pos.reshape(d, n_tiles, tile_n)[:, prev_tile, tile_n - 1]
    rb_fit, rb_pos = fit, pos
    for step in range(k_steps):
        c1 = leader_c1(scalars[1], step, t_max)
        if r2 is None:
            c2 = philox_uniforms(seed, 1, d, step0 + step, 0)
            c3 = philox_uniforms(seed, 1, d, step0 + step, 1)
        else:
            c2, c3 = r2, r3
        sign = torch.where(c3 >= 0.5, 1.0, -1.0).to(torch.float32)
        leader = food + sign * c1 * ((ub - lb) * c2 + lb)       # [D, 1]

        x = pos.reshape(d, n_tiles, tile_n)
        prev = torch.cat([link[:, :, None], x[:, :, :-1]], dim=2)
        followers = (0.5 * (x + prev)).reshape(d, n)
        pos = torch.cat([leader, followers[:, 1:]], dim=1)
        pos = torch.clamp(pos, lb, ub)
        fit = objective_t(pos)
        better = fit < rb_fit
        rb_fit = torch.where(better, fit, rb_fit)
        rb_pos = torch.where(better, pos, rb_pos)
    j = torch.argmin(rb_fit[0]).reshape(1)
    return (pos, fit, rb_fit.index_select(1, j),
            rb_pos.index_select(1, j))


def winner_replay(scalars, food, pos, r2, r3, half_width, t_max, tile_n,
                  step0, lane: int, steps: int) -> torch.Tensor:
    """[D]: lane ``lane``'s position after ``steps`` steps of the launch
    (``salp_steps_plain``'s arguments), rebuilt as the kernel rebuilds its
    block's winner: from the launch's input over a window of 17 lanes, the
    lane and the 16 before it in its tile, the one before the tile holding
    the chain link, global lane 0 taking the leader's move, the window's
    first lane reading itself (``__shfl_up_sync``'s lane 0)."""
    d, n = pos.shape
    n_tiles = n // tile_n
    tile, jw = divmod(lane, tile_n)
    link = (tile - 1) % n_tiles * tile_n + tile_n - 1
    jr = torch.arange(jw - MAX_STEPS_PER_KERNEL, jw + 1, device=pos.device)
    cols = pos[:, (tile * tile_n + jr).clamp(min=0)]
    v = torch.where(jr >= 0, cols,
                    torch.where(jr == -1, pos[:, link:link + 1], 0.0))
    moves = jr >= 0
    lb, ub = -half_width, half_width
    seed = scalars[0:1]
    for step in range(steps):
        prev = torch.cat([v[:, :1], v[:, :-1]], dim=1)
        v = torch.where(moves, torch.clamp(0.5 * (v + prev), lb, ub), v)
        if tile == 0 and jw <= MAX_STEPS_PER_KERNEL:
            # The window holds the leader.
            c1 = leader_c1(scalars[1], step, t_max)
            if r2 is None:
                c2 = philox_uniforms(seed, 1, d, step0 + step, 0)
                c3 = philox_uniforms(seed, 1, d, step0 + step, 1)
            else:
                c2, c3 = r2, r3
            sign = torch.where(c3 >= 0.5, 1.0, -1.0).to(torch.float32)
            leader = food + sign * c1 * ((ub - lb) * c2 + lb)
            v[:, MAX_STEPS_PER_KERNEL - jw] = torch.clamp(leader, lb, ub)[:, 0]
    return v[:, -1]


def _check(rng, r2, r3, k_steps, tile_n, n):
    family.check_rng(rng, (r2, r3), k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_salp_step_plain(
    scalars, food_pos, pos, fit, r2=None, r3=None, *, objective_name: str,
    half_width: float = 5.12, t_max: int = T_MAX, tile_n: int = 4096,
    rng: str = "device", k_steps: int = 1, step0: int = 0,
):
    """The plain PyTorch version of :func:`fused_salp_step_cuda`, on any
    device; same arguments and results."""
    _check(rng, r2, r3, k_steps, tile_n, pos.shape[1])
    if rng == "device":
        r2 = r3 = None
    return salp_steps_plain(scalars, food_pos, pos, fit, r2, r3,
                            objective_name, half_width, t_max, tile_n,
                            k_steps, step0)


def _kernel():
    global _fn
    if _fn is None:
        i, f = ctypes.c_int, ctypes.c_float
        _fn = family.bind("salp_fused", "dsa_salp_fused_f32", 10,
                          [i, i, i, i, ctypes.c_uint, i, f, f, f, f, i, i])
    return _fn


def fused_salp_step_cuda(
    scalars, food_pos, pos, fit, r2=None, r3=None, *, objective_name: str,
    half_width: float = 5.12, t_max: int = T_MAX, tile_n: int = 4096,
    rng: str = "device", k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` (<= 16) fused salp generations
    on ``pos`` [D, N] and ``fit`` [1, N] (f32, contiguous, one CUDA device;
    N a multiple of ``tile_n``, itself a multiple of 128) with the food
    ``food_pos`` [D, 1] held fixed.  ``scalars`` is [2] int32 on the device:
    the seed and the iteration at the launch's start; ``step0`` is the
    global index of the launch's first step.  Returns new tensors
    ``(pos, fit, best_fit [1, 1], best_pos [D, 1])``, the best being the
    least fitness seen at any step of the launch (or at its start), without
    waiting for the kernel.  A block as :func:`salp_geometry` says."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, r2, r3, k_steps, tile_n, n)
    if rng == "device":
        r2 = r3 = None
    family.check_operands(
        "fused_salp_step_cuda", scalars, 2, pos,
        dict(food_pos=(food_pos, (d, 1)), fit=(fit, (1, n)),
             r2=(r2, (d, 1)), r3=(r3, (d, 1))))
    if tile_n % 128:
        raise ValueError(f"fused_salp_step_cuda: tile_n ({tile_n}) must be a "
                         "multiple of 128")
    if k_steps > MAX_STEPS_PER_KERNEL:
        raise ValueError(f"fused_salp_step_cuda: k_steps ({k_steps}) is "
                         f"above the kernel's {MAX_STEPS_PER_KERNEL}")
    geo = salp_geometry(d, tile_n)
    if geo is None:
        raise ValueError(
            f"fused_salp_step_cuda: D = {d} is outside the kernel's envelope "
            f"(D <= {MAX_DIM})")
    pos_out = torch.empty_like(pos)
    fit_out = torch.empty_like(fit)
    blocks = n // geo.lanes
    block_fit = torch.empty(blocks, dtype=torch.float32, device=pos.device)
    block_pos = torch.empty((d, blocks), dtype=torch.float32,
                            device=pos.device)
    err = _kernel()(
        scalars.data_ptr(), food_pos.data_ptr(), pos.data_ptr(),
        fit.data_ptr(), family.ptr(r2), family.ptr(r3), pos_out.data_ptr(),
        fit_out.data_ptr(), block_fit.data_ptr(), block_pos.data_ptr(), n, d,
        int(tile_n), int(k_steps), int(step0) & _MASK32,
        OBJECTIVE_IDS[objective_name], float(t_max),
        float(half_width - (-half_width)), float(-half_width),
        float(half_width), *geo, *family.stream_args(pos),
    )
    family.check_launch(err, "salp")
    LAUNCHES += 1
    j = torch.argmin(block_fit).reshape(1)
    return (pos_out, fit_out, block_fit.index_select(0, j).reshape(1, 1),
            block_pos.index_select(1, j))


def fused_salp_step_t(scalars, food_pos, pos, fit, r2=None, r3=None,
                      **kw) -> Tuple[torch.Tensor, ...]:
    """``k_steps`` fused salp generations with per-step best recording:
    the plain version on CPU tensors, the CUDA kernel on CUDA tensors (see
    :func:`fused_salp_step_cuda`)."""
    step = (fused_salp_step_plain if pos.device.type == "cpu"
            else fused_salp_step_cuda)
    return step(scalars, food_pos, pos, fit, r2, r3, **kw)


def fused_salp_run(
    state: SalpState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 16,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> SalpState:
    """``n_steps`` fused salp generations with no read from the device:
    SalpState in, SalpState out, the fast path beside ``ops.salp.salp_run``
    with the chain link and the food refreshed per launch (exact within a
    tile).  At most 16 steps go in a launch.  ``rng="host"`` runs one step
    per launch with ``uniforms[i] = (r2, r3)``, each [D, 1], for launch i,
    or with draws from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("salp", objective_name, state.pos.dtype,
                                    d, kernel_block, 452)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    steps_per_kernel = min(steps_per_kernel, MAX_STEPS_PER_KERNEL)
    tile_n, n_pad = family.lane_tiling(n, tile_n, d)
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, fit_t, best_pos, best_fit, it = carry
        r2 = r3 = None
        if rng == "host":
            r2, r3 = (uniforms[call_i] if uniforms is not None else (
                torch.rand((d, 1), generator=state.gen, device=dev),
                torch.rand((d, 1), generator=state.gen, device=dev)))
        pos_t, fit_t, blk_fit, blk_pos = fused_salp_step_t(
            family.block_scalars(seed, it), best_pos[:, None].contiguous(),
            pos_t, fit_t, r2, r3, objective_name=objective_name,
            half_width=half_width, t_max=t_max, tile_n=tile_n, rng=rng,
            k_steps=k, step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(blk_fit[0, 0], blk_pos[:, 0],
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit, it + k)

    pos_t, fit_t, best_pos, best_fit, _ = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32), state.iteration),
        n_steps, steps_per_kernel)
    dt = state.pos.dtype
    return SalpState(
        pos=pos_t.T[:n].to(dt).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
