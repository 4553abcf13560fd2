"""Fused differential-evolution generations: ``k_steps`` DE generations in
one pass, with rotational donors.

Replaces the TPU kernel ``ops/pallas/de_fused.py:fused_de_step_t`` of the
JAX package.

- :func:`fused_de_step_cuda` launches the hand-written CUDA kernel
  ``csrc/de_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_de_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_de_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

Donor k (a, b, c) of lane j of tile i is lane ``(j - s) mod tile_n`` of
tile ``(i + tshift_k) mod n_tiles`` of the launch's input (``jnp.roll``'s
direction), ``s = lshift_k + LANE_SHIFTS[step % 8][k]``: block-start
snapshots, the tile shifts distinct and nonzero.  As in the JAX kernel the
crossover draws one uniform per gene and has no ``j_rand`` column, and the
selection keeps the trial where ``f(trial) <= f(x)``.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed, the
crossover uniforms on stream 0 over the dimensions, counter (lane, block of
four dimensions, global step, 0).  ``rng="host"`` takes them as the operand
``r`` [D, N] (one step per call).

The donors are block-start snapshots, so up to D = 179 the kernel stages,
once a launch, each block's three donor windows in shared memory
(:func:`donor_window`); above, it reads them from global memory
(:func:`de_geometry` picks; the kernel's entry checks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..de import CR, DEState, F
from . import family
from .common import ceil_to, cyclic_pad_rows
from .family import LANE_SHIFTS, donor_tiles, roll_lanes
from .pso_fused import (
    MAX_SHARED_BYTES,
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    best_of_block,
    merge_best,
    philox_uniforms,
    run_blocks,
    seed_base,
)

# Launches of the CUDA kernel through fused_de_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family
# (ops/pallas/de_fused.py:270).
MAX_STEPS_PER_KERNEL = 32


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel's global-memory variant: the largest
    of 128, 64 and 32 whose two ``[D][block]`` f32 tiles (the population
    and the trial) fit a block's shared memory, or 0 (D > 908): the
    kernel's envelope."""
    return family.pick_block(lambda block: 2 * dim * block * 4)


# Donor k's largest schedule shift and its window's lanes beyond a block's
# (the largest shift of its LANE_SHIFTS column less the smallest): 37, 95,
# 113 and 36, 50, 108.
SHIFT_MAX = tuple(max(col) for col in zip(*LANE_SHIFTS))
WINDOW_SPAN = tuple(max(col) - min(col) for col in zip(*LANE_SHIFTS))
# The staged variant's blocks: a thread a lane, a multiple of 32 up to 512.
STAGED_MAX_LANES = 512
# Shared memory of an SM and what the card reserves a block (sm_90).
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 228 * 1024, 1024


class DeGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    variant: int    # 0: donor windows staged; 1: donors from global memory
    lanes: int      # lanes (threads) a block
    shared: int     # dynamic shared memory a block, bytes


def staged_bytes(dim: int, lanes: int) -> int:
    """Shared memory of a staged block: its own lanes, the three windows
    ``[D][lanes + span]`` and the crossing masks of all but the last 32
    genes."""
    return 4 * (dim * lanes + dim * sum(lanes + s for s in WINDOW_SPAN)
                + (dim - 1) // 32 * lanes)


def donor_window(lanes: int, tile_n: int, j0: int, lshift: int,
                 k: int) -> Tuple[int, int]:
    """(first lane, length) of the window of donor k that a staged block of
    ``lanes`` lanes starting at lane ``j0`` of its tile stages: window
    element e is tile lane ``(first + e) mod tile_n``, and at step s the
    block's lane t reads element ``t + SHIFT_MAX[k] -
    LANE_SHIFTS[s % 8][k]``."""
    return ((j0 - lshift - SHIFT_MAX[k]) % tile_n, lanes + WINDOW_SPAN[k])


def de_geometry(dim: int, tile_n: int) -> DeGeometry:
    """The staged variant where a block of 32 lanes fits, with the lanes
    (at most the tile rounded up to a warp) that keep the most warps
    resident on an SM, by shared memory and threads, among the blocks of
    which two or more fit an SM (so that one block's staging overlaps
    another's steps), or among all where none does; the more lanes among
    equals.  Else the global-memory variant (D <= 908)."""
    options = []
    for lanes in range(32, min(STAGED_MAX_LANES, ceil_to(tile_n, 32)) + 1,
                       32):
        shared = staged_bytes(dim, lanes)
        if shared > MAX_SHARED_BYTES:
            break
        blocks = min(2048 // lanes,
                     SM_SHARED_BYTES // (shared + BLOCK_RESERVED_BYTES))
        options.append((blocks >= 2, blocks * lanes, lanes, shared))
    if options:
        _, _, lanes, shared = max(options)
        return DeGeometry(0, lanes, shared)
    return global_geometry(dim, tile_n)


def global_geometry(dim: int, tile_n: int) -> DeGeometry:
    """The global-memory variant (the first version) at any D <= 908."""
    block = kernel_block(dim)
    if block == 0:
        raise ValueError(
            f"the fused DE kernel takes D <= 908 (two [D][32] f32 tiles in "
            f"{MAX_SHARED_BYTES} bytes of shared memory), got D = {dim}")
    return DeGeometry(1, block, 2 * dim * block * 4)


def de_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 908.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def de_steps_plain(scalars, pos, fit, r, objective_name, f, cr, half_width,
                   tile_n, k_steps, step0):
    """``k_steps`` generations on ``[D, N]``; ``r is None`` draws from
    Philox."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    seed = scalars[0:1]
    donors = [donor_tiles(pos, tile_n, scalars[1 + k]) for k in range(3)]
    for step in range(k_steps):
        sched = LANE_SHIFTS[step % len(LANE_SHIFTS)]
        a, b, c = (roll_lanes(donors[k], scalars[4 + k].long() + sched[k])
                   for k in range(3))
        mutant = torch.clamp(a + f * (b - c), -half_width, half_width)
        u = philox_uniforms(seed, n, d, step0 + step, 0) if r is None else r
        trial = torch.where(u < cr, mutant, pos)
        tfit = objective_t(trial)
        better = tfit <= fit
        fit = torch.where(better, tfit, fit)
        pos = torch.where(better, trial, pos)
    return pos, fit


def _check(rng, r, k_steps, tile_n, n):
    family.check_rng(rng, (r,), k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_de_step_plain(
    scalars, pos, fit, r=None, *, objective_name: str, f: float = F,
    cr: float = CR, half_width: float = 5.12, tile_n: int = 4096,
    rng: str = "device", k_steps: int = 1, step0: int = 0,
):
    """The plain PyTorch version of :func:`fused_de_step_cuda`, on any
    device; same arguments and results."""
    _check(rng, r, k_steps, tile_n, pos.shape[1])
    return de_steps_plain(scalars, pos, fit, r if rng == "host" else None,
                          objective_name, f, cr, half_width, tile_n, k_steps,
                          step0)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("de_fused", "dsa_de_fused_f32", 6,
                          [i, i, i, i, ctypes.c_uint, i, fl, fl, fl, i, i,
                           i])
    return _fn


def fused_de_step_cuda(
    scalars, pos, fit, r=None, *, objective_name: str, f: float = F,
    cr: float = CR, half_width: float = 5.12, tile_n: int = 4096,
    rng: str = "device", k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused DE generations on ``pos``
    [D, N] and ``fit`` [1, N] (f32, contiguous, one CUDA device; N a
    multiple of ``tile_n``; D <= 908), as :func:`de_geometry` says.
    ``scalars`` is [7] int32 on the device: the seed, the three donor tile
    shifts and the three donor lane shifts; ``step0`` is the global index
    of the launch's first step.  Returns new tensors ``(pos, fit)`` without
    waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, r, k_steps, tile_n, n)
    if rng == "device":
        r = None
    family.check_operands("fused_de_step_cuda", scalars, 7, pos,
                          dict(fit=(fit, (1, n)), r=(r, (d, n))))
    geo = de_geometry(d, int(tile_n))
    pos_out = torch.empty_like(pos)
    fit_out = torch.empty_like(fit)
    err = _kernel()(
        scalars.data_ptr(), pos.data_ptr(), fit.data_ptr(), family.ptr(r),
        pos_out.data_ptr(), fit_out.data_ptr(), n, d, int(tile_n),
        int(k_steps), int(step0) & _MASK32, OBJECTIVE_IDS[objective_name],
        float(f), float(cr), float(half_width), *geo,
        *family.stream_args(pos),
    )
    family.check_launch(err, "de")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_de_step_t(scalars, pos, fit, r=None,
                    **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k_steps`` fused DE generations: the plain version on CPU tensors,
    the CUDA kernel on CUDA tensors (see :func:`fused_de_step_cuda`)."""
    step = (fused_de_step_plain if pos.device.type == "cpu"
            else fused_de_step_cuda)
    return step(scalars, pos, fit, r, **kw)


def fused_de_run(
    state: DEState,
    objective_name: str,
    n_steps: int,
    f: float = F,
    cr: float = CR,
    half_width: float = 5.12,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    shifts: Optional[torch.Tensor] = None,
) -> DEState:
    """``n_steps`` fused DE generations with no read from the device:
    DEState in, DEState out, the fast path beside ``ops.de.de_run``
    (rand/1/bin with rotational block-start donors and no ``j_rand``).  At
    most 32 steps go in a launch; at least 4 tiles are needed, the tile
    shrinking in 128-lane steps (``family.shrink_tile_for_donors``).

    ``shifts`` [n_launches, 6] int32 gives each launch's three tile shifts
    and three lane shifts; by default they are drawn from ``state.gen`` on
    the device.  ``rng="host"`` runs one step per launch with
    ``uniforms[i]`` [D, n_pad] as launch i's crossover uniforms, or with
    draws from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("de", objective_name, state.pos.dtype,
                                    d, kernel_block, 908)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    steps_per_kernel = min(steps_per_kernel, MAX_STEPS_PER_KERNEL)
    tile_n, _ = family.lane_tiling(n, tile_n, d)
    tile_n, n_pad, n_tiles = family.shrink_tile_for_donors(n, tile_n)
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, fit_t, best_pos, best_fit = carry
        if shifts is not None:
            launch = shifts[call_i].to(device=dev, dtype=torch.int32)
        else:
            launch = torch.cat([
                family.distinct_tile_shifts(state.gen, n_tiles, dev),
                torch.randint(0, tile_n, (3,), generator=state.gen,
                              dtype=torch.int32, device=dev)])
        r = None
        if rng == "host":
            r = (uniforms[call_i] if uniforms is not None else
                 torch.rand((d, n_pad), generator=state.gen, device=dev))
        pos_t, fit_t = fused_de_step_t(
            torch.cat([seed, launch]), pos_t, fit_t, r,
            objective_name=objective_name, f=f, cr=cr,
            half_width=half_width, tile_n=tile_n, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(*best_of_block(fit_t, pos_t),
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit)

    pos_t, fit_t, best_pos, best_fit = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32)),
        n_steps, steps_per_kernel)
    return DEState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
