"""Fused moth-flame iterations: ``k_steps`` spiral flights in one pass, each
flame updated in place by its own moth at every step.

Replaces the TPU kernel ``ops/pallas/mfo_fused.py:fused_mfo_step_t`` of the
JAX package.

- :func:`fused_mfo_step_cuda` launches the hand-written CUDA kernel
  ``csrc/mfo_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_mfo_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_mfo_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

The flame pairing is positional: moth j spirals around flame j where the
global column is below ``n_flames``, else around the clamp flame ``last``
(fixed over a launch), and flame j keeps the better of itself and moth j
(strictly better) at every step.  The rank order is restored between
launches by a stable sort every ``sort_blocks`` launches and once at the
end (:func:`resort_flames`).

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed, the
spiral's uniforms on stream 0 over the dimensions, counter (lane, block of
four dimensions, global step, 0).  ``rng="host"`` takes them as the operand
``r_l`` [D, N] (one step per call).

The fixed point (``csrc/mfo_fused.cu``'s header): an own moth equal to its
flame, the flame inside the domain, stays so at every step, up to the sign
of a zero.  So the kernel stops an own moth after the step that improves
its flame, evaluates a moth found at the fixed point when the launch starts
once, and regroups the moths still moving into whole warps before every
step.  The plain version computes every step; its ``counts`` tally what
the kernel needs.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..mfo import SPIRAL_B, T_MAX, MFOState, schedule
from . import family
from .common import ceil_to, cyclic_pad_rows
from .pso_fused import (
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    _cos2pi,
    philox_uniforms,
    run_blocks,
    seed_base,
)
from .fast_math import LOG2E as _LOG2E, exp2_fast

# Launches of the CUDA kernel through fused_mfo_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family.
MAX_STEPS_PER_KERNEL = 32
R_LO_FX = 65536.0    # fixed-point denominator of the l range's lower end
# The largest |b| for which b l log2 e stays finite for every l a launch
# can draw (|l| <= 65,537), as the kernel's entry checks it.
MAX_SPIRAL_B = 1e30

# The main variant's block: 128 moths, the moving ones regrouped before
# every step.
SORTED_LANES = 128


class MfoGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    variant: int    # 0: moths stopped at the fixed point, regrouped; 1: the
    #                 first version
    lanes: int      # moths (threads) a block
    shared: int     # dynamic shared memory a block, bytes


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel's first version: the largest of 128,
    64 and 32 whose moth and flame ``[D][block]`` f32 tiles fit a block's
    shared memory, or 0 (D > 908)."""
    return family.pick_block(lambda block: 2 * dim * block * 4)


def sorted_bytes(dim: int) -> int:
    """Shared memory of a main-variant block: the moths' positions and
    flames ``[D][128]`` each, ``last`` (padded to four), two ``[128]`` rows
    (the flame fitness by moth, the moths by place) and the warps' counts
    ``[4]``."""
    lanes = SORTED_LANES
    return 4 * (2 * dim * lanes + ceil_to(dim, 4) + 2 * lanes + lanes // 32)


def mfo_geometry(dim: int) -> MfoGeometry:
    """Blocks of 128 moths, stopped at the fixed point and regrouped, where
    their block fits (D <= 225); wider, the first version
    (:func:`lane_geometry`)."""
    shared = sorted_bytes(dim)
    if shared <= family.MAX_SHARED_BYTES:
        return MfoGeometry(0, SORTED_LANES, shared)
    return lane_geometry(dim)


def lane_geometry(dim: int) -> MfoGeometry:
    """The first version at any D of the envelope: every step of every
    moth, two [D][block] tiles, the block from :func:`kernel_block`."""
    lanes = kernel_block(dim)
    return MfoGeometry(1, lanes, 2 * dim * lanes * 4)


def can_stop(half_width: float, b: float) -> bool:
    """Whether the fixed point holds for a launch: ``half_width`` finite and
    ``b l log2 e`` finite for every l it can draw."""
    return math.isfinite(half_width) and abs(b) <= MAX_SPIRAL_B


def at_fixed_point(own, pos, flames, half_width, b) -> torch.Tensor:
    """[1, N] bool: the moths at the fixed point, which every step of a
    launch leaves as they are (up to the sign of a zero): own, equal to
    their flame in every dimension, the flame inside the domain."""
    if not can_stop(half_width, b):
        return torch.zeros_like(own)
    return (own & (pos == flames).all(0, keepdim=True)
            & (flames.abs() <= half_width).all(0, keepdim=True))


def mfo_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 908.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def resort_flames(flame_pos_t: torch.Tensor, flame_fit: torch.Tensor):
    """The flames in rank order (best first): a stable sort of the fitness,
    as ``jnp.argsort``, and a column gather."""
    order = torch.sort(flame_fit, stable=True).indices
    return flame_pos_t.index_select(1, order), flame_fit.index_select(0,
                                                                     order)


def mfo_steps_plain(scalars, last, pos, flames, flame_fit, r_l,
                    objective_name, half_width, b, tile_n, k_steps, step0,
                    counts=None):
    """``k_steps`` spiral flights on ``[D, N]``; ``r_l is None`` draws from
    Philox.  Returns (pos, fit, flames, flame_fit).  ``counts`` (a dict)
    collects what the kernel needs of the launch with its own draws (with
    handed draws it takes every step; device tensors, no wait):
    ``stopped_at_start``, the moths at the fixed point at its start;
    ``moving``, at each step the moths still moving (the rest: own moths
    past the step that improved their flame); ``lane_steps`` [N], the
    steps each moth takes."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    seed = scalars[0:1]
    r_lo = scalars[2].to(torch.float32) / R_LO_FX
    own = torch.arange(n, device=pos.device)[None, :] < scalars[1]
    if counts is not None:
        moving = ~at_fixed_point(own, pos, flames, half_width, b)
        stops = own & can_stop(half_width, b)
        steps = torch.zeros((1, n), dtype=torch.int32, device=pos.device)
        counts.setdefault("stopped_at_start", []).append((~moving).sum())
    for step in range(k_steps):
        if counts is not None:
            counts.setdefault("moving", []).append(moving.sum())
            steps += moving.to(torch.int32)
        u = (philox_uniforms(seed, n, d, step0 + step, 0) if r_l is None
             else r_l)
        l = u * (1.0 - r_lo) + r_lo                 # U(r, 1)
        flame = torch.where(own, flames, last)
        dist = torch.abs(flame - pos)
        pos = dist * exp2_fast(b * l * _LOG2E) * _cos2pi(l) + flame
        pos = torch.clamp(pos, -half_width, half_width)
        mfit = objective_t(pos)
        better = mfit < flame_fit
        flames = torch.where(better, pos, flames)
        flame_fit = torch.where(better, mfit, flame_fit)
        if counts is not None:
            moving = moving & ~(better & stops)
    if counts is not None:
        counts.setdefault("lane_steps", []).append(steps[0])
    return pos, mfit, flames, flame_fit


def _check(rng, r_l, k_steps, tile_n, n):
    family.check_rng(rng, (r_l,), k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_mfo_step_plain(
    scalars, last_flame, pos, flames, flame_fit, r_l=None, *,
    objective_name: str, half_width: float = 5.12, b: float = SPIRAL_B,
    tile_n: int = 4096, rng: str = "device", k_steps: int = 1,
    step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_mfo_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`mfo_steps_plain`)."""
    _check(rng, r_l, k_steps, tile_n, pos.shape[1])
    return mfo_steps_plain(scalars, last_flame, pos, flames, flame_fit,
                           r_l if rng == "host" else None, objective_name,
                           half_width, b, tile_n, k_steps, step0, counts)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("mfo_fused", "dsa_mfo_fused_f32", 10,
                          [i, i, i, i, ctypes.c_uint, i, fl, fl, i, i, i])
    return _fn


def fused_mfo_step_cuda(
    scalars, last_flame, pos, flames, flame_fit, r_l=None, *,
    objective_name: str, half_width: float = 5.12, b: float = SPIRAL_B,
    tile_n: int = 4096, rng: str = "device", k_steps: int = 1,
    step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused moth flights on ``pos``
    [D, N] around the positional ``flames`` [D, N] (fitness ``flame_fit``
    [1, N]) and the clamp flame ``last_flame`` [D, 1] (f32, contiguous, one
    CUDA device; N a multiple of ``tile_n``).  ``scalars`` is [3] int32 on
    the device: the seed, ``n_flames`` and the l range's lower end in 16.16
    fixed point; ``step0`` is the global index of the launch's first step.
    A block as :func:`mfo_geometry` says.  Returns new tensors ``(pos, fit,
    flames, flame_fit)`` without waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, r_l, k_steps, tile_n, n)
    if rng == "device":
        r_l = None
    family.check_operands(
        "fused_mfo_step_cuda", scalars, 3, pos,
        dict(last_flame=(last_flame, (d, 1)), flames=(flames, (d, n)),
             flame_fit=(flame_fit, (1, n)), r_l=(r_l, (d, n))))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_mfo_step_cuda: D = {d} is outside the kernel's envelope "
            f"(two [D][32] f32 tiles must fit {family.MAX_SHARED_BYTES} "
            "bytes of shared memory)")
    outs = (torch.empty_like(pos), torch.empty_like(flame_fit),
            torch.empty_like(pos), torch.empty_like(flame_fit))
    err = _kernel()(
        scalars.data_ptr(), last_flame.data_ptr(), pos.data_ptr(),
        flames.data_ptr(), flame_fit.data_ptr(), family.ptr(r_l),
        *(o.data_ptr() for o in outs), n, d, int(tile_n), int(k_steps),
        int(step0) & _MASK32, OBJECTIVE_IDS[objective_name], float(b),
        float(half_width), *mfo_geometry(d), *family.stream_args(pos),
    )
    family.check_launch(err, "mfo")
    LAUNCHES += 1
    return outs


def fused_mfo_step_t(scalars, last_flame, pos, flames, flame_fit, r_l=None,
                     **kw) -> Tuple[torch.Tensor, ...]:
    """``k_steps`` fused MFO flights: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors (see :func:`fused_mfo_step_cuda`)."""
    step = (fused_mfo_step_plain if pos.device.type == "cpu"
            else fused_mfo_step_cuda)
    return step(scalars, last_flame, pos, flames, flame_fit, r_l, **kw)


def fused_mfo_run(
    state: MFOState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    b: float = SPIRAL_B,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    sort_blocks: int = 8,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> MFOState:
    """``n_steps`` fused MFO generations with no read from the device:
    MFOState in, MFOState out, the fast path beside ``ops.mfo.mfo_run``.
    The flames are updated per step and positionally in the kernel; the
    rank re-sort runs every ``sort_blocks`` launches and once at the end.
    The flames pad with the worst flame at infinite fitness (not
    cyclically), the moths cyclically.  ``rng="host"`` runs one step per
    launch with ``uniforms[i]`` [D, n_pad] as launch i's draws, or with
    draws from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("mfo", objective_name, state.pos.dtype,
                                    d, kernel_block, 908)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    steps_per_kernel = min(steps_per_kernel, MAX_STEPS_PER_KERNEL)
    tile_n, n_pad = family.lane_tiling(n, tile_n, d)
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    worst = state.flame_pos[-1].to(torch.float32)
    flame_pos_t = torch.cat(
        [state.flame_pos.T.to(torch.float32),
         worst[:, None].expand(d, n_pad - n)], dim=1).contiguous()
    flame_fit = torch.cat([
        state.flame_fit.to(torch.float32),
        torch.full((n_pad - n,), float("inf"), device=dev)])
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, fit_t, flame_pos_t, flame_fit, it = carry
        frac, n_flames = schedule(it, n, t_max, torch.float32)
        r_lo = torch.round((-1.0 - frac) * R_LO_FX).to(torch.int32)
        last = flame_pos_t.index_select(
            1, torch.clamp(n_flames - 1, min=0).long().reshape(1))
        r_l = None
        if rng == "host":
            r_l = (uniforms[call_i] if uniforms is not None else
                   torch.rand((d, n_pad), generator=state.gen, device=dev))
        pos_t, fit_t, flame_pos_t, flame_fit_row = fused_mfo_step_t(
            family.block_scalars(seed, n_flames, r_lo), last, pos_t,
            flame_pos_t, flame_fit[None, :].contiguous(), r_l,
            objective_name=objective_name, half_width=half_width, b=b,
            tile_n=tile_n, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel)
        flame_fit = flame_fit_row[0]
        if (call_i + 1) % sort_blocks == 0:
            flame_pos_t, flame_fit = resort_flames(flame_pos_t, flame_fit)
        return (pos_t, fit_t, flame_pos_t, flame_fit, it + k)

    pos_t, fit_t, flame_pos_t, flame_fit, _ = run_blocks(
        block, (pos_t, fit_t, flame_pos_t, flame_fit, state.iteration),
        n_steps, steps_per_kernel)
    flame_pos_t, flame_fit = resort_flames(flame_pos_t, flame_fit)
    return MFOState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        flame_pos=flame_pos_t.T[:n].to(state.flame_pos.dtype).contiguous(),
        flame_fit=flame_fit[:n].to(state.flame_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
