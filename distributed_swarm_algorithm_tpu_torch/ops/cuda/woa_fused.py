"""Fused whale-optimization iterations: ``k_steps`` pod updates in one
pass.

Replaces the TPU kernel ``ops/pallas/woa_fused.py:fused_woa_step_t`` of the
JAX package.

- :func:`fused_woa_step_cuda` launches the hand-written CUDA kernel
  ``csrc/woa_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_woa_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_woa_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

The random peer is the JAX package's rotational donor: lane j of tile i
reads lane ``(j - s) mod tile_n`` of tile ``(i + tshift) mod n_tiles`` of
the launch's input (``jnp.roll``'s direction), ``s = lshift +
LANE_SHIFTS[step % 8][0]``, with ``tshift`` and ``lshift`` drawn per
launch.  So ``tile_n`` and the cyclic padding are the JAX package's.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed, A's
uniforms on stream 0 and C's on stream 1 over the dimensions, counter
(lane, block of four dimensions, global step, stream); p and l are words 0
and 1 of the call (lane, 0, global step, 2).  ``rng="host"`` takes the four
as operands (one step per call).

Up to D = 224 a block of the kernel holds 256 whales and, at every step,
regroups its lanes by branch (:func:`branch_order`), so that a warp's
threads advance lanes of one branch and only contracting whales draw A and
C; wider, up to D = 1,816, it runs its first version, one thread a whale in
the whales' order (:func:`woa_geometry` picks; the kernel's entry checks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .._numerics import div
from ..woa import SPIRAL_B, WOAState
from . import family
from .common import ceil_to, cyclic_pad_rows
from .family import LANE_SHIFTS, branch_order  # noqa: F401  (the kernel's)
from .pso_fused import (
    MAX_SHARED_BYTES,
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    _cos2pi,
    best_of_block,
    merge_best,
    philox_uniforms,
    run_blocks,
    seed_base,
)

# Launches of the CUDA kernel through fused_woa_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family.
MAX_STEPS_PER_KERNEL = 32


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel's first version: the largest of 128,
    64 and 32 whose ``[D][block]`` f32 tile fits a block's shared memory,
    or 0 (D > 1816)."""
    return family.pick_block(lambda block: dim * block * 4)


# The main variant's block: 256 whales, regrouped by branch at every step.
SORTED_LANES = 256
# A lane's class at a step, in the order of the regrouping.
CONTRACT, SPIRAL = range(2)


class WoaGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    variant: int    # 0: lanes regrouped by branch; 1: the first version
    lanes: int      # whales (threads) a block
    shared: int     # dynamic shared memory a block, bytes


def sorted_bytes(dim: int) -> int:
    """Shared memory of a main-variant block: the whales' positions
    ``[D][256]``, the best (padded to four), two ``[256]`` rows (the sorted
    lanes and their u_l) and the warps' class counts ``[8]``."""
    lanes = SORTED_LANES
    return 4 * (dim * lanes + ceil_to(dim, 4) + 2 * lanes + lanes // 32)


def woa_geometry(dim: int) -> WoaGeometry:
    """Blocks of 256 whales regrouped by branch where their block fits
    (D <= 224); wider, the first version (:func:`lane_geometry`)."""
    shared = sorted_bytes(dim)
    if shared <= MAX_SHARED_BYTES:
        return WoaGeometry(0, SORTED_LANES, shared)
    return lane_geometry(dim)


def lane_geometry(dim: int) -> WoaGeometry:
    """The first version at any D of the envelope: one [D][block] tile,
    the block from :func:`kernel_block`."""
    lanes = kernel_block(dim)
    return WoaGeometry(1, lanes, dim * lanes * 4)


def lane_classes(u_p: torch.Tensor) -> torch.Tensor:
    """Per lane its class at a step (int64): ``CONTRACT`` where ``u_p <
    1/2``, else ``SPIRAL``."""
    return torch.where(u_p < 0.5, CONTRACT, SPIRAL)


def woa_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 1816, where the kernel's ``[D][32]`` tile still fits a block's
    shared memory.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def woa_steps_plain(scalars, best, pos, draws, objective_name, half_width,
                    t_max, spiral_b, tile_n, k_steps, step0, counts=None):
    """``k_steps`` pod updates on ``[D, N]``, then the fitness once;
    ``draws is None`` draws from Philox.  ``counts`` (a dict) collects each
    step's contracting elements (lanes with ``u_p < 1/2``, times D), the
    only ones that read A's and C's draws."""
    d, n = pos.shape
    n_tiles = n // tile_n
    seed = scalars[0:1]
    t0 = scalars[2].to(torch.float32)
    dev = pos.device
    # The peer tile of each tile, from the launch's input.
    tiles = (torch.arange(n_tiles, device=dev) + scalars[1].long()) % n_tiles
    peer_tiles = pos.reshape(d, n_tiles, tile_n).index_select(1, tiles)
    lanes = torch.arange(tile_n, device=dev)
    for step in range(k_steps):
        frac = torch.clamp(div(t0 + step, t_max), max=1.0)
        a = 2.0 * (1.0 - frac)
        if draws is None:
            u_a = philox_uniforms(seed, n, d, step0 + step, 0)
            u_c = philox_uniforms(seed, n, d, step0 + step, 1)
            rows = philox_uniforms(seed, n, 4, step0 + step, 2)
            u_p, u_l = rows[0:1], rows[1:2]
        else:
            u_a, u_c, u_p, u_l = draws
        big_a = 2.0 * a * u_a - a
        big_c = 2.0 * u_c
        shift = scalars[3].long() + LANE_SHIFTS[step % len(LANE_SHIFTS)][0]
        peer = peer_tiles.index_select(2, (lanes - shift) % tile_n)
        explore = torch.abs(big_a) >= 1.0
        prey = torch.where(explore, peer.reshape(d, n), best)
        contract = prey - big_a * torch.abs(big_c * prey - pos)

        l = 2.0 * u_l - 1.0                          # [1, N] in [-1, 1)
        dist_best = torch.abs(best - pos)
        spiral = dist_best * torch.exp(spiral_b * l) * _cos2pi(l) + best
        pos = torch.clamp(torch.where(u_p < 0.5, contract, spiral),
                          -half_width, half_width)
        if counts is not None:
            counts.setdefault("contract", []).append((u_p < 0.5).sum() * d)
    return pos, OBJECTIVES_T[objective_name](pos)


def _check(rng, draws, k_steps, tile_n, n):
    family.check_rng(rng, draws, k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_woa_step_plain(
    scalars, best_pos, pos, r_a=None, r_c=None, r_p=None, r_l=None, *,
    objective_name: str, half_width: float = 5.12, t_max: int = 500,
    spiral_b: float = SPIRAL_B, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_woa_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`woa_steps_plain`)."""
    draws = (r_a, r_c, r_p, r_l)
    _check(rng, draws, k_steps, tile_n, pos.shape[1])
    return woa_steps_plain(scalars, best_pos, pos,
                           draws if rng == "host" else None, objective_name,
                           half_width, t_max, spiral_b, tile_n, k_steps,
                           step0, counts)


def _kernel():
    global _fn
    if _fn is None:
        i, f = ctypes.c_int, ctypes.c_float
        _fn = family.bind("woa_fused", "dsa_woa_fused_f32", 9,
                          [i, i, i, i, ctypes.c_uint, i, f, f, f, i, i, i])
    return _fn


def fused_woa_step_cuda(
    scalars, best_pos, pos, r_a=None, r_c=None, r_p=None, r_l=None, *,
    objective_name: str, half_width: float = 5.12, t_max: int = 500,
    spiral_b: float = SPIRAL_B, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused whale updates on ``pos``
    [D, N] (f32, contiguous, one CUDA device; N a multiple of ``tile_n``)
    toward ``best_pos`` [D, 1], held fixed.  ``scalars`` is [4] int32 on the
    device: the seed, the peer tile shift, the iteration at the launch's
    start and the lane shift; ``step0`` is the global index of the launch's
    first step.  A block as :func:`woa_geometry` says.  Returns new tensors
    ``(pos, fit [1, N])`` without waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    draws = (r_a, r_c, r_p, r_l)
    _check(rng, draws, k_steps, tile_n, n)
    if rng == "device":
        r_a = r_c = r_p = r_l = None
    if t_max < 1:
        raise ValueError(f"t_max must be >= 1, got {t_max}")
    family.check_operands(
        "fused_woa_step_cuda", scalars, 4, pos,
        dict(best_pos=(best_pos, (d, 1)), r_a=(r_a, (d, n)),
             r_c=(r_c, (d, n)), r_p=(r_p, (1, n)), r_l=(r_l, (1, n))))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_woa_step_cuda: D = {d} is outside the kernel's envelope "
            f"(a [D][32] f32 tile must fit {family.MAX_SHARED_BYTES} bytes "
            "of shared memory)")
    pos_out = torch.empty_like(pos)
    fit_out = torch.empty((1, n), dtype=torch.float32, device=pos.device)
    err = _kernel()(
        scalars.data_ptr(), best_pos.data_ptr(), pos.data_ptr(),
        *(family.ptr(r) for r in (r_a, r_c, r_p, r_l)), pos_out.data_ptr(),
        fit_out.data_ptr(), n, d, int(tile_n), int(k_steps),
        int(step0) & _MASK32, OBJECTIVE_IDS[objective_name], float(t_max),
        float(spiral_b), float(half_width), *woa_geometry(d),
        *family.stream_args(pos),
    )
    family.check_launch(err, "woa")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_woa_step_t(scalars, best_pos, pos, r_a=None, r_c=None, r_p=None,
                     r_l=None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k_steps`` fused WOA updates: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors (see :func:`fused_woa_step_cuda`)."""
    step = (fused_woa_step_plain if pos.device.type == "cpu"
            else fused_woa_step_cuda)
    return step(scalars, best_pos, pos, r_a, r_c, r_p, r_l, **kw)


def fused_woa_run(
    state: WOAState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = 500,
    spiral_b: float = SPIRAL_B,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
    shifts: Optional[torch.Tensor] = None,
) -> WOAState:
    """``n_steps`` fused WOA updates with no read from the device: WOAState
    in, WOAState out, the fast path beside ``ops.woa.woa_run`` (the peer is
    the rotational donor, the best and the donor snapshot refresh per
    launch, and the best ranks the launch's final whales only).  At most 32
    steps go in a launch.

    ``shifts`` [n_launches, 2] int32 gives each launch's (tile shift, lane
    shift); by default they are drawn from ``state.gen`` on the device.
    ``rng="host"`` runs one step per launch with ``uniforms[i] = (r_a, r_c,
    r_p, r_l)`` for launch i, or with draws from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("woa", objective_name, state.pos.dtype,
                                    d, kernel_block, 1816)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    steps_per_kernel = min(steps_per_kernel, MAX_STEPS_PER_KERNEL)
    tile_n, n_pad = family.lane_tiling(n, tile_n, d)
    n_tiles = n_pad // tile_n
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, fit_t, best_pos, best_fit, it = carry
        if shifts is not None:
            tshift, lshift = shifts[call_i, 0], shifts[call_i, 1]
        else:
            tshift = family.random_int(state.gen, n_tiles, dev)
            lshift = family.random_int(state.gen, tile_n, dev)
        draws = (None,) * 4
        if rng == "host":
            draws = (uniforms[call_i] if uniforms is not None else (
                torch.rand((d, n_pad), generator=state.gen, device=dev),
                torch.rand((d, n_pad), generator=state.gen, device=dev),
                torch.rand((1, n_pad), generator=state.gen, device=dev),
                torch.rand((1, n_pad), generator=state.gen, device=dev)))
        pos_t, fit_t = fused_woa_step_t(
            family.block_scalars(seed, tshift, it, lshift),
            best_pos[:, None].contiguous(), pos_t, *draws,
            objective_name=objective_name, half_width=half_width,
            t_max=t_max, spiral_b=spiral_b, tile_n=tile_n, rng=rng,
            k_steps=k, step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(*best_of_block(fit_t, pos_t),
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit, it + k)

    pos_t, fit_t, best_pos, best_fit, _ = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32), state.iteration),
        n_steps, steps_per_kernel)
    dt = state.pos.dtype
    return WOAState(
        pos=pos_t.T[:n].to(dt).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
