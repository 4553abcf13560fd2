"""Fused parallel tempering: ``k_steps`` Metropolis steps and their replica
exchanges in one pass, the best state visited recorded at every step.

Replaces the TPU kernel ``ops/pallas/tempering_fused.py:fused_pt_step_t``
of the JAX package.

- :func:`fused_pt_step_cuda` launches the hand-written CUDA kernel
  ``csrc/tempering_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_pt_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_pt_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

Per step, for chain (lane) j: a Metropolis move ``clip(x + sigma n)``
accepted where ``u < exp_fast(min((f - f') beta, 0))``; the lane's running
best visited state; then, where ``it % swap_every == 0``, an exchange
between adjacent lanes of the tile, paired ``(i, i ^ 1)`` shifted by the
parity ``(it // swap_every) % 2`` (the JAX package's tile-local pairing: at
odd parity a tile's first and last lanes sit out, and lanes at or past
``n_real``, the cyclic padding, never exchange), on the lower lane's
uniform.  The result carries the least running-best fitness of the launch
and its position, the lowest column on ties.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed; the
proposal is the cosine half of a Box-Muller pair whose uniforms are streams
0 and 1 over the dimensions, counter (lane, block of four dimensions,
global step, stream); ``u_acc`` and ``u_swap`` are words 0 and 1 of the
call (lane, 0, global step, 2).  ``rng="host"`` takes ``(r_n, r_acc,
r_swap)`` as operands (one step per call).

A block of the kernel is a window of 256 threads that owns 256 - 2h lanes
of a tile, h the halo (:func:`halo`), its candidate stored in a second
plane, up to D = 109; wider, up to D = 360, it runs its first version
(:func:`pt_geometry` picks; the kernel's entry checks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .._numerics import rdiv
from ..tempering import SIGMA0, SWAP_EVERY, PTState
from . import family
from .common import ceil_to, cyclic_pad_rows
from .family import roll_lanes
from .fast_math import exp_fast, normal_pair
from .pso_fused import (
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    merge_best,
    philox_uniforms,
    run_blocks,
    seed_base,
)

# Launches of the CUDA kernel through fused_pt_step_cuda since the count was
# last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family
# (ops/pallas/tempering_fused.py:311).
MAX_STEPS_PER_KERNEL = 16
# Shared memory the kernel keeps for its block reduction.
STATIC_RESERVE = 1024
# The main variant's window: threads a block, warps of owned chains.
WINDOW = 256


def host_draws(gen: torch.Generator, pos_shape, fit_shape, device):
    """The kernel's host-RNG operands ``(r_n, r_acc, r_swap)``, in the JAX
    package's order (``tempering_fused.host_draws``), from ``gen``."""
    return (torch.randn(pos_shape, generator=gen, device=device),
            torch.rand(fit_shape, generator=gen, device=device),
            torch.rand(fit_shape, generator=gen, device=device))


def halo(k_steps: int, swap_every: int) -> int:
    """The most exchange rounds ``k_steps`` steps can hold, whatever the
    iteration they start from: the lanes a block stages on each side of
    its own (csrc/tempering_fused.cu)."""
    return -(-k_steps // swap_every)


def kernel_block(dim: int, halo_lanes: int = 4) -> int:
    """Lanes a block of the kernel's first version owns: the largest of
    128, 64 and 32 whose buffers fit a block's shared memory (two
    ``[D][W]`` tiles, the window's positions and candidates, W the block
    and its halos rounded up to a warp; the ``[D][block]`` running bests;
    three ``[W]`` rows), or 0."""
    def shared(block):
        return first_bytes(dim, block, halo_lanes) + STATIC_RESERVE
    return family.pick_block(shared)


def first_bytes(dim: int, own: int, halo_lanes: int) -> int:
    """Dynamic shared memory of a first-version block owning ``own``
    lanes."""
    w = ceil_to(own + 2 * halo_lanes, 32)
    return (2 * w + own) * dim * 4 + 3 * w * 4


class PtGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    variant: int    # 0: warps filled with owned chains; 1: the first version
    window: int     # threads a block: the own lanes and their halos
    own: int        # lanes of a tile a block owns (the last block fewer)
    shared: int     # dynamic shared memory a block, bytes


def main_bytes(dim: int) -> int:
    """Shared memory of a main-variant block: two ``[D][256]`` planes of
    positions and candidates; the warps' running bests ``[D][8]``; four
    ``[256]`` rows (fitness, inverse temperature, swap uniform, the plane
    that holds each lane's position)."""
    return 4 * (2 * dim * WINDOW + dim * (WINDOW // 32) + 4 * WINDOW)


def pt_geometry(dim: int, halo_lanes: int) -> PtGeometry:
    """Windows of 256 threads owning 256 - 2h lanes where their two planes
    fit (D <= 109); wider, the first version
    (:func:`candidate_tile_geometry`)."""
    shared = main_bytes(dim)
    own = WINDOW - 2 * halo_lanes
    if own <= 0 or shared + STATIC_RESERVE > family.MAX_SHARED_BYTES:
        return candidate_tile_geometry(dim, halo_lanes)
    return PtGeometry(0, WINDOW, own, shared)


def candidate_tile_geometry(dim: int, halo_lanes: int) -> PtGeometry:
    """The first version at any D of the envelope: the block from
    :func:`kernel_block` (own 0 where none fits)."""
    own = kernel_block(dim, halo_lanes)
    return PtGeometry(1, ceil_to(own + 2 * halo_lanes, 32), own,
                      first_bytes(dim, own, halo_lanes))


def pt_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and a D whose buffers fit at 32 lanes and the widest halo (D <= 360).
    The name is the JAX package's."""
    return family.family_supported(
        objective_name, dtype, dim,
        lambda d: kernel_block(d, MAX_STEPS_PER_KERNEL))


def device_draws(seed, n, d, step):
    """One step's draws of the kernel: ``(noise, u_acc, u_swap)``."""
    noise, _ = normal_pair(philox_uniforms(seed, n, d, step, 0),
                           philox_uniforms(seed, n, d, step, 1))
    rows = philox_uniforms(seed, n, 2, step, 2)
    return noise, rows[0:1], rows[1:2]


def pt_steps_plain(scalars, pos, fit, sigma, beta, draws, objective_name,
                   half_width, swap_every, tile_n, k_steps, step0,
                   counts=None):
    """``k_steps`` steps on ``[D, N]``; ``draws is None`` draws from Philox.
    Returns (pos, fit, best_fit [1, 1], best_pos [D, 1]); ``counts`` (a
    dict) collects each step's accepted moves and swaps."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    n_tiles = n // tile_n
    seed, it0, n_real = scalars[0:1], scalars[1], scalars[2]
    gcol = torch.arange(n, device=pos.device)[None, :]
    col = gcol % tile_n
    tiles = lambda x: x.reshape(x.shape[0], n_tiles, tile_n)  # noqa: E731
    rb_fit, rb_pos = fit, pos
    for step in range(k_steps):
        noise, u_acc, u_swap = (device_draws(seed, n, d, step0 + step)
                                if draws is None else draws)
        # Metropolis move.
        cand = torch.clamp(pos + sigma * noise, -half_width, half_width)
        cand_fit = objective_t(cand)
        acc = u_acc < exp_fast(torch.clamp((fit - cand_fit) * beta,
                                           max=0.0))
        pos = torch.where(acc, cand, pos)
        fit = torch.where(acc, cand_fit, fit)
        better = fit < rb_fit
        rb_fit = torch.where(better, fit, rb_fit)
        rb_pos = torch.where(better, pos, rb_pos)

        # Replica exchange between adjacent lanes of a tile.
        it = it0 + (step + 1)
        do_round = (it % swap_every) == 0
        parity = (it // swap_every) % 2
        is_lower = ((col - parity) % 2) == 0
        partner_g = torch.where(is_lower, gcol + 1, gcol - 1)
        valid = (((parity == 0) | ((col >= 1) & (col <= tile_n - 2)))
                 & (gcol < n_real) & (partner_g < n_real)
                 & (partner_g >= 0))
        right = lambda x: roll_lanes(tiles(x), tile_n - 1)  # noqa: E731
        left = lambda x: roll_lanes(tiles(x), 1)  # noqa: E731
        p_fit = torch.where(is_lower, right(fit), left(fit))
        p_beta = torch.where(is_lower, right(beta), left(beta))
        u_pair = torch.where(is_lower, u_swap, left(u_swap))
        delta = (beta - p_beta) * (fit - p_fit)
        do_swap = do_round & valid & (
            u_pair < exp_fast(torch.clamp(delta, max=0.0)))
        pos = torch.where(do_swap, torch.where(is_lower, right(pos),
                                               left(pos)), pos)
        fit = torch.where(do_swap, p_fit, fit)
        if counts is not None:
            counts.setdefault("accepted", []).append(acc.sum())
            counts.setdefault("swapped", []).append(do_swap.sum())

    # The least running best, the lowest column on ties; its -0
    # coordinates made +0, as the TPU kernel's masked sum makes them.
    j = torch.argmin(rb_fit[0]).reshape(1)
    return (pos, fit, rb_fit.index_select(1, j),
            rb_pos.index_select(1, j) + 0.0)


def _check(rng, draws, k_steps, tile_n, n):
    family.check_rng(rng, draws, k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")
    if tile_n % 2:
        raise ValueError(f"tile_n ({tile_n}) must be even: the exchange "
                         "pairs lanes within a tile")


def fused_pt_step_plain(
    scalars, pos, fit, sigma, beta, r_n=None, r_acc=None, r_swap=None, *,
    objective_name: str, half_width: float = 5.12,
    swap_every: int = SWAP_EVERY, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_pt_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`pt_steps_plain`)."""
    draws = (r_n, r_acc, r_swap)
    _check(rng, draws, k_steps, tile_n, pos.shape[1])
    return pt_steps_plain(scalars, pos, fit, sigma, beta,
                          draws if rng == "host" else None, objective_name,
                          half_width, swap_every, tile_n, k_steps, step0,
                          counts)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("tempering_fused", "dsa_pt_fused_f32", 12,
                          [i, i, i, i, ctypes.c_uint, i, i, i, fl]
                          + [i] * 4)
    return _fn


def fused_pt_step_cuda(
    scalars, pos, fit, sigma, beta, r_n=None, r_acc=None, r_swap=None, *,
    objective_name: str, half_width: float = 5.12,
    swap_every: int = SWAP_EVERY, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused PT steps on ``pos`` [D, N]
    and ``fit``, ``sigma``, ``beta`` [1, N] (f32, contiguous, one CUDA
    device; N a multiple of the even ``tile_n``).  ``scalars`` is [3] int32
    on the device: the seed, the iteration before the launch and the real
    (unpadded) chain count; ``step0`` is the global index of the launch's
    first step.  Returns new tensors ``(pos, fit, best_fit [1, 1],
    best_pos [D, 1])`` without waiting for the kernel: the best is the
    least fitness any lane visited during the launch (each block writes its
    own; the first of equal minima wins)."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    draws = (r_n, r_acc, r_swap)
    _check(rng, draws, k_steps, tile_n, n)
    if rng == "device":
        r_n = r_acc = r_swap = None
    family.check_operands(
        "fused_pt_step_cuda", scalars, 3, pos,
        dict(fit=(fit, (1, n)), sigma=(sigma, (1, n)), beta=(beta, (1, n)),
             r_n=(r_n, (d, n)), r_acc=(r_acc, (1, n)),
             r_swap=(r_swap, (1, n))))
    h = halo(k_steps, swap_every)
    if kernel_block(d, h) == 0:
        raise ValueError(
            f"fused_pt_step_cuda: D = {d} is outside the kernel's envelope "
            f"(its buffers at 32 lanes and a halo of {h} must fit "
            f"{family.MAX_SHARED_BYTES} bytes of shared memory)")
    geo = pt_geometry(d, h)
    blocks = (n // tile_n) * -(-tile_n // geo.own)
    pos_out, fit_out = torch.empty_like(pos), torch.empty_like(fit)
    block_fit = torch.empty(blocks, dtype=torch.float32, device=pos.device)
    block_pos = torch.empty((d, blocks), dtype=torch.float32,
                            device=pos.device)
    err = _kernel()(
        scalars.data_ptr(), pos.data_ptr(), fit.data_ptr(),
        sigma.data_ptr(), beta.data_ptr(),
        *(family.ptr(r) for r in (r_n, r_acc, r_swap)),
        pos_out.data_ptr(), fit_out.data_ptr(), block_fit.data_ptr(),
        block_pos.data_ptr(), n, d, int(tile_n),
        int(k_steps), int(step0) & _MASK32, OBJECTIVE_IDS[objective_name],
        int(swap_every), h, float(half_width), *geo,
        *family.stream_args(pos),
    )
    family.check_launch(err, "pt")
    LAUNCHES += 1
    j = torch.argmin(block_fit).reshape(1)
    return (pos_out, fit_out, block_fit.index_select(0, j).reshape(1, 1),
            block_pos.index_select(1, j) + 0.0)


def fused_pt_step_t(scalars, pos, fit, sigma, beta, r_n=None, r_acc=None,
                    r_swap=None, **kw) -> Tuple[torch.Tensor, ...]:
    """``k_steps`` fused PT steps: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors (see :func:`fused_pt_step_cuda`)."""
    step = (fused_pt_step_plain if pos.device.type == "cpu"
            else fused_pt_step_cuda)
    return step(scalars, pos, fit, sigma, beta, r_n, r_acc, r_swap, **kw)


def fused_pt_run(
    state: PTState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    sigma0: float = SIGMA0,
    swap_every: int = SWAP_EVERY,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 16,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
) -> PTState:
    """``n_steps`` fused PT steps with no read from the device: PTState in,
    PTState out, the fast path beside ``ops.tempering.pt_run`` with the
    tile-local exchange.  The ladder (``state.temps``) lies along the lanes
    as the portable path orders it; the swarm pads cyclically to a whole
    number of tiles (no shrinking), and the padding never exchanges.  At
    most 16 steps go in a launch.  ``rng="host"`` runs one step per launch
    with ``uniforms[i] = (r_n, r_acc, r_swap)`` for launch i, or with draws
    from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported(
        "pt", objective_name, state.pos.dtype, d,
        lambda dim: kernel_block(dim, MAX_STEPS_PER_KERNEL), 360)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    steps_per_kernel = min(steps_per_kernel, MAX_STEPS_PER_KERNEL)
    tile_n, n_pad = family.lane_tiling(n, tile_n, d)
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    temps_t = cyclic_pad_rows(state.temps, n_pad)[None, :].contiguous()
    sigma_t = (sigma0 * half_width) * torch.sqrt(temps_t)
    beta_t = rdiv(1.0, temps_t)
    seed = seed_base(state.gen, dev)
    n_real = torch.full((1,), n, dtype=torch.int32, device=dev)

    def block(carry, call_i, k):
        pos_t, fit_t, best_pos, best_fit, it = carry
        draws = (None,) * 3
        if rng == "host":
            draws = (uniforms[call_i] if uniforms is not None else
                     host_draws(state.gen, pos_t.shape, fit_t.shape, dev))
        pos_t, fit_t, blk_fit, blk_pos = fused_pt_step_t(
            family.block_scalars(seed, it, n_real), pos_t, fit_t, sigma_t,
            beta_t, *draws, objective_name=objective_name,
            half_width=half_width, swap_every=swap_every, tile_n=tile_n,
            rng=rng, k_steps=k, step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(blk_fit[0, 0], blk_pos[:, 0],
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit, it + k)

    pos_t, fit_t, best_pos, best_fit, _ = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32), state.iteration),
        n_steps, steps_per_kernel)
    return PTState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        temps=state.temps,
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
