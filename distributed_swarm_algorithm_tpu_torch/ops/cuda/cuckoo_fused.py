"""Fused cuckoo-search generations: ``k_steps`` generations in one pass,
each tile kept in step at every generation.

Replaces the TPU kernel ``ops/pallas/cuckoo_fused.py:fused_cuckoo_step_t``
of the JAX package.

- :func:`fused_cuckoo_step_cuda` launches the hand-written CUDA kernel
  ``csrc/cuckoo_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_cuckoo_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_cuckoo_step_t` is the entry: the plain version for CPU
  tensors, the kernel for CUDA tensors.  Nothing falls back.

Per generation, for lane j of tile i (the JAX package's deltas from
``ops/cuckoo.py``): a Levy flight ``sigma n1 / |n2|^(1/beta)`` toward the
block-start best gives each lane a candidate; lane j takes the egg of lane
``j - (l_egg + sa)`` of the tile's *current* candidates where it is
strictly better (a bijective egg drop, so no conflict); then each lane
with ``u_ab < pa`` is rebuilt by a walk ``u (x1 - x2)`` over lane rolls of
the block-start tiles ``i + s1`` and ``i + s2`` (the two tile shifts need
not differ).  The egg roll reads the whole tile's candidates of the same
generation, so the kernel keeps a tile in step: across a thread-block
cluster whose blocks hold the tile's state in shared memory for the whole
launch, or, where that state does not fit 16 blocks, in one block through
global scratch (:func:`cuckoo_geometry` picks; the kernel's entry checks).

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed; the
Box-Muller pair's two uniforms on streams 0 and 1 and the walk's on
stream 2, over the dimensions, counter (lane, block of four dimensions,
global step, stream); ``u_ab`` is word 0 of the call (lane, 0, global step,
3).  n1 and n2 are the cosine and the sine half of one pair.
``rng="host"`` takes ``(r_levy1, r_levy2, r_ab, r_walk)`` as operands
(one step per call), the JAX package's order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..cuckoo import LEVY_BETA, PA, STEP_SCALE, CuckooState, mantegna_sigma
from . import family
from .common import ceil_to, cyclic_pad_rows
from .family import (  # noqa: F401 (the cluster sizes, for the tests)
    CLUSTER_MAX_LANES,
    CLUSTER_SIZES,
    LANE_SHIFTS,
    TileGeometry as CuckooGeometry,
    donor_tiles,
    roll_lanes,
)
from .fast_math import levy_power, normal_pair
from .ga_fused import tile_threads
from .pso_fused import (
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    best_of_block,
    merge_best,
    philox_uniforms,
    run_blocks,
    seed_base,
)

# Launches of the CUDA kernel through fused_cuckoo_step_cuda since the
# count was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family
# (ops/pallas/cuckoo_fused.py:297).
MAX_STEPS_PER_KERNEL = 8


def cluster_bytes(dim: int, lanes: int) -> int:
    """Shared memory of a cluster block of ``lanes`` lanes: positions, a
    generation's candidates and their fitness, and the best."""
    return 4 * (2 * dim * lanes + lanes + ceil_to(dim, 4))


def cuckoo_geometry(dim: int, tile_n: int) -> CuckooGeometry:
    """The smallest cluster whose blocks, ``ceil(tile_n / cluster)`` lanes
    each, at most 256 (else 512), hold a tile's state within a block's
    shared memory; where none does (an explicit tile above 8,192 lanes, or
    D above ~3,500), one block a tile through global scratch.  Three blocks
    of 256 lanes fit an SM at D = 30."""
    return (family.cluster_geometry(tile_n,
                                    lambda lanes: cluster_bytes(dim, lanes))
            or global_geometry(dim, tile_n))


def global_geometry(dim: int, tile_n: int) -> CuckooGeometry:
    """The global-scratch variant (the first version) at any shape: one
    block a tile."""
    return CuckooGeometry(1, 1, tile_n, tile_threads(tile_n), 0)


def host_draws(gen: torch.Generator, pos_shape, fit_shape, device):
    """The kernel's host-RNG operands ``(r_levy1, r_levy2, r_ab, r_walk)``,
    in the JAX package's order (``cuckoo_fused.host_draws``), from
    ``gen``."""
    return (torch.randn(pos_shape, generator=gen, device=device),
            torch.randn(pos_shape, generator=gen, device=device),
            torch.rand(fit_shape, generator=gen, device=device),
            torch.rand(pos_shape, generator=gen, device=device))


def cuckoo_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32 and michalewicz within its phase
    bound.  D is free: a tile too large for a cluster runs through global
    scratch.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, lambda d: 1)


def levy_flight(pos, best, n1, n2, sigma, step_scale, beta, half_width):
    """The candidates ``clip(x + step_scale levy (x - best))`` with
    ``levy = sigma n1 2^(-log2(|n2| + 1e-12) / beta)``."""
    levy = sigma * n1 * levy_power(n2, 1.0 / beta)
    return torch.clamp(pos + step_scale * levy * (pos - best), -half_width,
                       half_width)


def device_draws(seed, n, d, step):
    """One step's draws of the kernel: ``(n1, n2, u_ab, u_walk)``."""
    n1, n2 = normal_pair(philox_uniforms(seed, n, d, step, 0),
                         philox_uniforms(seed, n, d, step, 1))
    return (n1, n2, philox_uniforms(seed, n, 1, step, 3),
            philox_uniforms(seed, n, d, step, 2))


def cuckoo_steps_plain(scalars, best, pos, fit, draws, objective_name,
                       half_width, pa, step_scale, beta, tile_n, k_steps,
                       step0, counts=None):
    """``k_steps`` generations on ``[D, N]``; ``draws is None`` draws from
    Philox.  ``counts`` (a dict) collects each generation's abandoned
    lanes, the work that depends on the data."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    n_tiles = n // tile_n
    seed = scalars[0:1]
    snap1 = donor_tiles(pos, tile_n, scalars[1])
    snap2 = donor_tiles(pos, tile_n, scalars[2])
    l_egg, l_p1, l_p2 = (scalars[k].long() for k in (3, 4, 5))
    sigma = mantegna_sigma(beta)
    for step in range(k_steps):
        sa, sb, sc = LANE_SHIFTS[step % len(LANE_SHIFTS)]
        n1, n2, u_ab, u_walk = (device_draws(seed, n, d, step0 + step)
                                if draws is None else draws)
        # 1. Levy flights and the egg drop over the tile's candidates.
        cand = levy_flight(pos, best, n1, n2, sigma, step_scale, beta,
                           half_width)
        cand_fit = objective_t(cand)
        egg = roll_lanes(cand.reshape(d, n_tiles, tile_n), l_egg + sa)
        egg_fit = roll_lanes(cand_fit.reshape(1, n_tiles, tile_n),
                             l_egg + sa)
        accept = egg_fit < fit
        pos = torch.where(accept, egg, pos)
        fit = torch.where(accept, egg_fit, fit)
        # 2. Abandonment: a walk over rolled block-start peers.
        x1 = roll_lanes(snap1, l_p1 + sb)
        x2 = roll_lanes(snap2, l_p2 + sc)
        fresh = torch.clamp(pos + u_walk * (x1 - x2), -half_width,
                            half_width)
        abandon = u_ab < pa
        pos = torch.where(abandon, fresh, pos)
        fit = torch.where(abandon, objective_t(fresh), fit)
        if counts is not None:
            counts.setdefault("abandoned", []).append(abandon.sum())
    return pos, fit


def _check(rng, draws, k_steps, tile_n, n):
    family.check_rng(rng, draws, k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_cuckoo_step_plain(
    scalars, best_pos, pos, fit, r_levy1=None, r_levy2=None, r_ab=None,
    r_walk=None, *, objective_name: str, half_width: float = 5.12,
    pa: float = PA, step_scale: float = STEP_SCALE,
    levy_beta: float = LEVY_BETA, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_cuckoo_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`cuckoo_steps_plain`)."""
    draws = (r_levy1, r_levy2, r_ab, r_walk)
    _check(rng, draws, k_steps, tile_n, pos.shape[1])
    return cuckoo_steps_plain(scalars, best_pos, pos, fit,
                              draws if rng == "host" else None,
                              objective_name, half_width, pa, step_scale,
                              levy_beta, tile_n, k_steps, step0, counts)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("cuckoo_fused", "dsa_cuckoo_fused_f32", 14,
                          [i, i, i, i, ctypes.c_uint, i] + [fl] * 5
                          + [i] * 5)
    return _fn


def fused_cuckoo_step_cuda(
    scalars, best_pos, pos, fit, r_levy1=None, r_levy2=None, r_ab=None,
    r_walk=None, *, objective_name: str, half_width: float = 5.12,
    pa: float = PA, step_scale: float = STEP_SCALE,
    levy_beta: float = LEVY_BETA, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused cuckoo generations on
    ``pos`` [D, N] and ``fit`` [1, N] toward ``best_pos`` [D, 1] (f32,
    contiguous, one CUDA device; N a multiple of ``tile_n``), a tile as
    :func:`cuckoo_geometry` says.  ``scalars`` is [6] int32 on the device:
    the seed, the two peer tile shifts and the egg's and the two peers'
    lane shifts; ``step0`` is the global index of the launch's first step.
    Returns new tensors ``(pos, fit)`` without waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    draws = (r_levy1, r_levy2, r_ab, r_walk)
    _check(rng, draws, k_steps, tile_n, n)
    if rng == "device":
        r_levy1 = r_levy2 = r_ab = r_walk = None
    family.check_operands(
        "fused_cuckoo_step_cuda", scalars, 6, pos,
        dict(best_pos=(best_pos, (d, 1)), fit=(fit, (1, n)),
             r_levy1=(r_levy1, (d, n)), r_levy2=(r_levy2, (d, n)),
             r_ab=(r_ab, (1, n)), r_walk=(r_walk, (d, n))))
    geo = cuckoo_geometry(d, int(tile_n))
    pos_out, fit_out = torch.empty_like(pos), torch.empty_like(fit)
    scratch = (None,) * 4
    if geo.variant == 1:
        # The generations between the first and the last ping-pong between
        # the outputs and a scratch pair; a generation's candidates go to
        # a second pair.
        scratch = (torch.empty_like(pos) if k_steps > 1 else pos_out,
                   torch.empty_like(fit) if k_steps > 1 else fit_out,
                   torch.empty_like(pos), torch.empty_like(fit))
    err = _kernel()(
        scalars.data_ptr(), best_pos.data_ptr(), pos.data_ptr(),
        fit.data_ptr(), *(family.ptr(r) for r in (r_levy1, r_levy2, r_ab,
                                                  r_walk)),
        pos_out.data_ptr(), fit_out.data_ptr(),
        *(family.ptr(t) for t in scratch), n, d, int(tile_n), int(k_steps),
        int(step0) & _MASK32, OBJECTIVE_IDS[objective_name],
        float(half_width), float(pa), float(step_scale),
        float(mantegna_sigma(levy_beta)), float(-1.0 / levy_beta), *geo,
        *family.stream_args(pos),
    )
    family.check_launch(err, "cuckoo")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_cuckoo_step_t(scalars, best_pos, pos, fit, r_levy1=None,
                        r_levy2=None, r_ab=None, r_walk=None,
                        **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k_steps`` fused cuckoo generations: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors (see
    :func:`fused_cuckoo_step_cuda`)."""
    step = (fused_cuckoo_step_plain if pos.device.type == "cpu"
            else fused_cuckoo_step_cuda)
    return step(scalars, best_pos, pos, fit, r_levy1, r_levy2, r_ab, r_walk,
                **kw)


def fused_cuckoo_run(
    state: CuckooState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    pa: float = PA,
    step_scale: float = STEP_SCALE,
    levy_beta: float = LEVY_BETA,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
    shifts: Optional[torch.Tensor] = None,
) -> CuckooState:
    """``n_steps`` fused cuckoo generations with no read from the device:
    CuckooState in, CuckooState out, the fast path beside
    ``ops.cuckoo.cuckoo_run`` with the rotational egg drop and peers.  At
    most 8 steps go in a launch; at least 4 tiles are needed.

    ``shifts`` [n_launches, 5] int32 gives each launch's two tile shifts
    (in [1, n_tiles), not necessarily distinct) and three lane shifts; by
    default they are drawn from ``state.gen`` on the device.  ``rng="host"``
    runs one step per launch with ``uniforms[i] = (r_levy1, r_levy2, r_ab,
    r_walk)`` for launch i, or with draws from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("cuckoo", objective_name,
                                    state.pos.dtype, d, lambda _: 1)
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
                torch.randint(1, max(n_tiles, 2), (2,), generator=state.gen,
                              dtype=torch.int32, device=dev),
                torch.randint(0, tile_n, (3,), generator=state.gen,
                              dtype=torch.int32, device=dev)])
        draws = (None,) * 4
        if rng == "host":
            draws = (uniforms[call_i] if uniforms is not None else
                     host_draws(state.gen, pos_t.shape, fit_t.shape, dev))
        pos_t, fit_t = fused_cuckoo_step_t(
            torch.cat([seed, launch]), best_pos[:, None].contiguous(), pos_t,
            fit_t, *draws, objective_name=objective_name,
            half_width=half_width, pa=pa, step_scale=step_scale,
            levy_beta=levy_beta, tile_n=tile_n, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(*best_of_block(fit_t, pos_t),
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit)

    pos_t, fit_t, best_pos, best_fit = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32)),
        n_steps, steps_per_kernel)
    return CuckooState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
