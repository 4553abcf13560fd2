"""Fused genetic-algorithm generations: ``k_steps`` GA generations in one
pass, each tile kept in step at every generation.

Replaces the TPU kernel ``ops/pallas/ga_fused.py:fused_ga_step_t`` of the
JAX package.

- :func:`fused_ga_step_cuda` launches the hand-written CUDA kernel
  ``csrc/ga_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_ga_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_ga_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

Per generation, for lane j of tile i (the JAX package's deltas from
``ops/ga.py``): parent A is the better of two lane rolls of the tile's
*current* generation, parent B the better of two rolls of the block-start
tiles ``i + ts_a`` and ``i + ts_b``; one child per lane from SBX (c1 or c2
by a lane gate, else parent A) and polynomial mutation, the powers through
the bit-field ``log2`` and ``2^x`` polynomials; then the tile's best
current individual replaces its worst child where strictly better.  So
every lane of a tile reads the whole tile's previous generation, and the
kernel keeps a tile in step: across a thread-block cluster whose blocks
hold two generations of the tile in shared memory for the whole launch,
or, where they do not fit 16 blocks, in one block through global scratch
(:func:`ga_geometry` picks; the kernel's entry checks).  The cluster
variant raises beta and delta once a draw on a selected argument, crosses
with selected coefficients and follows the elite from generation to
generation without a rescan; each gives the plain version's bits
(``tests/test_torch_ga_geometry.py`` holds PyTorch models of these forms
against :func:`sbx_beta`, :func:`mutation_delta`, :func:`sbx_child` and
``torch.argmin``).

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed, the
SBX, mutation and mutation-test uniforms on streams 0, 1 and 2 over the
dimensions, counter (lane, block of four dimensions, global step, stream);
the lane gate is word 0 of the call (lane, 0, global step, 3).
``rng="host"`` takes them as operands (one step per call) in the JAX
package's order ``(r_sbx, r_gate, r_mut, r_do)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .._numerics import rdiv
from ..ga import GAState
from ..nsga2 import ETA_C, ETA_M, P_CROSS
from . import family
from .common import cyclic_pad_rows
from .fast_math import LOG2_C, exp2_fast, log2_fast  # noqa: F401
from .family import LANE_SHIFTS, TileGeometry, donor_tiles, roll_lanes
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

# Launches of the CUDA kernel through fused_ga_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family
# (ops/pallas/ga_fused.py:318).
MAX_STEPS_PER_KERNEL = 8
# Threads of the block that runs one tile in the global-scratch variant
# (each holds tile_n / 512 lanes).
TILE_THREADS = 512
# The cluster variant's slots a block, in 4-byte words: each warp's (max,
# lane) and (min, lane) for up to 16 warps, two inboxes of every block's
# (max, lane, min, lane) for up to 16 blocks, the block's six constants
# (the snapshot tiles, the lane shifts, the seed) and the elite of
# generations of each parity.
CLUSTER_SLOT_WORDS = (4 * (family.CLUSTER_MAX_LANES // 32)
                      + 2 * 4 * max(family.CLUSTER_SIZES) + 6 + 4)


def pow_fast(x: torch.Tensor, inv_eta: float) -> torch.Tensor:
    """x^inv_eta for x > 0 via 2^(inv_eta log2 x)."""
    return exp2_fast(inv_eta * log2_fast(x))


def host_draws(gen: torch.Generator, pos_shape, fit_shape, device):
    """The kernel's host-RNG operands ``(r_sbx, r_gate, r_mut, r_do)``, in
    the JAX package's order (``ga_fused.host_draws``), from ``gen``."""
    u = lambda s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    return u(pos_shape), u(fit_shape), u(pos_shape), u(pos_shape)


# --------------------------------------------------------------------------
# The step: plain version, kernel wrapper, entry
# --------------------------------------------------------------------------


def ga_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32 and michalewicz within its phase
    bound.  D is free: a tile too large for a cluster runs through global
    scratch.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, lambda d: 1)


def tile_threads(tile_n: int) -> int:
    """Threads of the block that runs one tile through global scratch: 512,
    or the tile rounded up to a warp where it is smaller."""
    return min(TILE_THREADS, -(-tile_n // 32) * 32)


def cluster_bytes(dim: int, lanes: int) -> int:
    """Shared memory of a cluster block of ``lanes`` lanes: two generations
    of their positions and fitness, then the reduction slots."""
    return 4 * (2 * dim * lanes + 2 * lanes + CLUSTER_SLOT_WORDS)


def ga_geometry(dim: int, tile_n: int) -> TileGeometry:
    """The smallest cluster whose blocks, ``ceil(tile_n / cluster)`` lanes
    each, at most 256 (else 512), hold two generations of their lanes
    within a block's shared memory (16 blocks of 256 lanes at 4,096 x 30);
    where none does (an explicit tile above 8,192 lanes, a tile of 8,192
    past D = 55, or D past 3,618 at the smallest tile), one block a tile
    through global scratch."""
    return (family.cluster_geometry(tile_n,
                                    lambda lanes: cluster_bytes(dim, lanes))
            or global_geometry(dim, tile_n))


def global_geometry(dim: int, tile_n: int) -> TileGeometry:
    """The global-scratch variant (the first version) at any shape: one
    block a tile."""
    return TileGeometry(1, 1, tile_n, tile_threads(tile_n), 0)


def _constants(half_width, eta_c, eta_m, p_cross, p_mut):
    """The scalars both versions take, rounded to f32 from Python's
    doubles as the JAX package's weak-typed literals are."""
    return dict(inv_c=1.0 / (eta_c + 1.0), inv_m=1.0 / (eta_m + 1.0),
                cross_lo=0.5 * p_cross, cross_hi=p_cross, p_mut=p_mut,
                width=2.0 * half_width)


def sbx_beta(u, inv_c):
    """SBX's spread factor, the plain version's two arms."""
    return torch.where(
        u <= 0.5, pow_fast(2.0 * u + 1e-12, inv_c),
        pow_fast(rdiv(1.0, 2.0 * (1.0 - u) + 1e-12), inv_c))


def mutation_delta(um, inv_m):
    """The polynomial mutation's step, the plain version's two arms."""
    return torch.where(
        um < 0.5, pow_fast(2.0 * um + 1e-12, inv_m) - 1.0,
        1.0 - pow_fast(2.0 * (1.0 - um) + 1e-12, inv_m))


def sbx_child(beta, uc, parent_a, parent_b, cross_lo, cross_hi):
    """The crossover's child, the plain version's three arms: c1 where
    ``uc < cross_lo``, c2 where ``uc < cross_hi``, else parent A."""
    c1 = 0.5 * ((1.0 + beta) * parent_a + (1.0 - beta) * parent_b)
    c2 = 0.5 * ((1.0 - beta) * parent_a + (1.0 + beta) * parent_b)
    return torch.where(uc < cross_lo, c1,
                       torch.where(uc < cross_hi, c2, parent_a))


def tally_needed(counts, mutates, crossing):
    """Add one generation's data-dependent work to ``counts``: ``mutates``
    is the ``[D, N]`` mask of mutating elements, ``crossing`` the lanes'
    crossover mask (``N`` elements)."""
    d, n = mutates.shape
    groups = torch.nn.functional.pad(mutates, (0, 0, 0, -d % 4))
    held = groups.reshape(-1, 4, n).any(dim=1)
    sizes = (d - 4 * torch.arange(held.shape[0], device=mutates.device)
             ).clamp(max=4)
    for key, v in (("mutated", mutates.sum()),
                   ("mutating_group_elements", (held.sum(1) * sizes).sum()),
                   ("crossing_elements", crossing.sum() * d)):
        counts.setdefault(key, []).append(v)


def ga_steps_plain(scalars, pos, fit, draws, objective_name, half_width,
                   consts, tile_n, k_steps, step0, counts=None):
    """``k_steps`` generations on ``[D, N]``; ``draws is None`` draws from
    Philox.  ``counts`` (a dict) collects, for each generation, the work
    that depends on the data: the mutating elements (``ud < p_mut``), the
    elements of the groups of four dimensions (4 q .. 4 q + 3, a Philox
    call's words) that hold one, and the elements of the crossing lanes
    (``uc < cross_hi``)."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    n_tiles = n // tile_n
    seed = scalars[0:1]
    dl1, dl2, dl3 = (scalars[k].long() for k in (3, 4, 5))
    snap_a, fit_a = (donor_tiles(x, tile_n, scalars[1]) for x in (pos, fit))
    snap_b, fit_b = (donor_tiles(x, tile_n, scalars[2]) for x in (pos, fit))
    inv_c, inv_m = consts["inv_c"], consts["inv_m"]
    lanes = torch.arange(tile_n, device=pos.device)
    for step in range(k_steps):
        la, lc, le = LANE_SHIFTS[step % len(LANE_SHIFTS)]
        cur = pos.reshape(d, n_tiles, tile_n)
        cur_f = fit.reshape(1, n_tiles, tile_n)
        # Parent A: the within-tile tournament over the current generation.
        o1, f1 = roll_lanes(cur, dl1 + la), roll_lanes(cur_f, dl1 + la)
        o2, f2 = roll_lanes(cur, dl2 + lc), roll_lanes(cur_f, dl2 + lc)
        parent_a = torch.where(f1 <= f2, o1, o2)
        # Parent B: the cross-tile tournament over the block-start tiles.
        b1, g1 = roll_lanes(snap_a, dl3 + le), roll_lanes(fit_a, dl3 + le)
        b2, g2 = roll_lanes(snap_b, dl1 + le), roll_lanes(fit_b, dl1 + le)
        parent_b = torch.where(g1 <= g2, b1, b2)

        if draws is None:
            u, um, ud = (philox_uniforms(seed, n, d, step0 + step, s)
                         for s in range(3))
            uc = philox_uniforms(seed, n, 1, step0 + step, 3)
        else:
            u, uc, um, ud = draws
        beta = sbx_beta(u, inv_c)
        child = sbx_child(beta, uc, parent_a, parent_b, consts["cross_lo"],
                          consts["cross_hi"])
        delta = mutation_delta(um, inv_m)
        mutates = ud < consts["p_mut"]
        child = child + torch.where(mutates, delta * consts["width"],
                                    torch.zeros_like(delta))
        if counts is not None:
            tally_needed(counts, mutates, uc < consts["cross_hi"])
        child = torch.clamp(child, -half_width, half_width)
        cfit = objective_t(child)

        # Per-tile elitism: the tile's best current individual (its -0
        # coordinates made +0, as the JAX kernel's masked sum makes them)
        # replaces the tile's worst child where strictly better.
        ft = fit.reshape(n_tiles, tile_n)
        jb = torch.argmin(ft, dim=1)
        elite_fit = ft.gather(1, jb[:, None])
        elite_pos = cur.gather(2, jb[None, :, None].expand(d, -1, 1)) + 0.0
        cf = cfit.reshape(n_tiles, tile_n)
        jw = torch.argmax(cf, dim=1)
        rep = (lanes[None, :] == jw[:, None]) & (elite_fit
                                                  < cf.gather(1, jw[:, None]))
        pos = torch.where(rep[None], elite_pos,
                          child.reshape(d, n_tiles, tile_n)).reshape(d, n)
        fit = torch.where(rep, elite_fit, cf).reshape(1, n)
    return pos, fit


def _check(rng, draws, k_steps, tile_n, n):
    family.check_rng(rng, draws, k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_ga_step_plain(
    scalars, pos, fit, r_sbx=None, r_gate=None, r_mut=None, r_do=None, *,
    objective_name: str, half_width: float = 5.12, eta_c: float = ETA_C,
    eta_m: float = ETA_M, p_cross: float = P_CROSS,
    p_mut: float = 1.0 / 30.0, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_ga_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`ga_steps_plain`)."""
    draws = (r_sbx, r_gate, r_mut, r_do)
    _check(rng, draws, k_steps, tile_n, pos.shape[1])
    return ga_steps_plain(scalars, pos, fit,
                          draws if rng == "host" else None, objective_name,
                          half_width,
                          _constants(half_width, eta_c, eta_m, p_cross,
                                     p_mut),
                          tile_n, k_steps, step0, counts)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("ga_fused", "dsa_ga_fused_f32", 11,
                          [i, i, i, i, ctypes.c_uint, i] + [fl] * 7
                          + [i] * 5)
    return _fn


def fused_ga_step_cuda(
    scalars, pos, fit, r_sbx=None, r_gate=None, r_mut=None, r_do=None, *,
    objective_name: str, half_width: float = 5.12, eta_c: float = ETA_C,
    eta_m: float = ETA_M, p_cross: float = P_CROSS,
    p_mut: float = 1.0 / 30.0, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused GA generations on ``pos``
    [D, N] and ``fit`` [1, N] (f32, contiguous, one CUDA device; N a
    multiple of ``tile_n``), a tile as :func:`ga_geometry` says.
    ``scalars`` is [6] int32 on the device: the seed, the two parent-B tile
    shifts and the three lane shifts; ``step0`` is the global index of the
    launch's first step.  Returns new tensors ``(pos, fit)`` without
    waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    draws = (r_sbx, r_gate, r_mut, r_do)
    _check(rng, draws, k_steps, tile_n, n)
    if rng == "device":
        r_sbx = r_gate = r_mut = r_do = None
    family.check_operands(
        "fused_ga_step_cuda", scalars, 6, pos,
        dict(fit=(fit, (1, n)), r_sbx=(r_sbx, (d, n)),
             r_gate=(r_gate, (1, n)), r_mut=(r_mut, (d, n)),
             r_do=(r_do, (d, n))))
    geo = ga_geometry(d, int(tile_n))
    pos_out = torch.empty_like(pos)
    fit_out = torch.empty_like(fit)
    scratch_pos = scratch_fit = None
    if geo.variant == 1:
        # The generations between the first and the last ping-pong between
        # the outputs and one scratch pair.
        scratch_pos = torch.empty_like(pos) if k_steps > 1 else pos_out
        scratch_fit = torch.empty_like(fit) if k_steps > 1 else fit_out
    c = _constants(half_width, eta_c, eta_m, p_cross, p_mut)
    err = _kernel()(
        scalars.data_ptr(), pos.data_ptr(), fit.data_ptr(),
        *(family.ptr(r) for r in (r_sbx, r_gate, r_mut, r_do)),
        pos_out.data_ptr(), fit_out.data_ptr(), family.ptr(scratch_pos),
        family.ptr(scratch_fit), n, d, int(tile_n), int(k_steps),
        int(step0) & _MASK32, OBJECTIVE_IDS[objective_name],
        float(half_width), *(float(c[k]) for k in (
            "inv_c", "inv_m", "cross_lo", "cross_hi", "p_mut", "width")),
        *geo, *family.stream_args(pos),
    )
    family.check_launch(err, "ga")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_ga_step_t(scalars, pos, fit, r_sbx=None, r_gate=None, r_mut=None,
                    r_do=None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k_steps`` fused GA generations: the plain version on CPU tensors,
    the CUDA kernel on CUDA tensors (see :func:`fused_ga_step_cuda`)."""
    step = (fused_ga_step_plain if pos.device.type == "cpu"
            else fused_ga_step_cuda)
    return step(scalars, pos, fit, r_sbx, r_gate, r_mut, r_do, **kw)


def fused_ga_run(
    state: GAState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    eta_c: float = ETA_C,
    eta_m: float = ETA_M,
    p_cross: float = P_CROSS,
    p_mut: Optional[float] = None,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
    shifts: Optional[torch.Tensor] = None,
) -> GAState:
    """``n_steps`` fused GA generations with no read from the device:
    GAState in, GAState out, the fast path beside ``ops.ga.ga_run`` with
    rotational tournaments and per-tile elitism.  At most 8 steps go in a
    launch; at least 4 tiles are needed.

    ``shifts`` [n_launches, 5] int32 gives each launch's two tile shifts
    and three lane shifts; by default they are drawn from ``state.gen`` on
    the device.  ``rng="host"`` runs one step per launch with
    ``uniforms[i] = (r_sbx, r_gate, r_mut, r_do)`` for launch i, or with
    draws from ``state.gen``."""
    n, d = state.pos.shape
    if not ga_pallas_supported(objective_name, state.pos.dtype, d):
        raise ValueError(
            f"the fused ga kernel does not cover objective "
            f"{objective_name!r} with {state.pos.dtype} state at D = {d}: "
            f"it takes a named objective of {sorted(OBJECTIVES_T)}, float32 "
            f"state (michalewicz: D <= {family.MICHALEWICZ_DIM_MAX})")
    if p_mut is None:
        p_mut = 1.0 / d
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
        pos_t, fit_t = fused_ga_step_t(
            torch.cat([seed, launch]), pos_t, fit_t, *draws,
            objective_name=objective_name, half_width=half_width,
            eta_c=eta_c, eta_m=eta_m, p_cross=p_cross, p_mut=p_mut,
            tile_n=tile_n, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(*best_of_block(fit_t, pos_t),
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit)

    pos_t, fit_t, best_pos, best_fit = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32)),
        n_steps, steps_per_kernel)
    return GAState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
