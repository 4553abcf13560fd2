"""Fused artificial-bee-colony cycles: ``k_steps`` cycles in one pass, each
tile kept in step at every cycle.

Replaces the TPU kernel ``ops/pallas/abc_fused.py:fused_abc_step_t`` of the
JAX package.

- :func:`fused_abc_step_cuda` launches the hand-written CUDA kernel
  ``csrc/abc_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_abc_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_abc_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

Per cycle, for lane j of tile i (the JAX package's deltas from
``ops/abc.py``): the employed bee's partner is lane ``j - (dl1 + la)`` of
the tile's *current* sources and one dimension ``floor(u D)`` moves (none
where ``u D`` rounds to D); the onlooker gate is ``u < q / max_tile(q)``
over the tile's current quality (a Bernoulli recruitment in place of the
categorical draw, so no conflict), its partner lane ``j - (dl2 + lb)`` of
the launch's input tile ``i + s``; a source whose trials pass ``limit``
re-randomizes.  Both the partner roll and the tile's maximum read the whole
tile at every cycle, so the kernel keeps a tile in step: across a
thread-block cluster whose blocks hold the tile's sources in shared memory
for the whole launch, or, where they do not fit 16 blocks, in one block
through global scratch (:func:`abc_geometry` picks; the kernel's entry
checks).  The cluster variant takes positions inside ``+-half_width``, as
every state of a run is: a candidate's other coordinates are then its
base's, and it writes only the one that moves.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed; the
scout's plane on stream 0 over the dimensions, counter (lane, block of four
dimensions, global step, 0); the five row uniforms (employed dimension and
phi, onlooker gate, dimension and phi) are words 0-3 of the call (lane, 0,
global step, 1) and word 0 of (lane, 1, global step, 1).  ``rng="host"``
takes the JAX package's six operands (the five rows, then the plane; one
step per call).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..abc import ABCState, quality
from . import family
from .common import cyclic_pad_rows
from .family import LANE_SHIFTS, TileGeometry, donor_tiles, roll_lanes
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

# Launches of the CUDA kernel through fused_abc_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family
# (ops/pallas/abc_fused.py:268).
MAX_STEPS_PER_KERNEL = 8


def host_draws(gen: torch.Generator, pos_shape, fit_shape, device):
    """The kernel's six host-RNG operands in the JAX package's order
    (``abc_fused.host_draws``): five row uniforms (employed dimension and
    phi, onlooker gate, dimension and phi), then the scout plane."""
    u = lambda s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    return tuple(u(fit_shape) for _ in range(5)) + (u(pos_shape),)


# Warps a cluster block may hold (512 lanes), each with a slot for its
# largest quality beside the block's.
CLUSTER_WARPS = family.CLUSTER_MAX_LANES // 32


def cluster_bytes(dim: int, lanes: int) -> int:
    """Shared memory of a cluster block of ``lanes`` lanes: their sources,
    then each warp's largest quality and the block's."""
    return 4 * (dim * lanes + CLUSTER_WARPS + 1)


def abc_geometry(dim: int, tile_n: int) -> TileGeometry:
    """The smallest cluster whose blocks, ``ceil(tile_n / cluster)`` lanes
    each, at most 256 (else 512), hold their lanes' sources within a
    block's shared memory (16 blocks of 256 lanes at 4,096 x 30); where
    none does (an explicit tile above 8,192 lanes, or D above 226 at tiles
    of 4,096), one block a tile through global scratch."""
    return (family.cluster_geometry(tile_n,
                                    lambda lanes: cluster_bytes(dim, lanes))
            or global_geometry(dim, tile_n))


def global_geometry(dim: int, tile_n: int) -> TileGeometry:
    """The global-scratch variant (the first version) at any shape: one
    block a tile."""
    return TileGeometry(1, 1, tile_n, tile_threads(tile_n), 0)


def abc_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32 and michalewicz within its phase
    bound.  D is free: a tile too large for a cluster runs through global
    scratch.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, lambda d: 1)


def device_draws(seed, n, d, step):
    """One step's draws of the kernel, in ``host_draws``' order."""
    rows = philox_uniforms(seed, n, 5, step, 1)
    return (tuple(rows[i:i + 1] for i in range(5))
            + (philox_uniforms(seed, n, d, step, 0),))


def abc_steps_plain(scalars, pos, fit, trials, draws, objective_name,
                    half_width, limit, tile_n, k_steps, step0, counts=None):
    """``k_steps`` cycles on ``[D, N]``; ``draws is None`` draws from
    Philox.  ``counts`` (a dict) collects each cycle's probed and exhausted
    lanes, the work that depends on the data."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    n_tiles = n // tile_n
    seed = scalars[0:1]
    partners2 = donor_tiles(pos, tile_n, scalars[1])
    dl1, dl2 = scalars[2].long(), scalars[3].long()
    row = torch.arange(d, device=pos.device)[:, None]

    def mutate(base, partner, u_dim, u_phi):
        j = torch.floor(u_dim * d).to(torch.int32)          # [1, N]
        mask = (row == j).to(base.dtype)
        phi = 2.0 * u_phi - 1.0
        return torch.clamp(base + mask * (phi * (base - partner)),
                           -half_width, half_width)

    for step in range(k_steps):
        la, lb, _ = LANE_SHIFTS[step % len(LANE_SHIFTS)]
        ud1, up1, ug, ud2, up2, fresh_u = (
            device_draws(seed, n, d, step0 + step) if draws is None
            else draws)
        # Employed: the partner is a roll of the CURRENT tile.
        partner = roll_lanes(pos.reshape(d, n_tiles, tile_n), dl1 + la)
        cand = mutate(pos, partner, ud1, up1)
        cfit = objective_t(cand)
        acc = cfit < fit
        pos = torch.where(acc, cand, pos)
        fit = torch.where(acc, cfit, fit)
        trials = torch.where(acc, torch.zeros_like(trials), trials + 1)
        # Onlooker: the Bernoulli gate over the tile's quality.
        q = quality(fit).reshape(n_tiles, tile_n)
        qmax = torch.clamp(q.max(dim=1, keepdim=True).values, min=1e-12)
        probed = ug < (q / qmax).reshape(1, n)
        partner2 = roll_lanes(partners2, dl2 + lb)
        cand2 = mutate(pos, partner2, ud2, up2)
        c2fit = objective_t(cand2)
        acc2 = probed & (c2fit < fit)
        pos = torch.where(acc2, cand2, pos)
        fit = torch.where(acc2, c2fit, fit)
        trials = torch.where(acc2, torch.zeros_like(trials),
                             torch.where(probed, trials + 1, trials))
        # Scouts: re-randomize exhausted sources.
        exhausted = trials > limit
        fresh = (2.0 * fresh_u - 1.0) * half_width
        pos = torch.where(exhausted, fresh, pos)
        fit = torch.where(exhausted, objective_t(fresh), fit)
        trials = torch.where(exhausted, torch.zeros_like(trials), trials)
        if counts is not None:
            counts.setdefault("probed", []).append(probed.sum())
            counts.setdefault("exhausted", []).append(exhausted.sum())
    return pos, fit, trials


def _check(rng, draws, k_steps, tile_n, n):
    family.check_rng(rng, draws if draws else (None,), k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_abc_step_plain(
    scalars, pos, fit, trials, draws=None, *, objective_name: str,
    half_width: float = 5.12, limit: int = 20, tile_n: int = 4096,
    rng: str = "device", k_steps: int = 1, step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_abc_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`abc_steps_plain`)."""
    _check(rng, draws, k_steps, tile_n, pos.shape[1])
    return abc_steps_plain(scalars, pos, fit, trials,
                           draws if rng == "host" else None, objective_name,
                           half_width, limit, tile_n, k_steps, step0, counts)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("abc_fused", "dsa_abc_fused_f32", 12,
                          [i, i, i, i, ctypes.c_uint, i, i, fl] + [i] * 5)
    return _fn


def fused_abc_step_cuda(
    scalars, pos, fit, trials, draws=None, *, objective_name: str,
    half_width: float = 5.12, limit: int = 20, tile_n: int = 4096,
    rng: str = "device", k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused ABC cycles on ``pos`` [D,
    N], ``fit`` [1, N] f32 and ``trials`` [1, N] int32 (contiguous, one
    CUDA device; N a multiple of ``tile_n``; positions inside
    ``+-half_width``), a tile as :func:`abc_geometry` says.
    ``scalars`` is [4] int32 on the device: the seed, the onlooker
    partners' tile shift and the two partners' lane shifts; ``step0`` is
    the global index of the launch's first step.  ``draws``
    (``rng="host"``) are ``host_draws``' six.  Returns new tensors ``(pos,
    fit, trials)`` without waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, draws, k_steps, tile_n, n)
    rows = fresh = None
    if rng == "host":
        if len(draws) != 6:
            raise ValueError('rng="host" takes the six draws of host_draws')
        rows = torch.cat([r.reshape(1, -1) for r in draws[:5]])
        fresh = draws[5]
    family.check_operands(
        "fused_abc_step_cuda", scalars, 4, pos,
        dict(fit=(fit, (1, n)), rows=(rows, (5, n)), fresh=(fresh, (d, n))))
    if (trials.dtype != torch.int32 or tuple(trials.shape) != (1, n)
            or trials.device != pos.device or not trials.is_contiguous()):
        raise ValueError("fused_abc_step_cuda: trials must be [1, N] int32, "
                         "contiguous, on pos's device")
    geo = abc_geometry(d, int(tile_n))
    outs = (torch.empty_like(pos), torch.empty_like(fit),
            torch.empty_like(trials))
    scratch = (None,) * 3
    if geo.variant == 1:
        # The cycles between the first and the last ping-pong between the
        # outputs and one scratch triple.
        scratch = (tuple(torch.empty_like(o) for o in outs) if k_steps > 1
                   else outs)
    err = _kernel()(
        scalars.data_ptr(), pos.data_ptr(), fit.data_ptr(),
        trials.data_ptr(), family.ptr(rows), family.ptr(fresh),
        *(o.data_ptr() for o in outs), *(family.ptr(s) for s in scratch),
        n, d, int(tile_n), int(k_steps), int(step0) & _MASK32,
        OBJECTIVE_IDS[objective_name], int(limit), float(half_width), *geo,
        *family.stream_args(pos),
    )
    family.check_launch(err, "abc")
    LAUNCHES += 1
    return outs


def fused_abc_step_t(scalars, pos, fit, trials, draws=None,
                     **kw) -> Tuple[torch.Tensor, ...]:
    """``k_steps`` fused ABC cycles: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors (see :func:`fused_abc_step_cuda`)."""
    step = (fused_abc_step_plain if pos.device.type == "cpu"
            else fused_abc_step_cuda)
    return step(scalars, pos, fit, trials, draws, **kw)


def fused_abc_run(
    state: ABCState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    limit: int = 20,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
    shifts: Optional[torch.Tensor] = None,
) -> ABCState:
    """``n_steps`` fused ABC cycles with no read from the device: ABCState
    in, ABCState out, the fast path beside ``ops.abc.abc_run`` with
    Bernoulli recruitment and rotational partners.  At most 8 cycles go in
    a launch; at least 4 tiles are needed.  The trial counters pad
    cyclically through f32, which is exact.

    ``shifts`` [n_launches, 3] int32 gives each launch's tile shift (in [1,
    n_tiles)) and two lane shifts; by default they are drawn from
    ``state.gen`` on the device.  ``rng="host"`` runs one cycle per launch
    with ``uniforms[i]`` (``host_draws``' six) for launch i, or with draws
    from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("abc", objective_name, state.pos.dtype,
                                    d, lambda _: 1)
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
    tri_t = cyclic_pad_rows(state.trials, n_pad)[None, :].to(
        torch.int32).contiguous()
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, fit_t, tri_t, best_pos, best_fit = carry
        if shifts is not None:
            launch = shifts[call_i].to(device=dev, dtype=torch.int32)
        else:
            launch = torch.cat([
                torch.randint(1, max(n_tiles, 2), (1,), generator=state.gen,
                              dtype=torch.int32, device=dev),
                torch.randint(0, tile_n, (2,), generator=state.gen,
                              dtype=torch.int32, device=dev)])
        draws = None
        if rng == "host":
            draws = (uniforms[call_i] if uniforms is not None else
                     host_draws(state.gen, pos_t.shape, fit_t.shape, dev))
        pos_t, fit_t, tri_t = fused_abc_step_t(
            torch.cat([seed, launch]), pos_t, fit_t, tri_t, draws,
            objective_name=objective_name, half_width=half_width,
            limit=limit, tile_n=tile_n, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(*best_of_block(fit_t, pos_t),
                                        best_fit, best_pos)
        return (pos_t, fit_t, tri_t, best_pos, best_fit)

    pos_t, fit_t, tri_t, best_pos, best_fit = run_blocks(
        block,
        (pos_t, fit_t, tri_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32)),
        n_steps, steps_per_kernel)
    return ABCState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        trials=tri_t[0, :n].to(state.trials.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
