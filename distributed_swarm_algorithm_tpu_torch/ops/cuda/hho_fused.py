"""Fused Harris-hawks generations: ``k_steps`` generations in one pass.

Replaces the TPU kernel ``ops/pallas/hho_fused.py:fused_hho_step_t`` of the
JAX package.

- :func:`fused_hho_step_cuda` launches the hand-written CUDA kernel
  ``csrc/hho_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_hho_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_hho_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

The rabbit (the best so far), the population mean and the random hawk's
view are block-start snapshots (the JAX package's deltas from
``ops/hho.py``): the random hawk of lane j in tile i is lane ``j - (l +
LANE_SHIFTS[step % 8][0])`` of the launch's input tile ``i + s``.  So a
lane updates only itself.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed; r1,
r2, r3, r4 and the dive's s on streams 0 to 4 and the Box-Muller pair's
uniforms on streams 5 and 6, over the dimensions, counter (lane, block of
four dimensions, global step, stream); the row uniforms ``u_e0, u_j, u_q,
u_r`` are the four words of the call (lane, 0, global step, 7).
``rng="host"`` takes the eleven draws of ``host_draws`` as operands (one
step per call): 4 row uniforms, 5 plane uniforms, then 2 plane normals.

Up to D = 111 a block of the kernel holds 256 hawks and, at every step,
regroups its lanes by branch (:func:`branch_order`), so that a warp's
threads advance lanes of one branch; wider, up to D = 605, it runs its
first version, one thread a hawk in the hawks' order (:func:`hho_geometry`
picks; the kernel's entry checks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..cuckoo import mantegna_sigma
from ..hho import LEVY_BETA, T_MAX, HHOState
from . import family
from .common import ceil_to, cyclic_pad_rows
from .family import (  # noqa: F401  (branch_order: the kernel's order)
    LANE_SHIFTS,
    branch_order,
    donor_tiles,
    roll_lanes,
)
from .fast_math import levy_power, normal_pair
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

# Launches of the CUDA kernel through fused_hho_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The JAX package's cap on steps_per_kernel for this family
# (ops/pallas/hho_fused.py:284).
MAX_STEPS_PER_KERNEL = 8
# The row uniforms' Philox stream.
ROW_STREAM = 7


def host_draws(gen: torch.Generator, pos_shape, fit_shape, device):
    """The kernel's eleven host-RNG operands in the JAX package's order
    (``hho_fused.host_draws``): ``u_e0, u_j, u_q, u_r`` [1, N], ``r1, r2,
    r3, r4, s`` [D, N] uniforms and the two Levy normals [D, N]."""
    u = lambda s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    return (tuple(u(fit_shape) for _ in range(4))
            + tuple(u(pos_shape) for _ in range(5))
            + tuple(torch.randn(pos_shape, generator=gen, device=device)
                    for _ in range(2)))


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel's first version: the largest of 128,
    64 and 32 whose three ``[D][block]`` f32 tiles (the hawks and the
    dive's two trial points) fit a block's shared memory, or 0 (D > 605)."""
    return family.pick_block(lambda block: 3 * dim * block * 4)


# The main variant's block: 256 hawks, regrouped by branch at every step.
SORTED_LANES = 256
# A lane's class at a step, in the order of the regrouping: exploring at a
# random hawk's perch, exploring below the mean, besieging, diving.
PERCH, BELOW, BESIEGE, DIVE = range(4)


class HhoGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    variant: int    # 0: lanes regrouped by branch; 1: the first version
    lanes: int      # hawks (threads) a block
    shared: int     # dynamic shared memory a block, bytes


def sorted_bytes(dim: int) -> int:
    """Shared memory of a main-variant block: the hawks' positions and the
    dive's z columns ``[D][256]`` each, the rabbit and the mean (padded to
    four), four ``[256]`` rows (the fitness, the sorted lanes, their
    energy and jump) and the warps' class counts ``[2][8]``."""
    lanes = SORTED_LANES
    return 4 * (2 * dim * lanes + 2 * ceil_to(dim, 4) + 4 * lanes
                + 2 * (lanes // 32))


def hho_geometry(dim: int) -> HhoGeometry:
    """Blocks of 256 hawks regrouped by branch where their block fits
    (D <= 111); wider, the first version (:func:`trial_tile_geometry`)."""
    shared = sorted_bytes(dim)
    if shared <= MAX_SHARED_BYTES:
        return HhoGeometry(0, SORTED_LANES, shared)
    return trial_tile_geometry(dim)


def trial_tile_geometry(dim: int) -> HhoGeometry:
    """The first version at any D of the envelope: three [D][block] tiles,
    the block from :func:`kernel_block`."""
    lanes = kernel_block(dim)
    return HhoGeometry(1, lanes, 3 * dim * lanes * 4)


def hho_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 605.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def step_fraction(t0: torch.Tensor, step: int, t_max: int) -> torch.Tensor:
    """``clip((t0 + step + 1) / t_max, 0, 1)`` as the JAX kernel's compiled
    body computes it: ``t0 + step`` then ``+ 1`` in f32, and the division
    by the constant ``t_max`` a product with its f32 reciprocal."""
    t = (t0.to(torch.float32) + float(step)) + 1.0
    return torch.clamp(t * (1.0 / t_max), 0.0, 1.0)


def device_draws(seed, n, d, step):
    """One step's draws of the kernel, in ``host_draws``' order, the two
    normals the cosine and the sine half of one Box-Muller pair."""
    rows = philox_uniforms(seed, n, 4, step, ROW_STREAM)
    planes = tuple(philox_uniforms(seed, n, d, step, s) for s in range(5))
    n1, n2 = normal_pair(philox_uniforms(seed, n, d, step, 5),
                         philox_uniforms(seed, n, d, step, 6))
    return tuple(rows[i:i + 1] for i in range(4)) + planes + (n1, n2)


def branches(u_e0, u_r, frac):
    """Per lane ``(explore, dive, soft)``: ``|E| >= 1``; else ``u_r < 1/2``
    (the Levy dive, ``besiege`` otherwise); and ``|E| >= 1/2``."""
    energy = 2.0 * (2.0 * u_e0 - 1.0) * (1.0 - frac)
    abs_e = torch.abs(energy)
    explore = abs_e >= 1.0
    return explore, ~explore & (u_r < 0.5), abs_e >= 0.5


def lane_classes(u_e0, u_q, u_r, frac) -> torch.Tensor:
    """Per lane its class at a step (int64): ``PERCH`` or ``BELOW`` where
    it explores (``u_q >= 1/2`` or not), else ``BESIEGE`` or ``DIVE``
    (:func:`branches`)."""
    explore, dive, _ = branches(u_e0, u_r, frac)
    return torch.where(explore, torch.where(u_q >= 0.5, PERCH, BELOW),
                       torch.where(dive, DIVE, BESIEGE))


def hho_steps_plain(scalars, rabbit, mean, pos, fit, draws, objective_name,
                    half_width, t_max, beta, tile_n, k_steps, step0,
                    counts=None):
    """``k_steps`` generations on ``[D, N]``; ``draws is None`` draws from
    Philox.  ``counts`` (a dict) collects each generation's exploring and
    diving lanes and the diving lanes that keep their position (neither y
    nor z beats it), the work that depends on the data."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    lb, ub = -half_width, half_width
    seed = scalars[0:1]
    peer0 = donor_tiles(pos, tile_n, scalars[1])
    l_peer = scalars[3].long()
    sigma = mantegna_sigma(beta)
    for step in range(k_steps):
        frac = step_fraction(scalars[2], step, t_max)
        (u_e0, u_j, u_q, u_r, r1, r2, r3, r4, s, n1, n2) = (
            device_draws(seed, n, d, step0 + step) if draws is None
            else draws)
        e0 = 2.0 * u_e0 - 1.0
        energy = 2.0 * e0 * (1.0 - frac)                # [1, N]
        abs_e = torch.abs(energy)
        jump = 2.0 * (1.0 - u_j)

        x_rand = roll_lanes(peer0, l_peer + LANE_SHIFTS[step % 8][0])
        explore_a = x_rand - r1 * torch.abs(x_rand - 2.0 * r2 * pos)
        explore_b = (rabbit - mean) - r3 * (lb + r4 * (ub - lb))
        explore = torch.where(u_q >= 0.5, explore_a, explore_b)

        delta = rabbit - pos
        soft = delta - energy * torch.abs(jump * rabbit - pos)
        hard = rabbit - energy * torch.abs(delta)
        besiege = torch.where(abs_e >= 0.5, soft, hard)

        y_soft = rabbit - energy * torch.abs(jump * rabbit - pos)
        y_hard = rabbit - energy * torch.abs(jump * rabbit - mean)
        y = torch.where(abs_e >= 0.5, y_soft, y_hard)
        z = y + s * (sigma * n1 * levy_power(n2, 1.0 / beta))
        y = torch.clamp(y, lb, ub)
        z = torch.clamp(z, lb, ub)
        fy = objective_t(y)
        fz = objective_t(z)
        dive = torch.where(fy < fit, y, torch.where(fz < fit, z, pos))

        if counts is not None:
            explore_l, dive_l, _ = branches(u_e0, u_r, frac)
            counts.setdefault("explore", []).append(explore_l.sum())
            counts.setdefault("dive", []).append(dive_l.sum())
            counts.setdefault("kept", []).append(
                (dive_l & ~(fy < fit) & ~(fz < fit)).sum())

        exploit = torch.where(u_r >= 0.5, besiege, dive)
        pos = torch.clamp(torch.where(abs_e >= 1.0, explore, exploit), lb,
                          ub)
        fit = objective_t(pos)
    return pos, fit


def _check(rng, draws, k_steps, tile_n, n):
    family.check_rng(rng, draws if draws else (None,), k_steps)
    if n % tile_n:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")


def fused_hho_step_plain(
    scalars, best_pos, mean_pos, pos, fit, draws=None, *,
    objective_name: str, half_width: float = 5.12, t_max: int = T_MAX,
    levy_beta: float = LEVY_BETA, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0, counts=None,
):
    """The plain PyTorch version of :func:`fused_hho_step_cuda`, on any
    device; same arguments and results (``counts``: see
    :func:`hho_steps_plain`)."""
    _check(rng, draws, k_steps, tile_n, pos.shape[1])
    return hho_steps_plain(scalars, best_pos, mean_pos, pos, fit,
                           draws if rng == "host" else None, objective_name,
                           half_width, t_max, levy_beta, tile_n, k_steps,
                           step0, counts)


def _kernel():
    global _fn
    if _fn is None:
        i, fl = ctypes.c_int, ctypes.c_float
        _fn = family.bind("hho_fused", "dsa_hho_fused_f32", 10,
                          [i, i, i, i, ctypes.c_uint, i] + [fl] * 4
                          + [i] * 3)
    return _fn


def fused_hho_step_cuda(
    scalars, best_pos, mean_pos, pos, fit, draws=None, *,
    objective_name: str, half_width: float = 5.12, t_max: int = T_MAX,
    levy_beta: float = LEVY_BETA, tile_n: int = 4096, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused HHO generations on ``pos``
    [D, N] and ``fit`` [1, N] around the rabbit ``best_pos`` and the mean
    ``mean_pos`` [D, 1] (f32, contiguous, one CUDA device; N a multiple of
    ``tile_n``), a block as :func:`hho_geometry` says.  ``scalars`` is [4]
    int32 on the device: the seed, the peer tile shift, the iteration
    before the launch and the peer lane shift; ``step0`` is the global
    index of the launch's first step.  ``draws`` (``rng="host"``) are
    ``host_draws``' eleven.  Returns new tensors ``(pos, fit)`` without
    waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, draws, k_steps, tile_n, n)
    rows = planes = normals = None
    if rng == "host":
        if len(draws) != 11:
            raise ValueError("rng=\"host\" takes the eleven draws of "
                             "host_draws")
        rows = torch.cat([r.reshape(1, -1) for r in draws[:4]])
        planes = torch.stack(draws[4:9])
        normals = torch.stack(draws[9:])
        if rows.shape != (4, n) or planes.shape != (5, d, n) or (
                normals.shape != (2, d, n)):
            raise ValueError("fused_hho_step_cuda: the draws must be 4 rows "
                             "[1, N] and 7 planes [D, N]")
    family.check_operands(
        "fused_hho_step_cuda", scalars, 4, pos,
        dict(best_pos=(best_pos, (d, 1)), mean_pos=(mean_pos, (d, 1)),
             fit=(fit, (1, n)),
             rows=(rows, (4, n)), planes=(planes, (5, d, n)),
             normals=(normals, (2, d, n))))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_hho_step_cuda: D = {d} is outside the kernel's envelope "
            f"(three [D][32] f32 tiles must fit {family.MAX_SHARED_BYTES} "
            "bytes of shared memory)")
    pos_out, fit_out = torch.empty_like(pos), torch.empty_like(fit)
    err = _kernel()(
        scalars.data_ptr(), best_pos.data_ptr(), mean_pos.data_ptr(),
        pos.data_ptr(), fit.data_ptr(),
        *(family.ptr(r) for r in (rows, planes, normals)),
        pos_out.data_ptr(), fit_out.data_ptr(), n, d, int(tile_n),
        int(k_steps), int(step0) & _MASK32, OBJECTIVE_IDS[objective_name],
        float(half_width), float(1.0 / t_max),
        float(mantegna_sigma(levy_beta)), float(-1.0 / levy_beta),
        *hho_geometry(d), *family.stream_args(pos),
    )
    family.check_launch(err, "hho")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_hho_step_t(scalars, best_pos, mean_pos, pos, fit, draws=None,
                     **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k_steps`` fused HHO generations: the plain version on CPU tensors,
    the CUDA kernel on CUDA tensors (see :func:`fused_hho_step_cuda`)."""
    step = (fused_hho_step_plain if pos.device.type == "cpu"
            else fused_hho_step_cuda)
    return step(scalars, best_pos, mean_pos, pos, fit, draws, **kw)


def fused_hho_run(
    state: HHOState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = T_MAX,
    levy_beta: float = LEVY_BETA,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
    shifts: Optional[torch.Tensor] = None,
) -> HHOState:
    """``n_steps`` fused HHO generations with no read from the device:
    HHOState in, HHOState out, the fast path beside ``ops.hho.hho_run``
    with the block-start rabbit, mean and rotational peer.  At most 8 steps
    go in a launch; at least 4 tiles are needed.  The mean is taken over
    the real lanes only, before each launch.

    ``shifts`` [n_launches, 2] int32 gives each launch's tile shift (in [1,
    n_tiles)) and lane shift; by default they are drawn from ``state.gen``
    on the device.  ``rng="host"`` runs one step per launch with
    ``uniforms[i]`` (``host_draws``' eleven) for launch i, or with draws
    from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("hho", objective_name, state.pos.dtype,
                                    d, kernel_block, 605)
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
        pos_t, fit_t, best_pos, best_fit, it = carry
        if shifts is not None:
            launch = shifts[call_i].to(device=dev, dtype=torch.int32)
            tshift, lshift = launch[0], launch[1]
        else:
            tshift = torch.randint(1, max(n_tiles, 2), (1,),
                                   generator=state.gen, dtype=torch.int32,
                                   device=dev)
            lshift = family.random_int(state.gen, tile_n, dev)
        # The mean over the real lanes: the pad lanes are duplicates.
        mean = pos_t[:, :n].mean(dim=1, keepdim=True)
        draws = None
        if rng == "host":
            draws = (uniforms[call_i] if uniforms is not None else
                     host_draws(state.gen, pos_t.shape, fit_t.shape, dev))
        pos_t, fit_t = fused_hho_step_t(
            family.block_scalars(seed, tshift, it, lshift),
            best_pos[:, None].contiguous(), mean, pos_t, fit_t, draws,
            objective_name=objective_name, half_width=half_width,
            t_max=t_max, levy_beta=levy_beta, tile_n=tile_n, rng=rng,
            k_steps=k, step0=call_i * steps_per_kernel)
        best_fit, best_pos = merge_best(*best_of_block(fit_t, pos_t),
                                        best_fit, best_pos)
        return (pos_t, fit_t, best_pos, best_fit, it + k)

    pos_t, fit_t, best_pos, best_fit, _ = run_blocks(
        block,
        (pos_t, fit_t, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32), state.iteration),
        n_steps, steps_per_kernel)
    return HHOState(
        pos=pos_t.T[:n].to(state.pos.dtype).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
