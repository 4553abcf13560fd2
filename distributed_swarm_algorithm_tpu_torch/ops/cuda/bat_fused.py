"""Fused bat-algorithm iterations: ``k_steps`` generations of the whole
colony in one pass.

Replaces the TPU kernel ``ops/pallas/bat_fused.py:fused_bat_step_t`` of the
JAX package.

- :func:`fused_bat_step_cuda` launches the hand-written CUDA kernel
  ``csrc/bat_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_bat_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_bat_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

The incumbent best and the colony's mean loudness are held fixed over a
launch and refreshed between launches (staleness <= ``steps_per_kernel``
generations), as in the JAX package.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed; eps
takes stream 0 with the counter (lane, block of four dimensions, global
step, 0), and beta, the walk gate and the acceptance gate are words 0, 1
and 2 of the call (lane, 0, global step, 1).  ``rng="host"`` takes the four
draws as operands (one step per call), which is how tests feed both
packages the same numbers.

Up to D = 226 the kernel keeps no candidate tile (blocks of 128 bats,
their pos and vel and the best column staged); wider, up to D = 605, it
runs its first version, which stages the candidates too
(:func:`bat_geometry` picks; the kernel's entry checks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..bat import ALPHA, F_MAX, F_MIN, GAMMA, R0, SIGMA_LOCAL, BatState
from . import family
from .common import ceil_to, cyclic_pad_rows
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

# Launches of the CUDA kernel through fused_bat_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel's first version: the largest of
    128, 64 and 32 whose ``[3][D][block]`` f32 tile (pos, vel, cand) fits a
    block's shared memory, or 0 when none does (D > 605): the kernel's
    envelope."""
    return family.pick_block(lambda block: 3 * dim * block * 4)


# The main variant's block: 128 bats, 7 blocks (28 warps) an SM at D = 30.
STAGED_LANES = 128


class BatGeometry(NamedTuple):
    """How the kernel runs, handed to its entry, which checks it."""
    variant: int    # 0: no candidate tile; 1: the first version
    lanes: int      # bats (threads) a block
    shared: int     # dynamic shared memory a block, bytes


def staged_bytes(dim: int) -> int:
    """Shared memory of a main-variant block: the best column (padded to
    four) and the block's pos and vel."""
    return 4 * (2 * dim * STAGED_LANES + ceil_to(dim, 4))


def bat_geometry(dim: int) -> BatGeometry:
    """Blocks of 128 bats with no candidate tile where their pos, vel and
    the best column fit a block's shared memory (D <= 226); wider, the
    first version (:func:`candidate_tile_geometry`)."""
    shared = staged_bytes(dim)
    if shared <= MAX_SHARED_BYTES:
        return BatGeometry(0, STAGED_LANES, shared)
    return candidate_tile_geometry(dim)


def candidate_tile_geometry(dim: int) -> BatGeometry:
    """The first version at any D of the envelope: three [D][block] tiles,
    the block from :func:`kernel_block`."""
    lanes = kernel_block(dim)
    return BatGeometry(1, lanes, 3 * dim * lanes * 4)


def bat_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 605, where the kernel's ``[3][D][32]`` tile still fits a
    block's shared memory.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def bat_steps_plain(scalars, best, mean_a, pos, vel, fit, loud, pulse,
                    draws, objective_name, half_width, f_min, f_max, alpha,
                    gamma, r0, sigma_local, k_steps, step0):
    """``k_steps`` generations on ``[D, N]`` arrays; ``draws is None``
    draws from Philox."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    seed = scalars[0:1]
    t0 = scalars[1].to(torch.float32)
    for step in range(k_steps):
        if draws is None:
            rows = philox_uniforms(seed, n, 4, step0 + step, 1)
            u_beta, u_walk, u_acc = rows[0:1], rows[1:2], rows[2:3]
            u_eps = philox_uniforms(seed, n, d, step0 + step, 0)
        else:
            u_beta, u_walk, u_eps, u_acc = draws
        freq = f_min + (f_max - f_min) * u_beta      # [1, N] per bat
        vel_new = vel + (pos - best) * freq
        cand = pos + vel_new
        walk = u_walk > pulse                        # [1, N]
        eps = 2.0 * u_eps - 1.0                      # U(-1, 1)
        local = best + sigma_local * half_width * mean_a * eps
        cand = torch.where(walk, local, cand)
        cand = torch.clamp(cand, -half_width, half_width)

        cfit = objective_t(cand)                     # [1, N]
        accept = (cfit <= fit) & (u_acc < loud)
        pos = torch.where(accept, cand, pos)
        fit = torch.where(accept, cfit, fit)
        vel = torch.where(accept, vel_new, vel)
        tf = t0 + (step + 1)
        loud = torch.where(accept, loud * alpha, loud)
        pulse = torch.where(accept, r0 * (1.0 - torch.exp(-gamma * tf)),
                            pulse)
    return pos, vel, fit, loud, pulse


_DEFAULTS = dict(half_width=5.12, f_min=F_MIN, f_max=F_MAX, alpha=ALPHA,
                 gamma=GAMMA, r0=R0, sigma_local=SIGMA_LOCAL)


def _params(kw):
    unknown = set(kw) - set(_DEFAULTS)
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    return dict(_DEFAULTS, **kw)


def fused_bat_step_plain(
    scalars, best_pos, mean_a, pos, vel, fit, loud, pulse, r_beta=None,
    r_walk=None, r_eps=None, r_acc=None, *, objective_name: str,
    rng: str = "device", k_steps: int = 1, step0: int = 0, **params,
):
    """The plain PyTorch version of :func:`fused_bat_step_cuda`, on any
    device; same arguments and results."""
    p = _params(params)
    draws = (r_beta, r_walk, r_eps, r_acc)
    family.check_rng(rng, draws, k_steps)
    return bat_steps_plain(
        scalars, best_pos, mean_a, pos, vel, fit, loud, pulse,
        draws if rng == "host" else None, objective_name, p["half_width"],
        p["f_min"], p["f_max"], p["alpha"], p["gamma"], p["r0"],
        p["sigma_local"], k_steps, step0)


def _kernel():
    global _fn
    if _fn is None:
        i, f = ctypes.c_int, ctypes.c_float
        _fn = family.bind("bat_fused", "dsa_bat_fused_f32", 17,
                          [i, i, i, ctypes.c_uint, i] + [f] * 7 + [i] * 3)
    return _fn


def fused_bat_step_cuda(
    scalars, best_pos, mean_a, pos, vel, fit, loud, pulse, r_beta=None,
    r_walk=None, r_eps=None, r_acc=None, *, objective_name: str,
    rng: str = "device", k_steps: int = 1, step0: int = 0, **params,
):
    """Launch the CUDA kernel: ``k_steps`` fused bat generations on
    ``pos``/``vel`` [D, N] and ``fit``/``loud``/``pulse`` [1, N] (f32,
    contiguous, one CUDA device), with ``best_pos`` [D, 1] and ``mean_a``
    (one f32) held fixed, a block as :func:`bat_geometry` says.
    ``scalars`` is [2] int32 on the device: the seed and the iteration at
    the launch's start; ``step0`` is the global index of the launch's first
    step (the generator's counter).  Returns new tensors ``(pos, vel, fit,
    loud, pulse)`` without waiting for the kernel."""
    global LAUNCHES
    p = _params(params)
    draws = (r_beta, r_walk, r_eps, r_acc)
    family.check_rng(rng, draws, k_steps)
    if rng == "device":
        r_beta = r_walk = r_eps = r_acc = None
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    row = (1, n)
    family.check_operands(
        "fused_bat_step_cuda", scalars, 2, pos,
        dict(best_pos=(best_pos, (d, 1)), mean_a=(mean_a.reshape(1), (1,)),
             vel=(vel, (d, n)), fit=(fit, row), loud=(loud, row),
             pulse=(pulse, row), r_beta=(r_beta, row), r_walk=(r_walk, row),
             r_eps=(r_eps, (d, n)), r_acc=(r_acc, row)))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_bat_step_cuda: D = {d} is outside the kernel's envelope "
            f"(a [3][D][32] f32 tile must fit {family.MAX_SHARED_BYTES} "
            "bytes of shared memory)")
    outs = [torch.empty_like(t) for t in (pos, vel, fit, loud, pulse)]
    err = _kernel()(
        scalars.data_ptr(), best_pos.data_ptr(), mean_a.data_ptr(),
        pos.data_ptr(), vel.data_ptr(), fit.data_ptr(), loud.data_ptr(),
        pulse.data_ptr(), *(family.ptr(r) for r in
                            (r_beta, r_walk, r_eps, r_acc)),
        *(t.data_ptr() for t in outs), n, d, int(k_steps),
        int(step0) & _MASK32, OBJECTIVE_IDS[objective_name],
        float(p["f_min"]), float(p["f_max"] - p["f_min"]),
        float(p["sigma_local"] * p["half_width"]), float(p["alpha"]),
        float(-p["gamma"]), float(p["r0"]), float(p["half_width"]),
        *bat_geometry(d), *family.stream_args(pos),
    )
    family.check_launch(err, "bat")
    LAUNCHES += 1
    return tuple(outs)


def fused_bat_step_t(scalars, best_pos, mean_a, pos, vel, fit, loud, pulse,
                     r_beta=None, r_walk=None, r_eps=None, r_acc=None,
                     **kw) -> Tuple[torch.Tensor, ...]:
    """``k_steps`` fused bat generations in transposed layout, one pass
    over memory: the plain version on CPU tensors, the CUDA kernel on CUDA
    tensors (see :func:`fused_bat_step_cuda`).  The caller reduces the
    block's best from ``fit`` and recomputes the mean loudness between
    blocks."""
    step = (fused_bat_step_plain if pos.device.type == "cpu"
            else fused_bat_step_cuda)
    return step(scalars, best_pos, mean_a, pos, vel, fit, loud, pulse,
                r_beta, r_walk, r_eps, r_acc, **kw)


def rebuild_bat_state(state: BatState, pos_t, vel_t, fit_t, loud_t, pulse_t,
                      bpos, bfit, n_steps: int) -> BatState:
    """Transposed padded arrays -> BatState with the original n and
    dtypes."""
    n = state.pos.shape[0]
    dt = state.pos.dtype
    back = lambda x_t: x_t.T[:n].to(dt).contiguous()  # noqa: E731
    return BatState(
        pos=back(pos_t),
        vel=back(vel_t),
        fit=fit_t[0, :n].to(state.fit.dtype),
        loudness=loud_t[0, :n].to(state.loudness.dtype),
        pulse=pulse_t[0, :n].to(state.pulse.dtype),
        best_pos=bpos.to(state.best_pos.dtype),
        best_fit=bfit.to(state.best_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )


def fused_bat_run(
    state: BatState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    f_min: float = F_MIN,
    f_max: float = F_MAX,
    alpha: float = ALPHA,
    gamma: float = GAMMA,
    r0: float = R0,
    sigma_local: float = SIGMA_LOCAL,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
) -> BatState:
    """``n_steps`` fused bat generations with no read from the device:
    BatState in, BatState out, the fast path beside ``ops.bat.bat_run``
    (trajectories differ in the random stream and the per-block refresh of
    the best and the mean loudness).

    The colony is padded to a whole number of the JAX package's lane tiles
    (``tile_n``, picked as it picks it) by duplicating leading bats, which
    preserves the colony's optimum; the mean loudness is over the real
    bats.  ``rng="host"`` runs one step per launch with ``uniforms[i] =
    (r_beta, r_walk, r_eps, r_acc)`` for launch i, or with draws from
    ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("bat", objective_name, state.pos.dtype,
                                    d, kernel_block, 605)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    _, n_pad = family.lane_tiling(n, tile_n, d)
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    vel_t = cyclic_pad_rows(state.vel, n_pad).T.contiguous()
    rows = [cyclic_pad_rows(x, n_pad)[None, :].contiguous()
            for x in (state.fit, state.loudness, state.pulse)]
    seed = seed_base(state.gen, dev)
    kw = dict(objective_name=objective_name, half_width=half_width,
              f_min=f_min, f_max=f_max, alpha=alpha, gamma=gamma, r0=r0,
              sigma_local=sigma_local, rng=rng)

    def block(carry, call_i, k):
        pos_t, vel_t, fit_t, loud_t, pulse_t, bpos, bfit, it = carry
        draws = (None,) * 4
        if rng == "host":
            draws = (uniforms[call_i] if uniforms is not None else (
                torch.rand((1, n_pad), generator=state.gen, device=dev),
                torch.rand((1, n_pad), generator=state.gen, device=dev),
                torch.rand((d, n_pad), generator=state.gen, device=dev),
                torch.rand((1, n_pad), generator=state.gen, device=dev)))
        mean_a = torch.mean(loud_t[0, :n])           # real bats only
        pos_t, vel_t, fit_t, loud_t, pulse_t = fused_bat_step_t(
            family.block_scalars(seed, it), bpos[:, None].contiguous(),
            mean_a.reshape(1), pos_t, vel_t, fit_t, loud_t, pulse_t, *draws,
            k_steps=k, step0=call_i * steps_per_kernel, **kw)
        bfit, bpos = merge_best(*best_of_block(fit_t, pos_t), bfit, bpos)
        return (pos_t, vel_t, fit_t, loud_t, pulse_t, bpos, bfit, it + k)

    carry = run_blocks(
        block,
        (pos_t, vel_t, *rows, state.best_pos.to(torch.float32),
         state.best_fit.to(torch.float32), state.iteration),
        n_steps, steps_per_kernel)
    return rebuild_bat_state(state, *carry[:7], n_steps)
