"""Fused grey-wolf-optimizer iterations: ``k_steps`` pack updates in one
pass.

Replaces the TPU kernel ``ops/pallas/gwo_fused.py:fused_gwo_step_t`` of the
JAX package.

- :func:`fused_gwo_step_cuda` launches the hand-written CUDA kernel
  ``csrc/gwo_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_gwo_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_gwo_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

The three leaders are held fixed over a launch; the run re-ranks them
between launches against the pack (:func:`ops.gwo.rerank_leaders`, the
stable order of ``lax.top_k``), gathering only the winners' columns.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed, the A
draws on stream 0 and the C draws on stream 1, each a ``[3 D]`` block per
wolf in the leaders' order (index ``l D + d``), counter (lane, block of four
indices, global step, stream).  ``rng="host"`` takes them as operands
``r_a``, ``r_c`` [3 D, N] (one step per call).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .._numerics import div
from ..gwo import GWOState, rerank_leaders
from . import family
from .common import cyclic_pad_rows
from .pso_fused import (
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    philox_uniforms,
    run_blocks,
    seed_base,
)

# Launches of the CUDA kernel through fused_gwo_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel: the largest of 128, 64 and 32 whose
    ``[2][D][block]`` f32 tile (pos and the running sum) fits a block's
    shared memory, or 0 when none does (D > 908)."""
    return family.pick_block(lambda block: 2 * dim * block * 4)


def gwo_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 908, where the kernel's ``[2][D][32]`` tile still fits a
    block's shared memory.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def gwo_steps_plain(scalars, leaders, pos, r_a, r_c, objective_name,
                    half_width, t_max, k_steps, step0):
    """``k_steps`` pack updates on ``[D, N]``, then the fitness once;
    ``r_a is None`` draws from Philox."""
    d, n = pos.shape
    seed = scalars[0:1]
    t0 = scalars[1].to(torch.float32)
    for step in range(k_steps):
        frac = torch.clamp(div(t0 + step, t_max), max=1.0)
        a = 2.0 * (1.0 - frac)
        if r_a is None:
            u_a = philox_uniforms(seed, n, 3 * d, step0 + step, 0)
            u_c = philox_uniforms(seed, n, 3 * d, step0 + step, 1)
        else:
            u_a, u_c = r_a, r_c
        acc = torch.zeros_like(pos)
        for ell in range(3):
            lead = leaders[ell][:, None]                 # [D, 1]
            big_a = 2.0 * a * u_a[ell * d:(ell + 1) * d] - a
            big_c = 2.0 * u_c[ell * d:(ell + 1) * d]
            dist = torch.abs(big_c * lead - pos)
            acc = acc + (lead - big_a * dist)
        pos = torch.clamp(div(acc, 3.0), -half_width, half_width)
    return pos, OBJECTIVES_T[objective_name](pos)


def fused_gwo_step_plain(
    scalars, leaders, pos, r_a=None, r_c=None, *, objective_name: str,
    half_width: float = 5.12, t_max: int = 500, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """The plain PyTorch version of :func:`fused_gwo_step_cuda`, on any
    device; same arguments and results."""
    family.check_rng(rng, (r_a, r_c), k_steps)
    if rng == "device":
        r_a = r_c = None
    return gwo_steps_plain(scalars, leaders, pos, r_a, r_c, objective_name,
                           half_width, t_max, k_steps, step0)


def _kernel():
    global _fn
    if _fn is None:
        i, f = ctypes.c_int, ctypes.c_float
        _fn = family.bind("gwo_fused", "dsa_gwo_fused_f32", 7,
                          [i, i, i, ctypes.c_uint, i, f, f])
    return _fn


def fused_gwo_step_cuda(
    scalars, leaders, pos, r_a=None, r_c=None, *, objective_name: str,
    half_width: float = 5.12, t_max: int = 500, rng: str = "device",
    k_steps: int = 1, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused pack updates on ``pos``
    [D, N] (f32, contiguous, one CUDA device) toward ``leaders`` [3, D],
    held fixed.  ``scalars`` is [2] int32 on the device: the seed and the
    iteration at the launch's start; ``step0`` is the global index of the
    launch's first step.  Returns new tensors ``(pos, fit [1, N])`` without
    waiting for the kernel."""
    global LAUNCHES
    family.check_rng(rng, (r_a, r_c), k_steps)
    if rng == "device":
        r_a = r_c = None
    if t_max < 1:
        raise ValueError(f"t_max must be >= 1, got {t_max}")
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    family.check_operands(
        "fused_gwo_step_cuda", scalars, 2, pos,
        dict(leaders=(leaders, (3, d)), r_a=(r_a, (3 * d, n)),
             r_c=(r_c, (3 * d, n))))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_gwo_step_cuda: D = {d} is outside the kernel's envelope "
            f"(a [2][D][32] f32 tile must fit {family.MAX_SHARED_BYTES} "
            "bytes of shared memory)")
    pos_out = torch.empty_like(pos)
    fit_out = torch.empty((1, n), dtype=torch.float32, device=pos.device)
    err = _kernel()(
        scalars.data_ptr(), leaders.data_ptr(), pos.data_ptr(),
        family.ptr(r_a), family.ptr(r_c), pos_out.data_ptr(),
        fit_out.data_ptr(), n, d, int(k_steps), int(step0) & _MASK32,
        OBJECTIVE_IDS[objective_name], float(t_max), float(half_width),
        *family.stream_args(pos),
    )
    family.check_launch(err, "gwo")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_gwo_step_t(scalars, leaders, pos, r_a=None, r_c=None,
                     **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k_steps`` fused GWO generations in transposed layout, one pass
    over memory: the plain version on CPU tensors, the CUDA kernel on CUDA
    tensors (see :func:`fused_gwo_step_cuda`).  Fitness is an output only:
    GWO's update never reads it."""
    step = (fused_gwo_step_plain if pos.device.type == "cpu"
            else fused_gwo_step_cuda)
    return step(scalars, leaders, pos, r_a, r_c, **kw)


def fused_gwo_run(
    state: GWOState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = 500,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> GWOState:
    """``n_steps`` fused GWO generations with no read from the device:
    GWOState in, GWOState out, the fast path beside ``ops.gwo.gwo_run``
    (trajectories differ in the random stream and the per-block leader
    refresh).  The pack is padded to a whole number of the JAX package's
    lane tiles by duplicating leading wolves, and the padded wolves take
    part in the re-rank, as there.  ``rng="host"`` runs one step per launch
    with ``uniforms[i] = (r_a, r_c)`` for launch i, or with draws from
    ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("gwo", objective_name, state.pos.dtype,
                                    d, kernel_block, 908)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    _, n_pad = family.lane_tiling(n, tile_n, 8 * d)
    dev = state.device
    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, fit_t, leaders, leader_fit, it = carry
        r_a = r_c = None
        if rng == "host":
            r_a, r_c = (uniforms[call_i] if uniforms is not None else (
                torch.rand((3 * d, n_pad), generator=state.gen, device=dev),
                torch.rand((3 * d, n_pad), generator=state.gen, device=dev)))
        pos_t, fit_t = fused_gwo_step_t(
            family.block_scalars(seed, it), leaders, pos_t, r_a, r_c,
            objective_name=objective_name, half_width=half_width,
            t_max=t_max, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel)
        leaders, leader_fit = rerank_leaders(leaders, leader_fit, pos_t,
                                             fit_t[0])
        return (pos_t, fit_t, leaders.contiguous(), leader_fit, it + k)

    pos_t, fit_t, leaders, leader_fit, _ = run_blocks(
        block,
        (pos_t, fit_t, state.leaders.to(torch.float32).contiguous(),
         state.leader_fit.to(torch.float32), state.iteration),
        n_steps, steps_per_kernel)
    dt = state.pos.dtype
    return GWOState(
        pos=pos_t.T[:n].to(dt).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        leaders=leaders.to(state.leaders.dtype),
        leader_fit=leader_fit.to(state.leader_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
