"""Tiled all-pairs firefly attraction and the fused firefly run.

Replaces the TPU kernel ``ops/pallas/firefly_fused.py:
firefly_attraction_pallas`` of the JAX package.

- :func:`firefly_attraction_cuda` launches the hand-written CUDA kernel
  ``csrc/firefly_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`firefly_attraction_plain` is the plain PyTorch version, chunked
  over rows i (the portable step's [N, N] temporaries would take 17 GB at
  65,536 fireflies): the same squared distances and weights bit for bit,
  the sums over j in float64, rounded once;
- :func:`firefly_attraction` is the entry: the plain version for CPU
  tensors, the kernel for CUDA tensors.  Nothing falls back.

    r2_ij  = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)
    W_ij   = beta0 exp_fast(-gamma r2_ij)  where f_j < f_i, else 0
    move_i = sum_j W_ij x_j - (sum_j W_ij) x_i

By default j ranges over the same swarm; ``pos_j`` / ``fit_j`` give the
rectangular case (rows i attracted by another swarm), which the sharded
driver needs.  The dimensions split into groups of 32, each summed in
order, the groups combined as a pairwise tree: the kernel's order.

:func:`fused_firefly_run` is the JAX package's driver: the attraction by
the entry, the O(N D) tail (alpha decay, walk, clip, objective, best) in
PyTorch operations on the device, the same update rule as
``ops.firefly.firefly_run``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from ..firefly import (
    ALPHA0,
    ALPHA_DECAY,
    BETA0,
    GAMMA,
    FireflyState,
    firefly_draws,
    walk_and_clip,
)
from . import _build
from .fast_math import exp_fast

# Launches of the CUDA kernel through firefly_attraction_cuda since the
# count was last set to 0, one per launch.
LAUNCHES = 0

# The kernel's envelope and shape (csrc/firefly_fused.cu): a lane holds 32
# dimensions, a row at most 4 lanes; sources stream in tiles of 64.
GROUP = 32
D_MAX = 128
TILE_J = 64

# Rows i per chunk of the plain version: rows * N_j stays near 2^24 pairs.
_PLAIN_PAIRS_PER_CHUNK = 1 << 24

_fn = None   # the C entry, bound at the first launch


def lanes_per_row(dim: int) -> int:
    """Lanes of a warp that hold one row: the groups of 32 dimensions,
    rounded up to a power of two (0 outside the envelope)."""
    if not 1 <= dim <= D_MAX:
        return 0
    groups = -(-dim // GROUP)
    return 1 << (groups - 1).bit_length()


def firefly_cuda_supported(dtype, dim: int) -> bool:
    """True if the kernel covers this state: float32, 1 <= D <= 128.  Any
    objective callable works (the tail stays in PyTorch) and any N."""
    return dtype == torch.float32 and lanes_per_row(dim) > 0


def require_supported(dtype, dim: int) -> None:
    """Raise unless the kernel covers the state: the fused run does not
    fall back to the portable step."""
    if not firefly_cuda_supported(dtype, dim):
        raise ValueError(
            f"the fused firefly kernel takes float32 state with 1 <= D <= "
            f"{D_MAX}, got {dtype} at D = {dim}")


def attraction_band(n_j: int) -> float:
    """Relative band of the kernel against the plain version, per element
    of the sum ``sum_j |W_ij x_j| + (sum_j W_ij) |x_i|``
    (:func:`attraction_abs_sum`): the weights agree bit for bit, the
    kernel's two-level f32 sum over tiles of 64 errs by at most
    ``(64 + ceil(N_j / 64))`` ulps of that sum, the plain version's float64
    sum rounds once, and the closing product and difference add 2."""
    return (TILE_J + -(-n_j // TILE_J) + 4) * 2.0 ** -24


def _grouped(term, dim: int, like: torch.Tensor) -> torch.Tensor:
    """``sum_d term(d)`` in the kernel's order: each group of 32 dimensions
    summed from 0 in order, the groups (padded with zeros to a power of
    two) combined as a pairwise tree."""
    parts = []
    for g in range(lanes_per_row(dim)):
        p = torch.zeros_like(like)
        for d in range(g * GROUP, min(dim, (g + 1) * GROUP)):
            p = p + term(d)
        parts.append(p)
    while len(parts) > 1:
        parts = [parts[k] + parts[k + 1] for k in range(0, len(parts), 2)]
    return parts[0]


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """[N] ``|x_i|^2`` in the kernel's order."""
    return _grouped(lambda d: x[:, d] * x[:, d], x.shape[1], x[:, 0])


def _weights(pos, fit, beta0, gamma, pos_j, fit_j, counts):
    """Yield ``(s, e, w)``: the [e - s, N_j] f32 weights of rows s:e, one
    chunk of rows at a time, as the kernel computes them."""
    n, dim = pos.shape
    sq_i, sq_j = sq_norms(pos), sq_norms(pos_j)
    rows = max(1, _PLAIN_PAIRS_PER_CHUNK // max(pos_j.shape[0], 1))
    for s in range(0, n, rows):
        e = min(n, s + rows)
        pi = pos[s:e]
        like = torch.empty((e - s, pos_j.shape[0]), dtype=pos.dtype,
                           device=pos.device)
        cross = _grouped(lambda d: pi[:, d, None] * pos_j[None, :, d], dim,
                         like)
        r2 = torch.clamp((sq_i[s:e, None] + sq_j[None, :]) - 2.0 * cross,
                         min=0.0)
        brighter = fit_j[None, :] < fit[s:e, None]
        w = torch.where(brighter, beta0 * exp_fast(-gamma * r2),
                        torch.zeros_like(r2))
        if counts is not None:
            counts.setdefault("brighter", []).append(brighter.sum())
            counts.setdefault("weighted", []).append((w != 0).sum())
        yield s, e, w


def firefly_attraction_plain(pos: torch.Tensor, fit: torch.Tensor,
                             beta0: float = BETA0, gamma: float = GAMMA,
                             pos_j: Optional[torch.Tensor] = None,
                             fit_j: Optional[torch.Tensor] = None,
                             counts=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, [N, D] f32, on any device.
    ``counts`` (a dict) collects the brighter pairs and the pairs of
    nonzero weight, the work that depends on the data."""
    if pos_j is None:
        pos_j, fit_j = pos, fit
    out = torch.empty_like(pos)
    xj = pos_j.to(torch.float64)
    for s, e, w in _weights(pos, fit, beta0, gamma, pos_j, fit_j, counts):
        w64 = w.to(torch.float64)
        acc = (w64 @ xj).to(pos.dtype)
        wsum = w64.sum(dim=1, keepdim=True).to(pos.dtype)
        out[s:e] = acc - wsum * pos[s:e]
    return out


def attraction_abs_sum(pos: torch.Tensor, fit: torch.Tensor,
                       beta0: float = BETA0, gamma: float = GAMMA,
                       pos_j: Optional[torch.Tensor] = None,
                       fit_j: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, D] float64 ``sum_j |W_ij x_j| + (sum_j W_ij) |x_i|``, which the
    band of :func:`attraction_band` multiplies."""
    if pos_j is None:
        pos_j, fit_j = pos, fit
    out = torch.empty(pos.shape, dtype=torch.float64, device=pos.device)
    xj = pos_j.abs().to(torch.float64)
    for s, e, w in _weights(pos, fit, beta0, gamma, pos_j, fit_j, None):
        w64 = w.to(torch.float64)
        out[s:e] = w64 @ xj + w64.sum(dim=1, keepdim=True) * pos[s:e].abs()
    return out


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("firefly_fused").dsa_firefly_attraction_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def firefly_attraction_cuda(pos: torch.Tensor, fit: torch.Tensor,
                            beta0: float = BETA0, gamma: float = GAMMA,
                            pos_j: Optional[torch.Tensor] = None,
                            fit_j: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch the CUDA kernel on ``pos`` [N, D] and ``fit`` [N] (and the
    sources ``pos_j`` [N_j, D], ``fit_j`` [N_j]), float32, contiguous, on
    one CUDA device, 1 <= D <= 128.  Returns the move [N, D] without
    waiting for the kernel."""
    global LAUNCHES
    if pos_j is None:
        pos_j, fit_j = pos, fit
    if pos.device.type != "cuda":
        raise ValueError("firefly_attraction_cuda needs CUDA tensors, got "
                         f"{pos.device}")
    if pos.ndim != 2 or pos_j.ndim != 2 or pos_j.shape[1] != pos.shape[1]:
        raise ValueError("firefly_attraction_cuda takes [N, D] and [N_j, D] "
                         f"positions, got {tuple(pos.shape)} and "
                         f"{tuple(pos_j.shape)}")
    n, dim = pos.shape
    nj = pos_j.shape[0]
    for label, t, shape in (("pos", pos, (n, dim)), ("fit", fit, (n,)),
                            ("pos_j", pos_j, (nj, dim)),
                            ("fit_j", fit_j, (nj,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"firefly_attraction_cuda: {label} must be "
                             f"{shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"firefly_attraction_cuda: {label} must be "
                            f"float32, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"firefly_attraction_cuda: {label} lies on "
                             f"{t.device}, pos on {pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"firefly_attraction_cuda: {label} must be "
                             "contiguous")
    if not lanes_per_row(dim):
        raise ValueError(f"firefly_attraction_cuda takes 1 <= D <= {D_MAX}, "
                         f"got D = {dim}")
    if not (0 < n and 0 < nj and max(n, nj) * dim < 2**31):
        raise ValueError(f"firefly_attraction_cuda: N = {n}, N_j = {nj}, "
                         f"D = {dim} is out of range")
    out = torch.empty_like(pos)
    err = _kernel()(
        pos.data_ptr(), fit.data_ptr(), pos_j.data_ptr(), fit_j.data_ptr(),
        out.data_ptr(), n, nj, dim, float(beta0), float(-gamma),
        pos.device.index, torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"firefly kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def firefly_attraction(pos: torch.Tensor, fit: torch.Tensor,
                       beta0: float = BETA0, gamma: float = GAMMA,
                       pos_j: Optional[torch.Tensor] = None,
                       fit_j: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attraction move: the plain version on CPU tensors, the CUDA
    kernel on CUDA tensors."""
    fn = (firefly_attraction_plain if pos.device.type == "cpu"
          else firefly_attraction_cuda)
    return fn(pos, fit, beta0, gamma, pos_j, fit_j)


def fused_firefly_run(
    state: FireflyState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    beta0: float = BETA0,
    gamma: float = GAMMA,
    alpha0: float = ALPHA0,
    alpha_decay: float = ALPHA_DECAY,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> FireflyState:
    """``n_steps`` synchronous generations with the attraction on the
    kernel (one launch a generation) and the tail in PyTorch on the device,
    with no read from the device; ``noises[i]`` replaces generation i's
    walk uniforms [N, D].  The objective may be any callable."""
    require_supported(state.pos.dtype, state.pos.shape[1])
    for i in range(n_steps):
        u = firefly_draws(state) if noises is None else noises[i]
        move = firefly_attraction(state.pos, state.fit, beta0, gamma)
        state = walk_and_clip(state, move, u, objective, half_width, alpha0,
                              alpha_decay)
    return state

