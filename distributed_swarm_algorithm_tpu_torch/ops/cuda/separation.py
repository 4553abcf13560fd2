"""Exact all-pairs separation without pairwise intermediates.

Replaces the TPU kernel ``ops/pallas/separation.py:separation_pallas`` of
the JAX package.  ``separation_mode="pallas"`` keeps its name in the config
because users already pass it; on this port it means this module:

- :func:`separation_cuda` launches the hand-written CUDA kernel
  ``csrc/separation.cu`` (built on first use by ``_build.py``) on a CUDA
  tensor and raises on anything else;
- :func:`separation_plain` is the same function in plain PyTorch, chunked
  over receiver rows so that it runs at N = 65,536 on the card (the
  unchunked ``[N, N, D]`` broadcast would need 34 GB there);
- :func:`separation` is the tick's entry: the plain version for a CPU
  tensor, the kernel for a CUDA tensor.  A kernel that fails to build or
  launch raises; nothing falls back.

    near(i,j) = alive_i & alive_j & i != j & d2(i,j) < personal_space^2
    f_i       = sum_j near * k_sep * (p_i - p_j) * rsqrt(max(d2, eps^2))^3

The kernel is bound by operations, not bytes.  One call is one launch: a
fast path pays each pair's squared distance and cut, a warp votes once per
group of 32 senders, and only a group that holds a near pair (or the
receiver itself) computes the force, in sender order; ``csrc/separation.cu``
says why.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel since the count was last set to 0.  Only
# separation_cuda adds to it, once per launch.
LAUNCHES = 0

# Receiver rows per chunk of the plain version: rows * N stays near 2^24
# pair elements, a few hundred MB of temporaries.
_PLAIN_PAIRS_PER_CHUNK = 1 << 24

_fn = None   # the C entry, bound at the first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("separation").dsa_separation_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _pair_terms(pos, alive, k_sep, personal_space, eps):
    """Yield ``(s, e, terms)``: the ``[e - s, N, D]`` force terms of
    receivers ``s:e`` from every sender, one chunk of rows at a time."""
    n, dim = pos.shape
    alive = alive.bool()
    r2_cut = float(personal_space) ** 2
    eps2 = float(eps) ** 2
    ids = torch.arange(n, device=pos.device)
    rows = max(1, _PLAIN_PAIRS_PER_CHUNK // max(n, 1))
    for s in range(0, n, rows):
        e = min(n, s + rows)
        diff = pos[s:e, None, :] - pos[None, :, :]          # [c, N, D]
        d2 = diff[..., 0] * diff[..., 0]
        for d in range(1, dim):                          # in axis order
            d2 = d2 + diff[..., d] * diff[..., d]
        near = (
            (ids[s:e, None] != ids[None, :])
            & (d2 < r2_cut)
            & alive[s:e, None]
            & alive[None, :]
        )
        inv = torch.rsqrt(d2.clamp(min=eps2))
        mag = torch.where(near, k_sep * inv * inv * inv, 0.0)
        yield s, e, mag[..., None] * diff


def separation_plain(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, [N, D], on any device."""
    out = torch.empty_like(pos)
    for s, e, terms in _pair_terms(pos, alive, k_sep, personal_space, eps):
        out[s:e] = terms.sum(1)
    return out


def separation_abs_sum(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
) -> torch.Tensor:
    """``sum_j |term_ij|`` per receiver and axis, [N, D].  Two sums of the
    same f32 terms in different orders, with terms that differ by a few
    ulps, differ by a small multiple of this; the kernel is held against
    the plain version relative to it."""
    out = torch.empty_like(pos)
    for s, e, terms in _pair_terms(pos, alive, k_sep, personal_space, eps):
        out[s:e] = terms.abs().sum(1)
    return out


def separation_cuda(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
) -> torch.Tensor:
    """Launch the CUDA kernel (one launch) on ``pos`` [N, D] f32 (D = 2 or
    3) and ``alive`` [N] bool or uint8, contiguous, on one CUDA device.
    Returns the force [N, D] f32 without waiting for the kernel."""
    global LAUNCHES
    if pos.device.type != "cuda":
        raise ValueError(f"separation_cuda needs a CUDA tensor, got {pos.device}")
    if pos.dtype != torch.float32:
        raise TypeError(f"separation_cuda takes float32 positions, got {pos.dtype}")
    if pos.ndim != 2 or pos.shape[1] not in (2, 3):
        raise ValueError(
            f"separation_cuda takes [N, 2] or [N, 3] positions, got "
            f"{tuple(pos.shape)}"
        )
    n, dim = pos.shape
    if alive.shape != (n,) or alive.dtype not in (torch.bool, torch.uint8):
        raise ValueError(
            f"separation_cuda takes an [{n}] bool or uint8 alive mask, got "
            f"{tuple(alive.shape)} {alive.dtype}"
        )
    if alive.device != pos.device:
        raise ValueError("pos and alive lie on different devices")
    if not (pos.is_contiguous() and alive.is_contiguous()):
        raise ValueError("separation_cuda takes contiguous tensors")
    if n >= 2**31 // dim:
        raise ValueError(f"separation_cuda: N = {n} overflows int32 offsets")
    out = torch.empty_like(pos)
    if n == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = fn(
        pos.data_ptr(), alive.data_ptr(), out.data_ptr(), n, dim,
        float(k_sep), float(personal_space) ** 2, float(eps) ** 2,
        pos.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"separation kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def separation(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
) -> torch.Tensor:
    """The tick's separation for ``separation_mode="pallas"``: the plain
    version on a CPU tensor, the CUDA kernel on a CUDA tensor."""
    if pos.device.type == "cpu":
        return separation_plain(pos, alive, k_sep, personal_space, eps)
    return separation_cuda(pos, alive, k_sep, personal_space, eps)
