"""Float helpers that keep the port's arithmetic that of the JAX package.

PyTorch evaluates ``scalar / tensor`` as ``tensor.reciprocal() * scalar``,
which can differ from a true division in the last bit; JAX divides.  The
tick's discrete decisions (claim thresholds, ties) read these values, so
the port divides too.
"""

from __future__ import annotations

import numpy as np
import torch


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE division per element."""
    return torch.full_like(den, num) / den


def div(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x / y`` as one IEEE division per element (on the card PyTorch
    multiplies by the reciprocal of a Python scalar)."""
    return x / torch.full((), y, dtype=x.dtype, device=x.device)


def recip_mul(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a static constant ``c`` as XLA compiles it under
    ``jit``: a product with the f32 reciprocal of f32(c).  Where a compiled
    JAX step divides by a constant and a discrete result reads the
    quotient (a cell index, a rank), the port computes this form."""
    return x * float(np.float32(1.0) / np.float32(c))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full f32 on the card: TF32 off for the call (the
    tensor cores otherwise round f32 inputs to 10-bit mantissas)."""
    if a.device.type != "cuda":
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in full f32 on the card: TF32 off for the call, as
    :func:`matmul`."""
    if ops[0].device.type != "cuda":
        return torch.einsum(eq, *ops)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum(eq, *ops)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, through f64: PyTorch's on the
    CPU is not, for about 0.7% of f32 inputs; XLA's and the card's are."""
    return torch.sqrt(x.double()).to(x.dtype)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, ``sqrt(sum(x * x))``, as
    ``jnp.linalg.norm`` computes it."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as a fused multiply-add, for f32 inputs
    (``b`` and ``c`` tensors or Python floats that f32 holds exactly).

    The product of two f32 values is exact in f64, so the f64 sum rounded
    to f32 is the fused result, except where the f64 rounding lands on an
    f32 tie (about one case in 2^29).  XLA on the CPU contracts these
    forms, and the hashgrid path takes discrete decisions (the Verlet
    trigger, the cut at the personal space) on them."""
    f64 = lambda v: v.double() if torch.is_tensor(v) else v  # noqa: E731
    return (a.double() * f64(b) + f64(c)).to(a.dtype)


def monotone(bits: torch.Tensor, mask: int) -> torch.Tensor:
    """Signed integers ordered as the floats whose bits they hold, in the
    total order ``lax.top_k`` compares by (``-0`` below ``+0``)."""
    return torch.where(bits < 0, bits ^ mask, bits)


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [k]: the indices ``lax.top_k(x, k)`` returns for a float32 or
    float64 vector ``x``: the k largest entries, largest first, in the
    floats' total order (``-0`` below ``+0``), equal entries in index
    order.  One stable sort of the monotone bits, on the device."""
    if x.dtype == torch.float64:
        mono = monotone(x.contiguous().view(torch.int64), 0x7FFFFFFFFFFFFFFF)
    else:
        mono = monotone(x.to(torch.float32).contiguous().view(torch.int32),
                        0x7FFFFFFF)
    return torch.sort(mono, descending=True, stable=True).indices[:k]


def sq_norm2(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dx^2 + dy^2`` as XLA on the CPU rounds ``sum(d * d, -1)`` and
    ``jnp.linalg.norm`` over a last axis of two: ``fma(dy, dy, dx * dx)``."""
    return fma(dy, dy, dx * dx)


def mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod(x, y)`` for floats: ``fmod`` plus ``y`` where the signs of
    the remainder and ``y`` differ.  Exact, like the JAX form."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def torus_wrap(d: torch.Tensor, hw: float) -> torch.Tensor:
    """Minimum image on the torus ``[-hw, hw)``, mod form:
    ``mod(d + hw, 2 hw) - hw``."""
    return mod(d + hw, 2.0 * hw) - hw


def wrap_select(d: torch.Tensor, hw: float) -> torch.Tensor:
    """Minimum image, select form: exact for ``|d| < 2 hw`` and inert on
    the 1e18 sentinel (``1e18 - 2 hw`` rounds back to 1e18 in f32)."""
    two_hw = 2.0 * hw
    return torch.where(d >= hw, d - two_hw,
                       torch.where(d < -hw, d + two_hw, d))
