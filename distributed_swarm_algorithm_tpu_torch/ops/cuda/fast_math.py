"""The JAX package's fast-math primitives as plain PyTorch: the twin of
``csrc/fast_math.cuh``.

The TPU kernels build their transcendentals from bit fields and short
polynomials (``ops/pallas/firefly_fused.py``: ``_exp2_poly``,
``exp2_fast``, ``_exp_fast``; ``ops/pallas/cuckoo_fused.py``:
``_LOG2_C``, ``_log2_fast``, ``_normal_pair``).  The fused kernels of the
port evaluate the same polynomials with one IEEE product and one sum per
Horner step, and these plain versions do so in the same order, so kernel
and plain version agree bit for bit.  XLA on the CPU contracts the Horner
steps into multiply-adds, so against JAX they agree within a few ulps of
each polynomial's largest term.
"""

from __future__ import annotations

import torch

from .pso_fused import _cos2pi, _sin2pi

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# log2(m) on m in [1, 2): degree-6 polynomial (descending), max abs err
# 6.0e-6 through f32 Horner.
LOG2_C = (
    -0.024825585616, 0.266858603621, -1.234262243474, 3.218830782097,
    -5.264107973620, 6.065828547204, -3.028317064600,
)


def exp2_poly(f):
    """2^f for f in [-0.5, 0.5]: degree-5 polynomial (Horner), max rel
    err 3.7e-7 through f32."""
    c0 = 1.000000052277
    c1 = 0.693147200062
    c2 = 0.240222117415
    c3 = 0.055503406814
    c4 = 0.009670762865
    c5 = 0.001339527949
    return c0 + f * (c1 + f * (c2 + f * (c3 + f * (c4 + f * c5))))


def exp2_fast(t):
    """2^t: round to n + f (half to even), the exponent-field bit
    construction of 2^n times the 2^f polynomial; exactly 0 below the f32
    normal range."""
    n = torch.round(t)
    f = t - n
    ni = torch.clamp(n, -126.0, 126.0).to(torch.int32)
    two_n = ((ni + 127) << 23).view(torch.float32)
    val = two_n * exp2_poly(f)
    return torch.where(t < -126.0, torch.zeros_like(val), val)


def exp_fast(x):
    """exp(x) via 2^(x*log2e)."""
    return exp2_fast(x * LOG2E)


def log2_fast(x: torch.Tensor) -> torch.Tensor:
    """log2(x) for x > 0: the exponent bit field plus the mantissa
    polynomial, Horner from the highest coefficient."""
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    mant = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    p = torch.full_like(x, LOG2_C[0])
    for c in LOG2_C[1:]:
        p = p * mant + c
    return e.to(torch.float32) + p


def normal_pair(u1: torch.Tensor, u2: torch.Tensor):
    """Two standard normals by Box-Muller from two U[0, 1) draws, as the
    JAX package's ``_normal_pair`` builds them: ``r = sqrt(-2 ln 2 *
    log2(1 - u1))`` (``1 - u1`` in (0, 1], so the log never sees 0; the
    constant ``-2 ln 2`` folded into one f32, as JAX folds the Python
    product), then ``(r cos 2 pi u2, r sin 2 pi u2)``."""
    r = torch.sqrt((-2.0 * LN2) * log2_fast(1.0 - u1))
    return r * _cos2pi(u2), r * _sin2pi(u2)


def levy_power(n2: torch.Tensor, inv_beta: float) -> torch.Tensor:
    """``|n2|^(-1/beta)`` as the fused kernels compute the Mantegna step's
    denominator: ``2^(-inv_beta * log2(|n2| + 1e-12))``."""
    return exp2_fast(-inv_beta * log2_fast(torch.abs(n2) + 1e-12))
