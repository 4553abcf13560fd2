"""Shared helpers for the fused-kernel modules (the port's own copy of
``ops/pallas/common.py`` of the JAX package)."""

from __future__ import annotations

import torch


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m


def cyclic_pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad a [N, ...] float tensor to ``n_pad`` rows by duplicating the
    leading rows cyclically (as float32).

    The invariant every fused run relies on: duplicates are legal
    population members, so the population optimum is preserved: the min
    over a multiset superset of the real members cannot be worse, and the
    padding is sliced off on return.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    if n_pad < n:
        raise ValueError(
            f"cyclic_pad_rows: n_pad={n_pad} < n={n} would silently drop "
            "population members; callers must pass n_pad >= x.shape[0]"
        )
    if n_pad == n:
        return x
    reps = -(-n_pad // n)
    return x.repeat((reps,) + (1,) * (x.ndim - 1))[:n_pad]
