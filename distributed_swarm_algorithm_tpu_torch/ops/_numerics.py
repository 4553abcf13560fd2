"""Float helpers that keep the port's arithmetic that of the JAX package.

PyTorch evaluates ``scalar / tensor`` as ``tensor.reciprocal() * scalar``,
which can differ from a true division in the last bit; JAX divides.  The
tick's discrete decisions (claim thresholds, ties) read these values, so
the port divides too.
"""

from __future__ import annotations

import torch


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE division per element."""
    return torch.full_like(den, num) / den


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, ``sqrt(sum(x * x))``, as
    ``jnp.linalg.norm`` computes it."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))
