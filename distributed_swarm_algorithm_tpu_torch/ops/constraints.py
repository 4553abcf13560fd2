"""Constraint handling for the optimizer toolkit: penalty composition.

Counterpart of ``ops/constraints.py`` of the JAX package.  Every family
takes a batched objective callable, so constraints compose as objective
wrappers:

    from distributed_swarm_algorithm_tpu_torch.ops.constraints import penalized
    obj = penalized(sphere, inequalities=[lambda x: 1.0 - x[:, 0]])
    PSO(obj, n=256, dim=4).run(500)     # converges to the x0 >= 1 face

The wrapper is batched elementwise math ([K, D] -> [K]); the quadratic
penalty keeps the landscape smooth (exterior penalty method), which the
memetic path needs: it refines through autograd of the wrapped objective.

Conventions: inequalities are feasible when g(x) <= 0; equalities when
|h(x)| <= tol.  ``rho`` trades constraint sharpness against landscape
conditioning.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["penalized", "violation", "feasible_mask"]


def violation(
    x: torch.Tensor,
    inequalities: Sequence[Callable] = (),
    equalities: Sequence[Callable] = (),
) -> torch.Tensor:
    """[K] total constraint violation: sum of max(g(x), 0) over
    inequalities plus |h(x)| over equalities (zero iff feasible)."""
    total = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for g in inequalities:
        total = total + torch.clamp(g(x), min=0.0)
    for h in equalities:
        total = total + torch.abs(h(x))
    return total


def penalized(
    objective: Callable,
    inequalities: Sequence[Callable] = (),
    equalities: Sequence[Callable] = (),
    rho: float = 1e3,
) -> Callable:
    """Exterior quadratic-penalty objective: f(x) + rho * (sum of
    max(g, 0)^2 + sum of h^2).  Batched [K, D] -> [K]; composes with
    every optimizer family and stays differentiable for the memetic
    path."""
    ineqs = tuple(inequalities)
    eqs = tuple(equalities)

    def wrapped(x):
        val = objective(x)
        pen = torch.zeros_like(val)
        for g in ineqs:
            pen = pen + torch.clamp(g(x), min=0.0) ** 2
        for h in eqs:
            pen = pen + h(x) ** 2
        return val + rho * pen

    return wrapped


def feasible_mask(
    x: torch.Tensor,
    inequalities: Sequence[Callable] = (),
    equalities: Sequence[Callable] = (),
    tol: float = 1e-6,
) -> torch.Tensor:
    """[K] bool: points satisfying every constraint within ``tol``."""
    return violation(x, inequalities, equalities) <= tol
