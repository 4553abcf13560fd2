"""OpenAI-style evolution strategy (Salimans et al. 2017) in PyTorch.

Counterpart of ``ops/es.py`` of the JAX package.  ES carries one search
distribution (a mean and an isotropic sigma) instead of a population.  A
generation draws [n/2, D] normals, mirrors them into antithetic pairs,
evaluates the [n, D] population, shapes the fitness by centered ranks and
moves the mean by momentum SGD on ``g = shaped^T eps / (n sigma)``.

The JAX generation runs compiled, where XLA turns each division by a
static constant (the rank scale ``n - 1``, the gradient's ``n sigma``) into
a product with the f32 reciprocal, the ranks' ``- 0.5`` folded into one
multiply-add; the port computes those forms.  The normal draw can be
handed in, so a test gives both packages the same numbers.  A generation
on the card reads nothing back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device
from . import _family
from ._numerics import fma, matmul, recip_mul

SIGMA = 0.1          # perturbation scale, in half_width units
LR = 0.05            # mean learning rate, in half_width units
MOMENTUM = 0.9


@dataclass
class ESState(_family.FamilyState):
    """Search-distribution state, D dims (the population lives only inside
    a generation)."""

    mean: torch.Tensor       # [D]
    mom: torch.Tensor        # [D] momentum buffer
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar

    @property
    def device(self) -> torch.device:
        return self.mean.device


ES_TENSOR_FIELDS = _family.tensor_fields(ESState)


def es_init(
    objective: Callable,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    mean: Optional[torch.Tensor] = None,
) -> ESState:
    """``mean`` [dim] replaces the uniform draw in the domain from a
    generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    if mean is None:
        mean = _family.uniform(gen, (dim,), dtype, dev, -half_width,
                               half_width)
    return ESState(
        mean=mean, mom=torch.zeros_like(mean), best_pos=mean,
        best_fit=objective(mean[None, :])[0], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
    )


def centered_ranks(fit: torch.Tensor) -> torch.Tensor:
    """[n] centered-rank shaping in [-0.5, 0.5]: the least fitness (best,
    minimization) gets -0.5."""
    n = fit.shape[0]
    order = torch.sort(fit, stable=True).indices
    ranks = torch.empty_like(fit).scatter_(
        0, order, torch.arange(n, dtype=fit.dtype, device=fit.device))
    # Compiled: one multiply-add with f32(1 / (n - 1)).
    return fma(ranks, float(np.float32(1.0) / np.float32(n - 1)), -0.5)


def es_draws(state: ESState, n: int) -> torch.Tensor:
    """One generation's [n/2, D] standard normals from ``state.gen``."""
    return torch.randn((n // 2, state.mean.shape[0]), generator=state.gen,
                       dtype=state.mean.dtype, device=state.device)


def es_step(
    state: ESState,
    objective: Callable,
    n: int = 256,
    half_width: float = 5.12,
    sigma: float = SIGMA,
    lr: float = LR,
    momentum: float = MOMENTUM,
    eps_half: Optional[torch.Tensor] = None,
) -> ESState:
    """One generation: antithetic sampling, centered-rank shaping, a
    momentum-SGD step on the mean (``n`` even).  ``eps_half`` [n/2, D]
    replaces the normal draw from ``state.gen``."""
    s = sigma * half_width
    if eps_half is None:
        eps_half = es_draws(state, n)
    eps = torch.cat([eps_half, -eps_half], dim=0)
    pop = torch.clamp(state.mean + s * eps, -half_width, half_width)
    fit = objective(pop)

    # Descend the gradient estimate of E[f]: the best samples (the most
    # negative shaped weights) pull the mean toward their perturbations.
    grad = recip_mul(matmul(centered_ranks(fit), eps), n * s)
    mom = momentum * state.mom - lr * half_width * grad
    mean = torch.clamp(state.mean + mom, -half_width, half_width)

    b = torch.argmin(fit).reshape(1)
    cand_fit = fit.index_select(0, b)[0]
    cand_pos = pop.index_select(0, b)[0]
    mean_fit = objective(mean[None, :])[0]
    better_mean = mean_fit < cand_fit
    cand_fit = torch.where(better_mean, mean_fit, cand_fit)
    cand_pos = torch.where(better_mean, mean, cand_pos)
    improved = cand_fit < state.best_fit
    return ESState(
        mean=mean, mom=mom,
        best_pos=torch.where(improved, cand_pos, state.best_pos),
        best_fit=torch.where(improved, cand_fit, state.best_fit),
        gen=state.gen, iteration=state.iteration + 1,
    )


def es_run(
    state: ESState,
    objective: Callable,
    n_steps: int,
    n: int = 256,
    half_width: float = 5.12,
    sigma: float = SIGMA,
    lr: float = LR,
    momentum: float = MOMENTUM,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> ESState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = es_step(state, objective, n, half_width, sigma, lr, momentum,
                        eps_half=None if draws is None else draws[i])
    return state


def es_state_from_numpy(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike = None, seed: int = 0) -> ESState:
    """An ESState from numpy arrays named like its fields."""
    return _family.state_from_numpy(ESState, arrays, device, seed)


def es_state_to_numpy(state: ESState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
