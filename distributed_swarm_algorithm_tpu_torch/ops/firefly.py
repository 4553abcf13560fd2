"""Firefly algorithm (Yang 2008) in plain PyTorch.

Counterpart of ``ops/firefly.py`` of the JAX package: the portable path, on
any device, for any callable objective.  The fused path, whose all-pairs
attraction runs in a CUDA kernel, is ``ops/cuda/firefly_fused.py``.

The synchronous (generation-at-once) variant: every move is computed from
the generation's starting positions and applied together.  For firefly i
and every brighter j (``f_j < f_i``):

    x_i += sum_j beta0 exp(-gamma r_ij^2) (x_j - x_i)
           + alpha_t (u - 0.5) 2 half_width,   u ~ U(0, 1)^D

with ``alpha_t = alpha0 decay^t``.  The interaction is the JAX package's
two products: squared distances by the Gram identity, then
``move = W @ X - rowsum(W) X`` with ``W = brighter * attraction``.  It holds
the [N, N] weight matrix, so it serves small swarms; the fused path keeps
no pairwise temporary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family

# Yang's canonical defaults.
BETA0 = 1.0
GAMMA = 1.0
ALPHA0 = 0.25
ALPHA_DECAY = 0.97


@dataclass
class FireflyState(_family.FamilyState):
    """Struct-of-tensors firefly swarm. N fireflies, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]  (lower is better; brightness = -fit)
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


FIREFLY_TENSOR_FIELDS = _family.tensor_fields(FireflyState)


def firefly_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> FireflyState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return FireflyState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def firefly_draws(state: FireflyState) -> torch.Tensor:
    """One generation's walk uniforms [N, D] from ``state.gen``."""
    return torch.rand(state.pos.shape, generator=state.gen,
                      dtype=state.pos.dtype, device=state.device)


def alpha_at(state: FireflyState, alpha0: float,
             alpha_decay: float) -> torch.Tensor:
    """``alpha0 decay^t`` at the state's iteration, in the state's dtype."""
    dt = state.pos.dtype
    decay = torch.full((), alpha_decay, dtype=dt, device=state.device)
    return alpha0 * torch.pow(decay, state.iteration.to(dt))


def walk_and_clip(state: FireflyState, move: torch.Tensor, u: torch.Tensor,
                  objective: Callable, half_width: float, alpha0: float,
                  alpha_decay: float) -> FireflyState:
    """The generation's tail shared by both paths: the decayed random walk,
    the clip, the objective and the incumbent."""
    noise = alpha_at(state, alpha0, alpha_decay) * (u - 0.5) * (
        2.0 * half_width)
    # The global brightest has no j to chase; it still random-walks, and
    # best_pos archives the optimum so the walk never loses it.
    pos = torch.clamp(state.pos + move + noise, -half_width, half_width)
    fit = objective(pos)
    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return FireflyState(pos=pos, fit=fit, best_pos=best_pos,
                        best_fit=best_fit, gen=state.gen,
                        iteration=state.iteration + 1)


def firefly_step(
    state: FireflyState,
    objective: Callable,
    half_width: float = 5.12,
    beta0: float = BETA0,
    gamma: float = GAMMA,
    alpha0: float = ALPHA0,
    alpha_decay: float = ALPHA_DECAY,
    noise: Optional[torch.Tensor] = None,
) -> FireflyState:
    """One synchronous generation: all-pairs attraction and the random
    walk.  ``noise`` [N, D] replaces the walk's uniforms from
    ``state.gen``."""
    u = firefly_draws(state) if noise is None else noise
    pos, fit = state.pos, state.fit
    sq = torch.sum(pos * pos, dim=1)                        # [N]
    r2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
    attract = beta0 * torch.exp(-gamma * torch.clamp(r2, min=0.0))
    brighter = fit[None, :] < fit[:, None]                  # j brighter
    w = torch.where(brighter, attract, torch.zeros_like(attract))
    move = w @ pos - torch.sum(w, dim=1, keepdim=True) * pos
    return walk_and_clip(state, move, u, objective, half_width, alpha0,
                         alpha_decay)


def firefly_run(
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
    """``n_steps`` generations; ``noises[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = firefly_step(state, objective, half_width, beta0, gamma,
                             alpha0, alpha_decay,
                             noise=None if noises is None else noises[i])
    return state


def firefly_state_from_numpy(arrays: Mapping[str, np.ndarray],
                             device: DeviceLike = None, seed: int = 0
                             ) -> FireflyState:
    """A FireflyState from numpy arrays named like its fields."""
    return _family.state_from_numpy(FireflyState, arrays, device, seed)


def firefly_state_to_numpy(state: FireflyState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
