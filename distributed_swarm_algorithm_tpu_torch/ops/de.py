"""Differential evolution (Storn & Price 1997) in plain PyTorch.

Counterpart of ``ops/de.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/de_fused.py``.

Update rule (``rand/1/bin``; ``best/1/bin`` swaps the base vector):
    mutant  = x_a + F * (x_b - x_c)           a, b, c distinct, != i
    trial_j = mutant_j  if r_j < CR or j == j_rand  else  x_ij
    x_i'    = trial     if f(trial) <= f(x_i) else  x_i
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family

# Classic defaults (Storn & Price).
F = 0.5
CR = 0.9


@dataclass
class DEState(_family.FamilyState):
    """Struct-of-tensors DE population. N individuals, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


DE_TENSOR_FIELDS = _family.tensor_fields(DEState)

# One generation's draws: the donor indices a, b, c [N], the crossover
# uniforms r [N, D] and the forced-crossover column j_rand [N].
DEDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def distinct3(gen: torch.Generator, n: int, device) -> Tuple[torch.Tensor,
                                                              ...]:
    """Three index vectors ``a, b, c`` with ``{a_i, b_i, c_i, i}`` all
    distinct for every row i, uniform without rejection: each is drawn from
    a shrunken range and bumped past the (sorted) indices already taken
    (the JAX package's ``_distinct3``)."""
    i = torch.arange(n, device=device)

    def draw(high):
        return torch.randint(0, high, (n,), generator=gen, device=device)

    a = draw(n - 1)
    a = a + (a >= i).long()
    lo, hi = torch.minimum(i, a), torch.maximum(i, a)
    b = draw(n - 2)
    b = b + (b >= lo).long()
    b = b + (b >= hi).long()
    e = torch.sort(torch.stack([i, a, b]), dim=0).values
    c = draw(n - 3)
    for row in e:
        c = c + (c >= row).long()
    return a, b, c


def de_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> DEState:
    if n < 4:
        raise ValueError("DE needs a population of at least 4")
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    return DEState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def de_draws(state: DEState) -> DEDraws:
    """One generation's draws from ``state.gen``."""
    n, d = state.pos.shape
    dev, gen = state.device, state.gen
    a, b, c = distinct3(gen, n, dev)
    r = torch.rand((n, d), generator=gen, dtype=state.pos.dtype, device=dev)
    j_rand = torch.randint(0, d, (n,), generator=gen, device=dev)
    return a, b, c, r, j_rand


def de_step(
    state: DEState,
    objective: Callable,
    f: float = F,
    cr: float = CR,
    half_width: float = 5.12,
    variant: str = "rand1bin",
    draws: Optional[DEDraws] = None,
) -> DEState:
    """One DE generation, with no read from the device.  ``draws = (a, b,
    c, r, j_rand)`` replaces the draws from ``state.gen``."""
    if variant not in ("rand1bin", "best1bin"):
        raise ValueError(f"unknown DE variant {variant!r}")
    n, d = state.pos.shape
    a, b, c, r, j_rand = de_draws(state) if draws is None else draws
    pos = state.pos
    if variant == "rand1bin":
        base = pos[a.long()]
    else:
        base = state.best_pos.expand_as(pos)
    mutant = torch.clamp(base + f * (pos[b.long()] - pos[c.long()]),
                         -half_width, half_width)
    cols = torch.arange(d, device=pos.device)[None, :]
    cross = (r < cr) | (cols == j_rand.long()[:, None])
    trial = torch.where(cross, mutant, pos)

    trial_fit = objective(trial)
    better = trial_fit <= state.fit
    pos = torch.where(better[:, None], trial, pos)
    fit = torch.where(better, trial_fit, state.fit)
    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return DEState(pos=pos, fit=fit, best_pos=best_pos, best_fit=best_fit,
                   gen=state.gen, iteration=state.iteration + 1)


def de_run(
    state: DEState,
    objective: Callable,
    n_steps: int,
    f: float = F,
    cr: float = CR,
    half_width: float = 5.12,
    variant: str = "rand1bin",
    draws: Optional[Sequence[DEDraws]] = None,
) -> DEState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = de_step(state, objective, f, cr, half_width, variant,
                        draws=None if draws is None else draws[i])
    return state


def de_state_from_numpy(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike = None, seed: int = 0) -> DEState:
    """A DEState from numpy arrays named like its fields."""
    return _family.state_from_numpy(DEState, arrays, device, seed)


def de_state_to_numpy(state: DEState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
