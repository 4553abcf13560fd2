"""Artificial bee colony (Karaboga's ABC) in plain PyTorch.

Counterpart of ``ops/abc.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/abc_fused.py``.

One cycle updates every food source at once:
  - employed bees: each source mutates one random dimension against a
    random partner, ``v = x_b + phi (x_b - x_k)``, kept if strictly better;
  - onlooker bees: S onlookers pick sources in proportion to their
    quality (one categorical sample each) and mutate them; among onlookers
    of one source the best candidate wins, ties to the lowest onlooker row;
  - scouts: sources whose trial counter passed ``limit`` re-randomize.
Trial counters: an accepted probe sets 0, a rejected one adds 1, a source
no onlooker probed keeps its counter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import rdiv
from .cuckoo import egg_drop


@dataclass
class ABCState(_family.FamilyState):
    """S food sources in D dims; one employed bee per source."""

    pos: torch.Tensor        # [S, D]
    fit: torch.Tensor        # [S] raw objective values (lower is better)
    trials: torch.Tensor     # [S] i32 stagnation counters
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


ABC_TENSOR_FIELDS = _family.tensor_fields(ABCState)

# One mutation's draws: the partner draw [S] in [0, S - 1) (bumped past the
# base row), the dimension [S] in [0, D) and phi [S] in [-1, 1).
MutateDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# One cycle's draws: the employed mutation's, the onlookers' chosen sources
# [S], the onlooker mutation's and the scouts' fresh positions [S, D].
ABCDraws = Tuple[MutateDraws, torch.Tensor, MutateDraws, torch.Tensor]


def quality(fit: torch.Tensor) -> torch.Tensor:
    """Source quality, monotone decreasing in raw fitness, any sign:
    ``1 / (1 + max(f, 0)) + max(-f, 0)``."""
    zero = torch.zeros_like(fit)
    return (rdiv(1.0, 1.0 + torch.maximum(fit, zero))
            + torch.maximum(-fit, zero))


def abc_init(
    objective: Callable,
    n_sources: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> ABCState:
    gen, pos, fit = _family.init_population(objective, n_sources, dim,
                                            half_width, seed, dtype, device)
    b = torch.argmin(fit)
    return ABCState(
        pos=pos, fit=fit,
        trials=torch.zeros((n_sources,), dtype=torch.int32,
                           device=pos.device),
        best_pos=pos[b], best_fit=fit[b], gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def mutate_draws(gen: torch.Generator, s: int, d: int, dtype,
                 device) -> MutateDraws:
    """One mutation's draws from ``gen``."""
    return (torch.randint(0, s - 1, (s,), generator=gen, device=device),
            torch.randint(0, d, (s,), generator=gen, device=device),
            -1.0 + 2.0 * torch.rand((s,), generator=gen, dtype=dtype,
                                    device=device))


def mutate(pos: torch.Tensor, base_idx: torch.Tensor, half_width: float,
           draws: MutateDraws) -> torch.Tensor:
    """``v = x_b + onehot(j) (phi (x_b - x_k))``, clipped: ONE dimension of
    each row moves against a partner ``k != b``."""
    s, d = pos.shape
    draw, j, phi = draws
    base_idx = base_idx.long()
    base = pos[base_idx]
    draw = draw.long()
    partner = torch.where(draw >= base_idx, draw + 1, draw)
    onehot = torch.nn.functional.one_hot(j.long(), d).to(pos.dtype)
    cand = base + onehot * (phi[:, None] * (base - pos[partner]))
    return torch.clamp(cand, -half_width, half_width)


def greedy(pos, fit, trials, cand, cand_fit):
    """Keep the candidate where strictly better: trials 0 there, + 1
    elsewhere."""
    better = cand_fit < fit
    return (torch.where(better[:, None], cand, pos),
            torch.where(better, cand_fit, fit),
            torch.where(better, torch.zeros_like(trials), trials + 1))


def abc_step(
    state: ABCState,
    objective: Callable,
    half_width: float = 5.12,
    limit: int = 20,
    draws: Optional[ABCDraws] = None,
) -> ABCState:
    """One ABC cycle, with no read from the device: employed, onlooker and
    scout phases.  ``draws`` replaces the draws from ``state.gen`` (see
    ``ABCDraws``)."""
    s, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen

    # --- employed bees: one candidate per source ------------------------
    ident = torch.arange(s, device=dev)
    emp = (mutate_draws(gen, s, d, dt, dev) if draws is None
           else draws[0])
    cand = mutate(state.pos, ident, half_width, emp)
    pos, fit, trials = greedy(state.pos, state.fit, state.trials, cand,
                              objective(cand))

    # --- onlooker bees: recruit sources by quality, mutate them ---------
    if draws is None:
        chosen = torch.multinomial(quality(fit) + 1e-12, s, replacement=True,
                                   generator=gen)
        onl = mutate_draws(gen, s, d, dt, dev)
        fresh = -half_width + 2.0 * half_width * torch.rand(
            (s, d), generator=gen, dtype=dt, device=dev)
    else:
        _, chosen, onl, fresh = draws
    chosen = chosen.long()
    cand = mutate(pos, chosen, half_width, onl)
    # Onlookers of one source: the best candidate wins, ties to the lowest
    # onlooker row; a source no onlooker chose sees +inf and rejects.
    accept_src, src_cand, seg_best = egg_drop(cand, objective(cand), chosen,
                                              fit)
    probed = torch.zeros(s, dtype=torch.bool, device=dev).index_fill(
        0, chosen, True)
    pos = torch.where(accept_src[:, None], src_cand, pos)
    trials = torch.where(accept_src, torch.zeros_like(trials),
                         torch.where(probed, trials + 1, trials))
    fit = torch.where(accept_src, seg_best, fit)

    # --- scout bees: abandon exhausted sources --------------------------
    exhausted = trials > limit
    pos = torch.where(exhausted[:, None], fresh, pos)
    fit = torch.where(exhausted, objective(fresh), fit)
    trials = torch.where(exhausted, torch.zeros_like(trials), trials)

    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return ABCState(pos=pos, fit=fit, trials=trials, best_pos=best_pos,
                    best_fit=best_fit, gen=state.gen,
                    iteration=state.iteration + 1)


def abc_run(
    state: ABCState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    limit: int = 20,
    draws: Optional[Sequence[ABCDraws]] = None,
) -> ABCState:
    """``n_steps`` cycles; ``draws[i]`` replaces cycle i's."""
    for i in range(n_steps):
        state = abc_step(state, objective, half_width, limit,
                         draws=None if draws is None else draws[i])
    return state


def abc_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> ABCState:
    """An ABCState from numpy arrays named like its fields."""
    return _family.state_from_numpy(ABCState, arrays, device, seed)


def abc_state_to_numpy(state: ABCState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
