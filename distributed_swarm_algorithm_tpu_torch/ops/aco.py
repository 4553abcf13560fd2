"""Ant colony optimization for the travelling salesman problem, in plain
PyTorch.

Counterpart of ``ops/aco.py`` of the JAX package: the portable path, on any
device.  The fused path, whose tour construction and deposit run in CUDA
kernels, is ``ops/cuda/aco_fused.py``.

Ant System / Ant Colony System (Dorigo et al.), the colony vectorized: all
ants take each construction step at once.  The carry is ``(current city
[A], visited [A, C])``; a step gathers each ant's row of log-space scores,
samples the next city among the unvisited ones by Gumbel-argmax
(categorical sampling without normalization) and marks it visited.  An ant
exploits instead (pure argmax, the ACS rule) with probability ``q0``.
Evaporation and deposit are one scatter-add over the [C, C] pheromone
matrix, both edge directions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import div, rdiv

_EPS = 1e-10
_NEG = -1e30


@dataclass
class ACOState(_family.FamilyState):
    """Colony state for one TSP instance."""

    tau: torch.Tensor        # [C, C] pheromone
    dist: torch.Tensor       # [C, C] edge lengths (0 diagonal)
    best_tour: torch.Tensor  # [C] int32 city indices of the best-so-far tour
    best_len: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar

    @property
    def device(self) -> torch.device:
        return self.tau.device


ACO_TENSOR_FIELDS = _family.tensor_fields(ACOState)

# One construction's draws: the start cities [A] (int), the Gumbel noise
# [C - 1, A, C] of each step and the exploit uniforms [C - 1, A].
TourDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def tour_lengths(dist: torch.Tensor, tours: torch.Tensor) -> torch.Tensor:
    """[A] closed-tour lengths for [A, C] city-index tours."""
    t = tours.long()
    nxt = torch.roll(t, -1, dims=1)
    return torch.sum(dist[t, nxt], dim=1)


def coords_to_dist(coords: torch.Tensor) -> torch.Tensor:
    """Euclidean [C, C] distance matrix from [C, D] coordinates."""
    diff = coords[:, None, :] - coords[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + 0.0)


def aco_init(
    dist: torch.Tensor,
    seed: int = 0,
    tau0: Optional[float] = None,
) -> ACOState:
    """Pheromone at ``tau0`` (default 1 / (C * mean edge)), on ``dist``'s
    device."""
    c = dist.shape[0]
    dev = dist.device
    if tau0 is None:
        mean_edge = div(torch.sum(dist), float(c * (c - 1)))
        tau = rdiv(1.0, c * mean_edge).expand(c, c).contiguous()
    else:
        tau = torch.full((c, c), tau0, dtype=dist.dtype, device=dev)
    return ACOState(
        tau=tau,
        dist=dist,
        best_tour=torch.arange(c, dtype=torch.int32, device=dev),
        best_len=torch.full((), float("inf"), dtype=dist.dtype, device=dev),
        gen=torch.Generator(device=dev).manual_seed(seed),
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
    )


def aco_logits(tau: torch.Tensor, dist: torch.Tensor, alpha: float,
               beta: float) -> torch.Tensor:
    """[C, C] log-space scores ``alpha log(tau + eps) + beta log(eta)``,
    ``eta = 1 / (dist + I + eps)`` (eta's fake diagonal is masked by the
    visited set)."""
    c = dist.shape[0]
    eye = torch.eye(c, dtype=dist.dtype, device=dist.device)
    eta = rdiv(1.0, dist + eye + _EPS)
    return alpha * torch.log(tau + _EPS) + beta * torch.log(eta)


def gumbel(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (0, 1)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def tour_draws(gen: torch.Generator, n_cities: int, n_ants: int, dtype,
               device) -> TourDraws:
    """One construction's draws from ``gen`` (see ``TourDraws``)."""
    c, a = n_cities, n_ants
    start = torch.randint(0, c, (a,), generator=gen, device=device)
    g = gumbel(gen, (max(c - 1, 0), a, c), dtype, device)
    u = torch.rand((max(c - 1, 0), a), generator=gen, dtype=dtype,
                   device=device)
    return start, g, u


def construct_tours(
    tau: torch.Tensor,
    dist: torch.Tensor,
    gen: torch.Generator,
    n_ants: int,
    alpha: float = 1.0,
    beta: float = 2.0,
    q0: float = 0.0,
    draws: Optional[TourDraws] = None,
) -> torch.Tensor:
    """All ants build closed tours simultaneously: [A, C] int32.

    Each step samples the next city from ``p ∝ tau^alpha eta^beta`` over the
    unvisited cities (Gumbel-argmax over row ``cur`` of the scores); with
    probability ``q0`` an ant takes the plain argmax instead.  Argmax ties
    go to the lowest city.  ``draws`` replaces the draws from ``gen``."""
    c = dist.shape[0]
    start, g, u = (tour_draws(gen, c, n_ants, dist.dtype, dist.device)
                   if draws is None else draws)
    logits = aco_logits(tau, dist, alpha, beta)
    cur = start.long()
    ants = torch.arange(n_ants, device=dist.device)
    visited = torch.zeros((n_ants, c), dtype=torch.bool, device=dist.device)
    visited[ants, cur] = True
    neg = torch.full((), _NEG, dtype=logits.dtype, device=logits.device)
    steps = [cur]
    for t in range(c - 1):
        row = torch.where(visited, neg, logits[cur])        # [A, C]
        sampled = torch.argmax(row + g[t], dim=1)
        greedy = torch.argmax(row, dim=1)
        cur = torch.where(u[t] < q0, greedy, sampled)
        visited[ants, cur] = True
        steps.append(cur)
    return torch.stack(steps, dim=1).to(torch.int32)


def deposit(
    tau: torch.Tensor,
    tours: torch.Tensor,
    lengths: torch.Tensor,
    rho: float,
    q: float = 1.0,
) -> torch.Tensor:
    """Evaporate, then scatter-add ``q / L`` onto each ant's edges, both
    directions."""
    c = tau.shape[0]
    u = tours.long()
    v = torch.roll(u, -1, dims=1)
    amount = rdiv(q, lengths)[:, None].expand(u.shape).reshape(-1)
    out = ((1.0 - rho) * tau).reshape(-1)
    out = out.index_add(0, (u * c + v).reshape(-1), amount)
    out = out.index_add(0, (v * c + u).reshape(-1), amount)
    return out.reshape(c, c)


def track_best_tour(tours: torch.Tensor, lengths: torch.Tensor,
                    state: ACOState):
    """``(best_tour, best_len)`` after an iteration, selected on the
    device: the first shortest tour replaces the incumbent where strictly
    shorter."""
    b = torch.argmin(lengths).reshape(1)     # index_select: no host read
    lb = lengths.index_select(0, b)[0]
    improved = lb < state.best_len
    return (torch.where(improved, tours.index_select(0, b)[0],
                        state.best_tour),
            torch.where(improved, lb, state.best_len))


def elite_deposit(tau: torch.Tensor, best_tour: torch.Tensor,
                  best_len: torch.Tensor, elite: float) -> torch.Tensor:
    """The elitist deposit of ``elite / L_best`` on the best-so-far tour."""
    return deposit(tau, best_tour[None, :], div(best_len[None], elite),
                   rho=0.0)


def aco_step(
    state: ACOState,
    n_ants: int,
    alpha: float = 1.0,
    beta: float = 2.0,
    rho: float = 0.1,
    q0: float = 0.0,
    elite: float = 0.0,
    draws: Optional[TourDraws] = None,
    out: Optional[dict] = None,
) -> ACOState:
    """One colony iteration: construct, evaluate, evaporate, deposit, with
    no read from the device.  ``elite > 0`` adds an elitist deposit on the
    best-so-far tour; a dict ``out`` receives the iteration's ``tours``
    [A, C] and ``lengths`` [A]."""
    tours = construct_tours(state.tau, state.dist, state.gen, n_ants, alpha,
                            beta, q0, draws=draws)
    lengths = tour_lengths(state.dist, tours)
    if out is not None:
        out.update(tours=tours, lengths=lengths)
    best_tour, best_len = track_best_tour(tours, lengths, state)
    tau = deposit(state.tau, tours, lengths, rho)
    if elite > 0.0:
        tau = elite_deposit(tau, best_tour, best_len, elite)
    return state.replace(tau=tau, best_tour=best_tour, best_len=best_len,
                         iteration=state.iteration + 1)


def aco_run(
    state: ACOState,
    n_steps: int,
    n_ants: int,
    alpha: float = 1.0,
    beta: float = 2.0,
    rho: float = 0.1,
    q0: float = 0.0,
    elite: float = 0.0,
    draws: Optional[Sequence[TourDraws]] = None,
    out: Optional[dict] = None,
) -> ACOState:
    """``n_steps`` colony iterations; ``draws[i]`` replaces iteration
    i's, and ``out`` receives the last one's tours and lengths."""
    for i in range(n_steps):
        state = aco_step(state, n_ants, alpha, beta, rho, q0, elite,
                         draws=None if draws is None else draws[i], out=out)
    return state


def aco_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> ACOState:
    """An ACOState from numpy arrays named like its fields."""
    return _family.state_from_numpy(ACOState, arrays, device, seed)


def aco_state_to_numpy(state: ACOState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
