"""Auction-based optimal task assignment (Bertsekas' forward auction): the
counterpart of ``ops/auction.py`` of the JAX package, whose module doc
gives the semantics (the squaring transform for partial and rectangular
problems, eps-optimality, the lowest-id tie-break).

The bidding loop, a ``lax.while_loop`` in JAX, is kernel N2 on the card
(``ops/cuda/auction.py``, ``csrc/auction.cu``): one launch a solve, and a
device flag ``run`` that makes it run zero rounds, so a caller that
decides on the device whether to solve never waits for the card.  On a
CPU tensor the same loop runs in plain PyTorch.  Everything around it
(padding, unpadding, the utility of an assignment) is gathers and selects:
no scatter, no read from the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .cuda import auction as _cuda_auction

I32 = torch.int32

_auction_round = _cuda_auction.auction_round

Scalar = Union[float, torch.Tensor]


class AuctionResult(NamedTuple):
    """Outcome of an auction run.

    agent_task: [N] i32, the task each agent owns, -1 if none.
    task_agent: [T] i32, the agent owning each task, -1 if none.
    prices:     [T] f32, the final task prices (dual variables).
    rounds:     i32 0-dim, the Jacobi bidding rounds run.
    """

    agent_task: torch.Tensor
    task_agent: torch.Tensor
    prices: torch.Tensor
    rounds: torch.Tensor


def _square_values(util: torch.Tensor, feasible: torch.Tensor
                   ) -> torch.Tensor:
    """Pad to [S, S], S = max(N, T): feasible positive real pairs keep
    their utility, everything else (infeasible, non-positive, virtual) is
    worth 0."""
    n, t = util.shape
    s = max(n, t)
    real = torch.where(feasible & (util > 0.0), util, 0.0)
    return torch.nn.functional.pad(real.to(torch.float32),
                                   (0, s - t, 0, s - n))


def _auction_square(values: torch.Tensor, prices: torch.Tensor,
                    eps: torch.Tensor, max_rounds: int,
                    run: Optional[torch.Tensor] = None):
    """The forward auction on the square until every agent is seated (or
    ``max_rounds``): N2 on a CUDA tensor (``run`` defaults to true there),
    the plain loop on a CPU one."""
    if values.device.type == "cuda":
        if run is None:
            run = torch.ones((), dtype=torch.bool, device=values.device)
        return _cuda_auction.auction_square_cuda(values, prices, eps,
                                                 max_rounds, run)
    return _cuda_auction.auction_square_plain(values, prices, eps,
                                              max_rounds, run)


def _unpad(util, feasible, agent_task, task_agent, prices, rounds
           ) -> AuctionResult:
    """Map the square solution back: a real pair counts as assigned only
    if feasible with positive utility; zero slots read as unassigned.
    ``task_agent`` is read through the agents (the two maps of the square
    are each other's inverse), a gather where JAX scatters."""
    n, t = util.shape
    i = torch.arange(n, device=util.device)
    at = agent_task[:n]
    j = at.clamp(0, t - 1).long()
    really = ((at >= 0) & (at < t) & feasible[i, j] & (util[i, j] > 0.0))
    at = torch.where(really, at, -1)
    ta = task_agent[:t]
    owner = ta.clamp(0, n - 1).long()
    ta = torch.where((ta >= 0) & (ta < n) & really[owner], ta, -1)
    return AuctionResult(at, ta, prices[:t], rounds)


def _eps_tensor(eps: Scalar, device) -> torch.Tensor:
    """``eps`` as a 0-dim float32 on ``device`` (a fill, not a copy from
    the host, so it can be captured)."""
    if isinstance(eps, torch.Tensor):
        return eps.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(eps), dtype=torch.float32, device=device)


def auction_assign(
    util: torch.Tensor,
    feasible: Optional[torch.Tensor] = None,
    eps: Scalar = 0.25,
    max_rounds: int = 100_000,
    run: Optional[torch.Tensor] = None,
) -> AuctionResult:
    """eps-optimal maximum-utility assignment of agents to tasks.

    util: [N, T] utilities (only those of feasible pairs matter); feasible:
    [N, T] bool, defaulting to ``util > 0``; eps: the bid increment, a
    float or a 0-dim tensor (total utility within ``max(N, T) * eps`` of
    the optimum over feasible partial assignments).  ``run`` (a 0-dim bool
    on the device, default true): where false the auction runs zero rounds
    and every agent and task reads unassigned.  One N2 launch on a CUDA
    tensor; nothing is read back."""
    if feasible is None:
        feasible = util > 0.0
    values = _square_values(util, feasible)
    s = values.shape[0]
    prices = torch.zeros((s,), dtype=torch.float32, device=util.device)
    sq = _auction_square(values, prices, _eps_tensor(eps, util.device),
                         max_rounds, run)
    return _unpad(util, feasible, *sq)


def auction_assign_scaled(
    util: torch.Tensor,
    feasible: Optional[torch.Tensor] = None,
    eps: float = 0.25,
    phases: int = 4,
    theta: float = 5.0,
    max_rounds: int = 100_000,
) -> AuctionResult:
    """eps-scaled auction: phases of ``eps * theta**k``, k = phases - 1
    down to 0, each warm-starting from the previous phase's prices (one N2
    launch a phase on the card).  The same ``max(N, T) * eps`` guarantee as
    the flat auction; the JAX package's docstring gives the regimes where
    scaling wins."""
    if feasible is None:
        feasible = util > 0.0
    values = _square_values(util, feasible)
    s = values.shape[0]
    prices = torch.zeros((s,), dtype=torch.float32, device=util.device)
    total = torch.zeros((), dtype=I32, device=util.device)
    at = ta = None
    for k in range(phases - 1, -1, -1):
        at, ta, prices, rounds = _auction_square(
            values, prices, _eps_tensor(eps * float(theta) ** k, util.device),
            max_rounds)
        total = total + rounds
    return _unpad(util, feasible, at, ta, prices, total)


def assignment_utility(util: torch.Tensor, result: AuctionResult
                       ) -> torch.Tensor:
    """Total utility of the assigned pairs (0-dim)."""
    n = util.shape[0]
    i = torch.arange(n, device=util.device)
    mine = result.agent_task >= 0
    j = torch.where(mine, result.agent_task, 0).long()
    return torch.where(mine, util[i, j], 0.0).sum()
