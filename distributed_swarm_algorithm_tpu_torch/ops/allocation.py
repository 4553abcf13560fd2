"""Task allocation as a bid matrix: the counterpart of ``ops/allocation.py``
of the JAX package, which documents the claim rule, the leader's
arbitration and the deliberate fixes over the reference.

Greedy mode: all claims of a tick land in a utility matrix ``U[N, T]``;
arbitration is a per-task reduction with the +hysteresis against the
incumbent.  Ties go to the lowest agent id by value, through a masked min.

Auction mode (:func:`auction_allocation_step`): the leader solves an
eps-optimal one-task-per-agent assignment (``ops/auction.py``) on a
cadence, on a winner's death and when a leader emerges.  JAX decides
under ``lax.cond``; here the decision stays a device flag that the
auction's kernel reads (zero rounds where it is false) and the state is
selected with ``torch.where``, so the tick never waits for the card.  The
utility matrix is therefore computed every tick, where JAX computes it on
re-solve ticks only.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..state import (
    I32,
    LEADER,
    NO_WINNER,
    TASK_ASSIGNED,
    TASK_LOCKED,
    TASK_OPEN,
    TASK_TENTATIVE,
    SwarmState,
)
from ..utils.config import SwarmConfig
from ._numerics import norm, rdiv
from .auction import auction_assign


def utility_matrix(state: SwarmState, cfg: SwarmConfig) -> torch.Tensor:
    """U[N, T] = scale / (1 + dist) · cap_match."""
    delta = state.pos[:, None, :] - state.task_pos[None, :, :]
    dist = norm(delta)                                           # [N, T]
    no_cap_needed = state.task_cap < 0                           # [T]
    cap_ok = state.caps[:, state.task_cap.clamp(min=0).long()]   # [N, T]
    match = no_cap_needed[None, :] | cap_ok
    return torch.where(match, rdiv(cfg.utility_scale, 1.0 + dist), 0.0)


def arbitrate(
    claims_util: torch.Tensor,
    claimant_id: torch.Tensor,
    incumbent_winner: torch.Tensor,
    incumbent_util: torch.Tensor,
    hysteresis: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The leader's conflict rule: (winner[T], util[T]).  The highest
    claim wins, ties to the lowest id; a challenger must beat the
    incumbent by ``hysteresis``."""
    has_claim = (claims_util > 0.0).any(0)                       # [T]
    best_util = claims_util.amax(0)                              # [T]
    at_best = claims_util == best_util[None, :]                  # [N, T]
    big = torch.iinfo(claimant_id.dtype).max
    best_id = torch.where(at_best, claimant_id[:, None], big).amin(0)
    vacant = incumbent_winner == NO_WINNER
    beats = best_util > incumbent_util + hysteresis
    award = has_claim & (vacant | beats)
    winner = torch.where(award, best_id, incumbent_winner)
    util = torch.where(award, best_util, incumbent_util)
    return winner, util


def dead_winner_tasks(state: SwarmState) -> torch.Tensor:
    """[T] bool: tasks whose awarded winner is no longer alive."""
    awarded = state.task_winner != NO_WINNER
    winner_alive = (
        (state.agent_id[:, None] == state.task_winner[None, :])
        & state.alive[:, None]
    ).any(0)
    return awarded & ~winner_alive


def allocation_step(state: SwarmState, cfg: SwarmConfig) -> SwarmState:
    """One allocation tick: dead-winner eviction, greedy claims, leader
    arbitration, award."""
    if state.n_tasks == 0:
        return state

    evict = dead_winner_tasks(state)
    state = state.replace(
        task_winner=torch.where(evict, NO_WINNER, state.task_winner),
        task_util=torch.where(evict, 0.0, state.task_util),
        task_claimed=state.task_claimed & ~evict[None, :],
    )

    u = utility_matrix(state, cfg)
    leader_exists = (state.alive & (state.fsm == LEADER)).any()

    open_for_me = ~state.task_claimed
    if not cfg.allocation_lock_on_award:
        not_mine = state.task_winner[None, :] != state.agent_id[:, None]
        open_for_me = open_for_me | not_mine
    claims = (
        state.alive[:, None]
        & open_for_me
        & (u > cfg.utility_threshold)
        & leader_exists
    )
    claims_util = torch.where(claims, u, 0.0)

    winner, util = arbitrate(
        claims_util,
        state.agent_id,
        state.task_winner,
        state.task_util,
        cfg.claim_hysteresis,
    )
    awarded = winner != NO_WINNER
    task_claimed = state.task_claimed | claims | awarded[None, :]
    return state.replace(
        task_winner=winner, task_util=util, task_claimed=task_claimed
    )


def auction_allocation_step(
    state: SwarmState,
    cfg: SwarmConfig,
    leader_emerged: Union[bool, torch.Tensor] = False,
) -> SwarmState:
    """Allocation tick in ``allocation_mode="auction"``: dead winners are
    evicted at once; then, where a leader exists and the cadence
    (``tick % auction_every == 0``), an eviction or ``leader_emerged`` (a
    bool, or a device scalar: the swarm became led this tick) calls for
    it, the flat auction re-solves over the alive agents' utilities above
    ``utility_threshold``, and every task goes to its winner (unassigned
    ones read OPEN again).  Otherwise the state keeps its awards."""
    if state.n_tasks == 0:
        return state
    t = state.n_tasks
    evict = dead_winner_tasks(state)
    state = state.replace(
        task_winner=torch.where(evict, NO_WINNER, state.task_winner),
        task_util=torch.where(evict, 0.0, state.task_util),
        task_claimed=state.task_claimed & ~evict[None, :],
    )
    leader_exists = (state.alive & (state.fsm == LEADER)).any()
    trigger = (state.tick % cfg.auction_every == 0) | evict.any()
    if isinstance(leader_emerged, torch.Tensor):
        trigger = trigger | leader_emerged
    elif leader_emerged:
        trigger = torch.ones_like(trigger)
    resolve = leader_exists & trigger

    u = utility_matrix(state, cfg)
    feasible = state.alive[:, None] & (u > cfg.utility_threshold)
    res = auction_assign(u, feasible, eps=cfg.auction_eps, run=resolve)
    got = res.task_agent >= 0                                   # [T]
    row = res.task_agent.clamp(min=0).long()
    winner = torch.where(got, state.agent_id.index_select(0, row), NO_WINNER)
    util = torch.where(got, u.gather(0, row[None, :])[0], 0.0)
    claimed = got[None, :].expand(state.n_agents, t)
    return state.replace(
        task_winner=torch.where(resolve, winner, state.task_winner),
        task_util=torch.where(resolve, util, state.task_util),
        task_claimed=torch.where(resolve, claimed, state.task_claimed),
    )


def agent_task_view(state: SwarmState) -> torch.Tensor:
    """[N] i32: the task awarded to each agent (the lowest index when it
    holds several), ``NO_WINNER`` when none."""
    n, t = state.n_agents, state.n_tasks
    if t == 0:
        return torch.full((n,), NO_WINNER, dtype=I32, device=state.device)
    awarded = state.task_winner != NO_WINNER
    mine = (
        state.task_winner[None, :] == state.agent_id[:, None]
    ) & awarded[None, :]
    t_idx = torch.arange(t, dtype=I32, device=state.device)
    first = torch.where(mine, t_idx[None, :], t).amin(1)
    return torch.where(first < t, first, NO_WINNER)


def task_status_view(state: SwarmState) -> torch.Tensor:
    """[N, T] per-agent task status: OPEN=0, TENTATIVE=1, ASSIGNED=2,
    LOCKED=3."""
    awarded = state.task_winner != NO_WINNER
    mine = state.task_winner[None, :] == state.agent_id[:, None]
    status = torch.where(state.task_claimed, TASK_TENTATIVE, TASK_OPEN)
    status = torch.where(awarded[None, :], TASK_LOCKED, status)
    status = torch.where(awarded[None, :] & mine, TASK_ASSIGNED, status)
    return status.to(I32)
