"""Leader election, heartbeat liveness and failure detection as masked
tensor updates: the counterpart of ``ops/coordination.py`` of the JAX
package, which documents the protocol and its mapping to the reference.

Every branch on data is a ``torch.where`` over the swarm: the tick makes
no host round trip, so a CUDA tick is launched without waiting.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..state import (
    ELECTION_WAIT,
    FOLLOWER,
    I32,
    LEADER,
    NO_LEADER,
    SwarmState,
    recount_alive_below,
)
from ..utils.config import SwarmConfig

_I32_MAX = torch.iinfo(torch.int32).max


def draw_jitter(state: SwarmState, cfg: SwarmConfig) -> torch.Tensor:
    """[N] i32 election jitter in ``[0, election_jitter_ticks]``, drawn
    from the state's generator."""
    return torch.randint(
        0, cfg.election_jitter_ticks + 1, (state.n_agents,),
        generator=state.gen, dtype=I32, device=state.device,
    )


def coordination_step(
    state: SwarmState,
    cfg: SwarmConfig,
    jitter: Optional[torch.Tensor] = None,
) -> SwarmState:
    """One coordination tick.  Assumes ``state.tick`` was already advanced.

    ``jitter`` ([N] i32) replaces the draw from ``state.gen``; the tests
    pass the JAX key chain's draws through it.
    """
    if jitter is None:
        jitter = draw_jitter(state, cfg)
    tick = state.tick
    agent_id = state.agent_id
    alive = state.alive
    fsm = state.fsm
    leader_id = state.leader_id
    last_hb = state.last_hb_tick
    wait_until = state.wait_until
    lpos = state.leader_pos
    has_lpos = state.has_leader_pos
    leader_live = state.leader_live

    # 1. failure detection: a silent leader sends followers into a wait.
    silent = (tick - last_hb) > cfg.election_timeout_ticks
    to_wait = alive & (fsm == FOLLOWER) & silent
    wait_until = torch.where(to_wait, tick + jitter, wait_until)
    fsm = torch.where(to_wait, ELECTION_WAIT, fsm)
    leader_id = torch.where(to_wait, NO_LEADER, leader_id)
    has_lpos = has_lpos & ~to_wait
    leader_live = leader_live & ~to_wait

    # 2. acclaim and bully resolution; "elapsed > delay" is strict.
    acclaim = alive & (fsm == ELECTION_WAIT) & (tick > wait_until)
    any_acclaim = acclaim.any()
    min_acclaim = torch.where(acclaim, agent_id, _I32_MAX).amin()
    bully = (
        alive
        & (fsm == ELECTION_WAIT)
        & any_acclaim
        & (agent_id > min_acclaim)
    )
    contender = acclaim | bully | (alive & (fsm == LEADER))
    winner = torch.where(contender, agent_id, NO_LEADER).amax()
    is_winner = contender & (agent_id == winner)
    resolve = any_acclaim & alive
    fsm = torch.where(
        resolve, torch.where(is_winner, LEADER, FOLLOWER).to(I32), fsm
    )
    leader_id = torch.where(resolve, winner, leader_id)
    last_hb = torch.where(resolve & ~is_winner, tick, last_hb)
    leader_live = leader_live | resolve

    # 3. heartbeat.  The emitter's pose is a masked sum over the one
    #    emitter row, which is exact.
    leaders = alive & (fsm == LEADER)
    emit = leaders & (tick % cfg.heartbeat_period_ticks == 0)
    any_emit = emit.any()
    hb_id = torch.where(emit, agent_id, NO_LEADER).amax()
    hb_pos = torch.where(
        (emit & (agent_id == hb_id))[:, None], state.pos, 0.0
    ).sum(0)
    recv = any_emit & alive & (agent_id != hb_id)
    suppress = recv & (fsm == LEADER) & (agent_id > hb_id)
    adopt = recv & ~suppress
    fsm = torch.where(adopt, FOLLOWER, fsm)
    leader_id = torch.where(adopt, hb_id, leader_id)
    last_hb = torch.where(adopt, tick, last_hb)
    lpos = torch.where(adopt[:, None], hb_pos[None, :], lpos)
    has_lpos = has_lpos | adopt
    leader_live = leader_live | adopt

    # A leader's own view of the leadership.
    is_leader = alive & (fsm == LEADER)
    leader_id = torch.where(is_leader, agent_id, leader_id)
    leader_live = leader_live | is_leader

    return state.replace(
        fsm=fsm,
        leader_id=leader_id,
        last_hb_tick=last_hb,
        wait_until=wait_until,
        leader_pos=lpos,
        has_leader_pos=has_lpos,
        leader_live=leader_live,
    )


def instant_election(state: SwarmState) -> SwarmState:
    """The election's fixed point in one reduction: the highest alive id
    leads and every live agent knows it."""
    state = recount_alive_below(state)
    winner = torch.where(state.alive, state.agent_id, NO_LEADER).amax()
    is_winner = state.alive & (state.agent_id == winner)
    winner_pos = torch.where(is_winner[:, None], state.pos, 0.0).sum(0)
    any_alive = winner >= 0
    return state.replace(
        fsm=torch.where(is_winner, LEADER, FOLLOWER).to(I32),
        leader_id=torch.where(state.alive, winner, state.leader_id),
        leader_pos=torch.where(
            (state.alive & ~is_winner & any_alive)[:, None],
            winner_pos[None, :],
            state.leader_pos,
        ),
        has_leader_pos=torch.where(
            state.alive, ~is_winner & any_alive, state.has_leader_pos
        ),
        last_hb_tick=torch.where(
            state.alive, state.tick, state.last_hb_tick
        ),
        leader_live=state.leader_live | state.alive,
    )


def current_leader(state: SwarmState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(leader_id, exists): the highest-id alive agent that believes
    itself leader, as 0-d tensors on the state's device."""
    mask = state.alive & (state.fsm == LEADER)
    lid = torch.where(mask, state.agent_id, NO_LEADER).amax()
    return lid, lid >= NO_LEADER + 1


def _id_match(column: torch.Tensor, ids) -> torch.Tensor:
    """[N] bool: ``column[k]`` is one of ``ids`` (matched by value)."""
    ids = torch.as_tensor(ids, dtype=I32, device=column.device).reshape(-1)
    return (column[:, None] == ids[None, :]).any(1)


def kill(state: SwarmState, ids) -> SwarmState:
    """Fault injection: mark agents dead.  Believers in a killed leader see
    the liveness flip at once; detection still waits for the timeout."""
    dead = _id_match(state.agent_id, ids)
    believed_killed = _id_match(state.leader_id, ids)
    return recount_alive_below(
        state.replace(
            alive=state.alive & ~dead,
            leader_live=state.leader_live & ~believed_killed,
        )
    )


def revive(state: SwarmState, ids) -> SwarmState:
    """Elastic recovery: bring agents back as followers."""
    back = _id_match(state.agent_id, ids)
    believed_back = _id_match(state.leader_id, ids)
    return recount_alive_below(
        state.replace(
            alive=state.alive | back,
            fsm=torch.where(back, FOLLOWER, state.fsm),
            leader_id=torch.where(back, NO_LEADER, state.leader_id),
            last_hb_tick=torch.where(back, state.tick, state.last_hb_tick),
            leader_live=(state.leader_live | believed_back) & ~back,
        )
    )
