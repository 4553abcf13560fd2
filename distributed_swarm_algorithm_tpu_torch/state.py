"""Swarm state as a struct of tensors.

The counterpart of ``distributed_swarm_algorithm_tpu/state.py``: the whole
swarm is one dataclass of tensors, and a tick is a function from one state
to the next.  Fields, shapes and dtypes are those of the JAX ``SwarmState``
(every integer field is int32, every flag bool, every float the config's
dtype), so a state converts field for field through numpy
(:func:`state_from_numpy` / :func:`state_to_numpy`).

The one difference is randomness: the JAX state carries a PRNG ``key``;
here ``gen`` is a ``torch.Generator`` on the swarm's device.  The two give
different numbers from the same seed, so tests hand the JAX draws to the
port (``coordination_step(..., jitter=...)``) instead of reproducing them.
Unlike a JAX key, a generator is mutable and shared by every state that
:meth:`SwarmState.replace` derives from it: a draw advances it for all.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from .utils.platform import DeviceLike, resolve_device

# FSM states (agent.py:19-22 of the reference; same values as the JAX port).
FOLLOWER = 1
ELECTION_WAIT = 2
LEADER = 3

# Task status codes for derived views.
TASK_OPEN = 0
TASK_TENTATIVE = 1
TASK_ASSIGNED = 2
TASK_LOCKED = 3

NO_LEADER = -1
NO_CAP = -1
NO_WINNER = -1

I32 = torch.int32


@dataclass
class SwarmState:
    """Struct-of-tensors swarm state. N agents, D spatial dims, T tasks,
    C caps.  See the JAX ``SwarmState`` for the meaning of each field."""

    tick: torch.Tensor            # i32 scalar
    gen: torch.Generator          # election jitter draws (JAX: key)
    agent_id: torch.Tensor        # [N] i32
    alive: torch.Tensor           # [N] bool
    pos: torch.Tensor             # [N,D] f32
    vel: torch.Tensor             # [N,D] f32
    caps: torch.Tensor            # [N,C] bool
    target: torch.Tensor          # [N,D] f32
    has_target: torch.Tensor      # [N] bool
    fsm: torch.Tensor             # [N] i32
    leader_id: torch.Tensor       # [N] i32
    leader_pos: torch.Tensor      # [N,D] f32
    has_leader_pos: torch.Tensor  # [N] bool
    last_hb_tick: torch.Tensor    # [N] i32
    wait_until: torch.Tensor      # [N] i32
    alive_below: torch.Tensor     # [N] i32 alive agents with a lower id
    leader_live: torch.Tensor     # [N] bool believed leader is alive
    task_pos: torch.Tensor        # [T,D] f32
    task_cap: torch.Tensor        # [T] i32
    task_winner: torch.Tensor     # [T] i32
    task_util: torch.Tensor       # [T] f32
    task_claimed: torch.Tensor    # [N,T] bool

    def replace(self, **kw) -> "SwarmState":
        return dataclasses.replace(self, **kw)

    @property
    def n_agents(self) -> int:
        return self.agent_id.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[-1]

    @property
    def n_tasks(self) -> int:
        return self.task_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device


TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(SwarmState) if f.name != "gen"
)

# Agent-axis fields (dim 0 == N): the fields a permutation moves together.
AGENT_AXIS_FIELDS = (
    "agent_id", "alive", "pos", "vel", "caps", "target", "has_target",
    "fsm", "leader_id", "leader_pos", "has_leader_pos", "last_hb_tick",
    "wait_until", "alive_below", "leader_live", "task_claimed",
)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make_swarm(
    n_agents: int,
    dim: int = 2,
    n_tasks: int = 0,
    n_caps: int = 1,
    seed: int = 0,
    pos=None,
    spread: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> SwarmState:
    """Build an initial state: every agent a live follower with no leader,
    at the origin, or uniform in ``[-spread, spread)^D`` drawn from the
    state's generator, or at ``pos``.

    With ``spread > 0`` the positions are not JAX's (the port does not
    reproduce threefry); with ``spread == 0`` or an explicit ``pos`` the
    state equals the JAX ``make_swarm`` field for field.
    """
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    if pos is None:
        if spread > 0.0:
            u = torch.rand((n_agents, dim), generator=gen, device=dev,
                           dtype=dtype)
            pos = -spread + (2.0 * spread) * u
        else:
            pos = torch.zeros((n_agents, dim), dtype=dtype, device=dev)
    else:
        pos = torch.as_tensor(pos, dtype=dtype, device=dev)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    return SwarmState(
        tick=torch.zeros((), dtype=I32, device=dev),
        gen=gen,
        agent_id=torch.arange(n_agents, dtype=I32, device=dev),
        alive=full((n_agents,), True, torch.bool),
        pos=pos,
        vel=full((n_agents, dim), 0.0, dtype),
        caps=full((n_agents, max(n_caps, 1)), False, torch.bool),
        target=full((n_agents, dim), 0.0, dtype),
        has_target=full((n_agents,), False, torch.bool),
        fsm=full((n_agents,), FOLLOWER, I32),
        leader_id=full((n_agents,), NO_LEADER, I32),
        leader_pos=full((n_agents, dim), 0.0, dtype),
        has_leader_pos=full((n_agents,), False, torch.bool),
        last_hb_tick=full((n_agents,), 0, I32),
        wait_until=full((n_agents,), 0, I32),
        alive_below=torch.arange(n_agents, dtype=I32, device=dev),
        leader_live=full((n_agents,), True, torch.bool),
        task_pos=full((n_tasks, dim), 0.0, dtype),
        task_cap=full((n_tasks,), NO_CAP, I32),
        task_winner=full((n_tasks,), NO_WINNER, I32),
        task_util=full((n_tasks,), 0.0, dtype),
        task_claimed=full((n_agents, n_tasks), False, torch.bool),
    )


def recount_alive_below(state: SwarmState) -> SwarmState:
    """Recompute the ``alive_below`` cache from ``alive`` and ``agent_id``
    (one scatter, cumsum and gather in id space).  Any code that writes
    ``alive`` directly, instead of through kill/revive, must call this."""
    n = state.n_agents
    idx = state.agent_id.long()
    alive_by_id = torch.zeros(n, dtype=I32, device=state.device)
    alive_by_id[idx] = state.alive.to(I32)
    cum = torch.cumsum(alive_by_id, 0, dtype=I32) - alive_by_id
    return state.replace(alive_below=cum[idx])


def permute_agents(state: SwarmState, order: torch.Tensor) -> SwarmState:
    """Reorder the agent axis by ``order`` ([N] indices).  Identity lives
    in ``agent_id``, which moves with its agent."""
    order = order.long()
    return state.replace(
        **{f: getattr(state, f)[order] for f in AGENT_AXIS_FIELDS}
    )


def sort_agents_by_key(state: SwarmState, keys: torch.Tensor) -> SwarmState:
    """Reorder the agent axis into ascending ``keys`` order, ties kept in
    slot order (a stable sort, as the JAX variadic ``lax.sort``)."""
    return permute_agents(state, torch.sort(keys, stable=True).indices)


def with_tasks(state: SwarmState, task_pos, task_cap=None) -> SwarmState:
    """Install a task table: every task open, nothing claimed."""
    dev = state.device
    task_pos = torch.as_tensor(task_pos, dtype=state.task_pos.dtype,
                               device=dev)
    t = task_pos.shape[0]
    if task_cap is None:
        task_cap = torch.full((t,), NO_CAP, dtype=I32, device=dev)
    else:
        task_cap = torch.as_tensor(task_cap, dtype=I32, device=dev)
    return state.replace(
        task_pos=task_pos,
        task_cap=task_cap,
        task_winner=torch.full((t,), NO_WINNER, dtype=I32, device=dev),
        task_util=torch.zeros((t,), dtype=state.task_util.dtype,
                              device=dev),
        task_claimed=torch.zeros((state.n_agents, t), dtype=torch.bool,
                                 device=dev),
    )


def state_from_numpy(
    arrays: Mapping[str, np.ndarray],
    device: DeviceLike = None,
    seed: int = 0,
) -> SwarmState:
    """Build a state from numpy arrays named like the fields (the JAX
    state's fields as numpy; its ``key`` is ignored).  Dtypes are kept as
    given; ``gen`` is a fresh generator seeded with ``seed``."""
    dev = resolve_device(device)
    missing = [f for f in TENSOR_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {missing}")
    return SwarmState(
        gen=_generator(dev, seed),
        **{
            f: torch.from_numpy(np.array(arrays[f], copy=True)).to(dev)
            for f in TENSOR_FIELDS
        },
    )


def state_to_numpy(state: SwarmState) -> dict[str, np.ndarray]:
    """Every tensor field as a numpy array (the inverse of
    :func:`state_from_numpy`; the generator is left out)."""
    return {f: getattr(state, f).cpu().numpy() for f in TENSOR_FIELDS}
