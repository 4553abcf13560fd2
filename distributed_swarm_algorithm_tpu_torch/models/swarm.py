"""The whole-swarm protocol tick: the counterpart of ``models/swarm.py`` of
the JAX package.

``swarm_tick`` is one pass of the reference's 10 Hz loop body for every
agent at once: coordination (election, heartbeat, failure detection), task
allocation, then physics.  ``swarm_rollout`` runs ticks in a Python loop
(PyTorch runs eagerly, so there is nothing to compile), and ``VectorSwarm``
is the user-facing handle.  A tick never waits for the device: on CUDA the
host only enqueues work until someone reads a value.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..ops.allocation import allocation_step, task_status_view
from ..ops.coordination import coordination_step, current_leader, kill, revive
from ..ops.physics import physics_step
from ..state import SwarmState, make_swarm, with_tasks
from ..utils.config import DEFAULT_CONFIG, SwarmConfig
from ..utils.platform import DeviceLike
from ._checkpoint import CheckpointMixin


def swarm_tick(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    jitter: Optional[torch.Tensor] = None,
) -> SwarmState:
    """One synchronous tick.  ``jitter`` ([N] i32) replaces the election
    jitter drawn from ``state.gen`` (see ``coordination_step``)."""
    if cfg.telemetry.enabled:
        raise NotImplementedError(
            "the in-tick flight recorder is not ported yet (ROADMAP Queue "
            "A item 11: utils/telemetry.py)"
        )
    state = state.replace(tick=state.tick + 1)
    state = coordination_step(state, cfg, jitter)
    state = allocation_step(state, cfg)
    return physics_step(state, obstacles, cfg)


def swarm_rollout(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    n_steps: int,
    record: bool = False,
    jitter: Optional[torch.Tensor] = None,
):
    """``n_steps`` ticks.  Returns the final state or, with ``record``,
    ``(state, traj)``: the ``[n_steps, N, D]`` positions after each tick in
    agent-id order.  ``jitter`` is an optional ``[n_steps, N]`` i32 of
    per-tick election jitter."""
    if jitter is not None and jitter.shape != (n_steps, state.n_agents):
        raise ValueError(
            f"jitter must be [{n_steps}, {state.n_agents}], got "
            f"{tuple(jitter.shape)}"
        )
    frames = []
    for t in range(n_steps):
        state = swarm_tick(
            state, obstacles, cfg, None if jitter is None else jitter[t]
        )
        if record:
            frame = torch.empty_like(state.pos)
            frame[state.agent_id.long()] = state.pos
            frames.append(frame)
    if not record:
        return state
    traj = (
        torch.stack(frames)
        if frames
        else state.pos.new_zeros((0,) + tuple(state.pos.shape))
    )
    return state, traj


class VectorSwarm(CheckpointMixin):
    """User-facing handle: owns a SwarmState and a SwarmConfig.  Runs on
    the CUDA card unless ``device="cpu"`` is asked for."""

    def __init__(
        self,
        n_agents: int,
        dim: int = 2,
        n_tasks: int = 0,
        n_caps: int = 1,
        config: Optional[SwarmConfig] = None,
        seed: int = 0,
        spread: float = 0.0,
        device: DeviceLike = None,
    ):
        self.config = config or DEFAULT_CONFIG
        self.state = make_swarm(
            n_agents, dim=dim, n_tasks=n_tasks, n_caps=n_caps, seed=seed,
            spread=spread, dtype=getattr(torch, self.config.dtype),
            device=device,
        )
        self.obstacles: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.state.device

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # --- world injection ------------------------------------------------
    def set_target(self, target, agents=None) -> None:
        """Set a nav target for all agents, or for the agent ids in
        ``agents`` (matched by value)."""
        s = self.state
        t = torch.broadcast_to(self._tensor(target, s.pos.dtype),
                               s.pos.shape).clone()
        if agents is None:
            self.state = s.replace(
                target=t, has_target=torch.ones_like(s.has_target)
            )
            return
        ids = self._tensor(agents, s.agent_id.dtype).reshape(-1)
        sel = (s.agent_id[:, None] == ids[None, :]).any(1)
        self.state = s.replace(
            target=torch.where(sel[:, None], t, s.target),
            has_target=s.has_target | sel,
        )

    def set_obstacles(self, obstacles) -> None:
        """obstacles: [O, D+1] rows of (center..., radius)."""
        self.obstacles = (
            None if obstacles is None
            else self._tensor(obstacles, self.state.pos.dtype)
        )

    def add_tasks(self, task_pos, task_cap=None) -> None:
        self.state = with_tasks(self.state, task_pos, task_cap)

    def set_capabilities(self, caps) -> None:
        """caps: [N, C] bool one-hot."""
        self.state = self.state.replace(caps=self._tensor(caps, torch.bool))

    # --- stepping -------------------------------------------------------
    def step(self, n: int = 1, record: bool = False):
        """Advance ``n`` ticks.  Returns the new state or, with
        ``record=True``, the ``[n, N, D]`` trajectory in agent-id order
        (the state is on ``.state``)."""
        if record:
            self.state, traj = swarm_rollout(
                self.state, self.obstacles, self.config, n, record=True
            )
            return traj
        self.state = swarm_rollout(self.state, self.obstacles, self.config, n)
        return self.state

    def run_realtime(self, n_steps: int) -> SwarmState:
        """Wall-clock-paced loop at ``tick_rate_hz``: each tick waits for
        the device, then the loop sleeps the rest of the period."""
        period = 1.0 / self.config.tick_rate_hz
        for _ in range(n_steps):
            start = time.perf_counter()
            self.state = swarm_tick(self.state, self.obstacles, self.config)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            leftover = period - (time.perf_counter() - start)
            if leftover > 0:
                time.sleep(leftover)
        return self.state

    # --- introspection / fault injection --------------------------------
    def leader(self):
        """(leader id, exists) as Python values; waits for the device."""
        lid, exists = current_leader(self.state)
        return int(lid), bool(exists)

    def task_statuses(self) -> torch.Tensor:
        return task_status_view(self.state)

    def kill(self, ids) -> None:
        self.state = kill(self.state, ids)

    def revive(self, ids) -> None:
        self.state = revive(self.state, ids)
