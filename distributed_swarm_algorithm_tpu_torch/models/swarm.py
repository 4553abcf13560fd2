"""The whole-swarm protocol tick: the counterpart of ``models/swarm.py`` of
the JAX package.

``swarm_tick`` is one pass of the reference's 10 Hz loop body for every
agent at once: coordination (election, heartbeat, failure detection), task
allocation, then physics.  ``swarm_rollout`` runs ticks in a Python loop
(PyTorch runs eagerly, so there is nothing to compile), and ``VectorSwarm``
is the user-facing handle.  A rollout never waits for the device: on CUDA
the host only enqueues work until someone reads a value.  Two exceptions:
a lone ``swarm_tick`` in window mode with ``sort_every > 1`` reads the
tick counter to keep its re-sort cadence, and a hashgrid rollout that
carries a Verlet plan (``hashgrid_skin > 0``) reads the plan's refresh
decision, once a tick when it runs eagerly and once a chunk when it is
replayed.  On the card, a window-mode rollout replays its chunks (a
re-sort and ``sort_every`` ticks) and a hashgrid rollout on its kernel
chunks of ``HASHGRID_CHUNK`` ticks from one captured CUDA graph
(``_replayed_rollout``), so the host launches one graph a chunk where it
would launch some 200 to 430 operations a tick.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ..ops.allocation import allocation_step, task_status_view
from ..ops.coordination import coordination_step, current_leader, kill, revive
from ..ops.cuda import candidate_sweep as _cuda_candidates
from ..ops.cuda import grid_separation as _cuda_grid
from ..ops.cuda import window_separation as _cuda_window
from ..ops.cuda.common import capture_graph, replays_graphs
from ..ops.neighbors import morton_keys
from ..ops.physics import (
    _physics_step_core,
    build_tick_plan,
    physics_step,
    physics_step_plan,
    tick_uses_hashgrid_kernel,
)
from ..state import (
    TENSOR_FIELDS,
    SwarmState,
    make_swarm,
    sort_agents_by_key,
    with_tasks,
)
from ..utils.config import DEFAULT_CONFIG, SwarmConfig
from ..utils.platform import DeviceLike
from ._checkpoint import CheckpointMixin


def _permuting(cfg: SwarmConfig) -> bool:
    """Whether ticks reorder the agent axis: window separation with a
    Morton re-sort cadence.  Array slots are then internal; identity
    lives in ``agent_id``."""
    return cfg.separation_mode == "window" and cfg.sort_every > 1


def _morton_sorted(state: SwarmState, cfg: SwarmConfig) -> SwarmState:
    return sort_agents_by_key(state, morton_keys(state.pos, cfg.grid_cell))


def _protocol_steps(
    state: SwarmState,
    cfg: SwarmConfig,
    sort_in_tick: bool,
    jitter: Optional[torch.Tensor] = None,
) -> SwarmState:
    """The tick before physics: tick stamp, the cadenced Morton re-sort
    (window mode), coordination, allocation."""
    if cfg.telemetry.enabled:
        raise NotImplementedError(
            "the in-tick flight recorder is not ported yet (ROADMAP Queue "
            "A item 11: utils/telemetry.py)"
        )
    state = state.replace(tick=state.tick + 1)
    if sort_in_tick and _permuting(cfg):
        # Keep the agent axis approximately Morton-sorted so the window
        # pass runs on the state's own order.  tick % sort_every == 1
        # fires on the first tick of a fresh swarm, then every sort_every
        # ticks.  The JAX package decides on the device; here the host
        # reads the tick, the tick's one wait for the device, and only in
        # this mode.  swarm_rollout keeps the cadence on the host and
        # never comes here.
        if int(state.tick) % cfg.sort_every == 1:
            state = _morton_sorted(state, cfg)
    state = coordination_step(state, cfg, jitter)
    return allocation_step(state, cfg)


def swarm_tick(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    jitter: Optional[torch.Tensor] = None,
    sort_in_tick: bool = True,
) -> SwarmState:
    """One synchronous tick.  ``jitter`` ([N] i32, by slot after any
    re-sort) replaces the election jitter drawn from ``state.gen`` (see
    ``coordination_step``).  ``sort_in_tick=False`` drops the cadenced
    Morton re-sort, for callers that keep the cadence themselves."""
    state = _protocol_steps(state, cfg, sort_in_tick, jitter)
    return physics_step(state, obstacles, cfg)


def _swarm_tick_plan(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    plan,
    jitter: Optional[torch.Tensor] = None,
):
    """The plan-carrying tick: the same protocol steps, then physics off
    the refreshed Verlet plan.  Returns ``(state, plan)``."""
    state = _protocol_steps(state, cfg, False, jitter)
    return physics_step_plan(state, obstacles, cfg, plan)


# Ticks in a replayed chunk of a hashgrid rollout.  The capture costs about
# the host time of the ticks it records (some 7 ms a tick at 65,536
# agents), once a swarm; ten divides the usual spans (500, 1,000 ticks),
# so no remainder runs eagerly; and a carried plan's chunk that needed a
# full rebuild reruns only ten ticks eagerly.
HASHGRID_CHUNK = 10


def _replayed_kernel(cfg: SwarmConfig, state: SwarmState):
    """The kernel module whose launches a replayed chunk of this config
    counts, or None where rollouts run eagerly: window mode with a
    re-sort cadence, and hashgrid mode on its slots or candidates
    kernel."""
    if _permuting(cfg):
        return _cuda_window
    if cfg.separation_mode == "hashgrid" and tick_uses_hashgrid_kernel(
            cfg, state.pos.shape[1], state.pos.dtype, state.device):
        return (_cuda_candidates if cfg.hashgrid_kernel == "candidates"
                else _cuda_grid)
    return None


def _chunk_length(cfg: SwarmConfig) -> int:
    return cfg.sort_every if _permuting(cfg) else HASHGRID_CHUNK


def _chunk_ticks(
    state: SwarmState,
    plan,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    n_ticks: int,
    jitter: Optional[torch.Tensor],
    on_device: bool = False,
):
    """``n_ticks`` ticks of a chunk, tick k with the jitter row
    ``jitter[k]`` (or drawn from the state's generator): in window mode
    the Morton re-sort first and no in-tick re-sort; with a carried
    ``plan``, the plan-carrying tick, its refresh decided on the device
    with ``on_device``.  Returns ``(state, plan, full_needed)``, the last
    a bool device scalar (any tick of the chunk needed a full rebuild)
    with ``on_device`` and a plan, else None."""
    if _permuting(cfg):
        state = _morton_sorted(state, cfg)
    full = None
    for k in range(n_ticks):
        jit = None if jitter is None else jitter[k]
        if plan is None:
            state = swarm_tick(state, obstacles, cfg, jit, sort_in_tick=False)
        elif on_device:
            state = _protocol_steps(state, cfg, False, jit)
            state, plan, f = _physics_step_core(state, obstacles, cfg, plan,
                                                None, on_device=True)
            full = f if full is None else full | f
        else:
            state, plan = _swarm_tick_plan(state, obstacles, cfg, plan, jit)
    return state, plan, full


def _clone_plan(plan):
    return plan.replace(**{f: getattr(plan, f).clone()
                           for f in plan.ARRAY_FIELDS
                           if getattr(plan, f) is not None})


def _copy_into(dst, src, fields):
    """Copy each of ``fields`` of ``src`` into ``dst``'s tensor in place
    (skipping a field that already is ``dst``'s tensor)."""
    for f in fields:
        d, v = getattr(dst, f), getattr(src, f)
        if d is not None and v is not d:
            d.copy_(v)


def _plan_fields(plan):
    return [] if plan is None else [f for f in plan.ARRAY_FIELDS
                                    if getattr(plan, f) is not None]


class _Chunk(NamedTuple):
    """A captured chunk: its graph, the static state and plan it reads and
    writes (its generator is the rollout's), the chunk's input saved by
    the graph and the flag it sets (a carried plan only: a tick needed a
    full rebuild), the static jitter rows it reads (or None), the
    obstacles it read, the kernel module and the launches its capture
    recorded, and what it was captured for (the config, the fields'
    shapes and dtypes, the jitter's dtype)."""

    graph: torch.cuda.CUDAGraph
    static: SwarmState
    plan: object
    saved: Optional[tuple]
    flag: Optional[torch.Tensor]
    jitter: Optional[torch.Tensor]
    obstacles: Optional[torch.Tensor]
    kernel: object
    launches: int
    key: tuple


# The last captured chunk, replayed by the next rollout whose state has the
# same generator, obstacles and key (a swarm's later rollouts).
_chunk: Optional[_Chunk] = None

# Replayed chunks of a carried plan discarded since the count was last set
# to 0 (a tick of theirs needed a full rebuild; each ran again eagerly).
CHUNKS_RERUN = 0


def _capture_chunk(state, plan, obstacles, cfg, jitter_dtype, key) -> _Chunk:
    """Capture one chunk (``_chunk_ticks`` of ``_chunk_length`` ticks, a
    carried plan's refresh decided on the device) into a CUDA graph over
    static copies of every tensor field of the state and the plan, with
    the state's generator registered (the election jitter draws from it).
    With a plan the graph first copies its input aside and ends by
    setting a flag when a tick needed a full rebuild.  Raises if the
    capture fails or did not record one kernel launch a tick."""
    dev = state.device
    ticks = _chunk_length(cfg)
    kernel = _replayed_kernel(cfg, state)
    static = state.replace(**{f: getattr(state, f).clone()
                              for f in TENSOR_FIELDS})
    splan = None if plan is None else _clone_plan(plan)
    saved = flag = None
    if plan is not None:
        saved = (state.replace(**{f: getattr(state, f).clone()
                                  for f in TENSOR_FIELDS}),
                 _clone_plan(plan))
        flag = torch.zeros((), dtype=torch.bool, device=dev)
    jit = (None if jitter_dtype is None else torch.empty(
        (ticks, state.n_agents), dtype=jitter_dtype, device=dev))
    pfields = _plan_fields(plan)

    def body():
        if saved is not None:
            _copy_into(saved[0], static, TENSOR_FIELDS)
            _copy_into(saved[1], splan, pfields)
        out, oplan, full = _chunk_ticks(static, splan, obstacles, cfg, ticks,
                                        jit, on_device=True)
        _copy_into(static, out, TENSOR_FIELDS)
        if splan is not None:
            _copy_into(splan, oplan, pfields)
            flag.copy_(full)

    kernel._captured = 0
    graph = capture_graph(body, state.gen, dev)
    launches = kernel._captured
    if launches != ticks:
        raise RuntimeError(
            f"a captured chunk of {ticks} ticks must launch its kernel once "
            f"a tick, got {launches}")
    return _Chunk(graph, static, splan, saved, flag, jit, obstacles, kernel,
                  launches, key)


def _replayed_rollout(
    state: SwarmState,
    plan,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    n_steps: int,
    jitter: Optional[torch.Tensor],
):
    """A rollout on the card, ``(state, plan)``: every full chunk replayed
    from the graph of one captured chunk (captured anew unless the last
    one was captured for this generator, these obstacles and this key), a
    shorter last chunk eagerly.

    The generator is registered with the graph, so a replay draws the
    election jitter from the generator's offset at that replay and
    advances it as the eager ticks do: the rollout equals the eager one
    bit for bit.  Given ``jitter`` rows are copied into the graph's static
    rows before each replay.  The state (and the carried ``plan``) is
    copied into the graph's static tensors and the result copied out of
    them, so the caller's tensors are never written.  Each replay adds
    the kernel launches its capture recorded.

    With a carried plan, each replay is followed by one read of its flag;
    a chunk in which some tick needed a full rebuild is discarded and run
    again eagerly from its saved input and generator offset.  Its
    launches count once, those of the eager run whose results the rollout
    keeps; ``CHUNKS_RERUN`` counts the discarded chunks."""
    global _chunk, CHUNKS_RERUN
    se = _chunk_length(cfg)
    jdt = None if jitter is None else jitter.dtype
    key = (cfg, jdt, tuple((tuple(getattr(state, f).shape),
                            getattr(state, f).dtype) for f in TENSOR_FIELDS),
           tuple((f, tuple(getattr(plan, f).shape), getattr(plan, f).dtype)
                 for f in _plan_fields(plan)))
    r = _chunk
    if (r is None or r.static.gen is not state.gen
            or r.obstacles is not obstacles or r.key != key):
        _chunk = r = None           # the old graph's memory goes first
        r = _chunk = _capture_chunk(state, plan, obstacles, cfg, jdt, key)
    pfields = _plan_fields(plan)
    _copy_into(r.static, state, TENSOR_FIELDS)
    _copy_into(r.plan, plan, pfields)
    full, rem = divmod(n_steps, se)
    for c in range(full):
        rows = None if jitter is None else jitter[c * se:(c + 1) * se]
        if rows is not None:
            r.jitter.copy_(rows)
        gen_state = None if r.flag is None else state.gen.get_state()
        r.graph.replay()
        if r.flag is None or not bool(r.flag):
            r.kernel.LAUNCHES += r.launches
        else:
            CHUNKS_RERUN += 1
            state.gen.set_state(gen_state)
            st, pl, _ = _chunk_ticks(r.saved[0], r.saved[1], obstacles, cfg,
                                     se, rows)
            _copy_into(r.static, st, TENSOR_FIELDS)
            _copy_into(r.plan, pl, pfields)
    state = state.replace(**{f: getattr(r.static, f).clone()
                             for f in TENSOR_FIELDS})
    if plan is not None:
        plan = _clone_plan(r.plan)
    if rem:
        state, plan, _ = _chunk_ticks(
            state, plan, obstacles, cfg, rem,
            None if jitter is None else jitter[full * se:])
    return state, plan


def swarm_rollout(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    n_steps: int,
    record: bool = False,
    jitter: Optional[torch.Tensor] = None,
    return_plan: bool = False,
):
    """``n_steps`` ticks.  Returns the final state or, with ``record``,
    ``(state, traj)``: the ``[n_steps, N, D]`` positions after each tick in
    agent-id order.  ``jitter`` is an optional ``[n_steps, N]`` i32 of
    per-tick election jitter.  ``return_plan`` appends the final carried
    hashgrid plan, ``(out, plan)``: its ``rebuilds``, ``cells_rebuilt``,
    ``age`` and ``cap_overflow`` are the run's counters (None outside the
    plan-carry regime).

    In hashgrid mode with ``hashgrid_skin > 0`` one skin-inflated plan,
    seeded by ``build_tick_plan``, rides across the ticks and is rebuilt
    or repaired inside a tick only when its exactness bound runs out.

    In window mode with ``sort_every > 1`` the ticks run in chunks of
    ``sort_every`` (the last chunk may be shorter), each opening with one
    unconditional Morton re-sort of the whole state, and the ticks inside
    run without the in-tick re-sort: the cadence is known here, so no
    tick waits for the device.  Hashgrid ticks on the slots or candidates
    kernel run in chunks of ``HASHGRID_CHUNK``.  On a card without
    ``record``, the full chunks are replayed from one captured CUDA graph
    (``_replayed_rollout``; a carried plan's chunk that needed a full
    rebuild runs again eagerly); the CPU, ``record``, ``step(1)``, a
    shorter last chunk and the other modes run eagerly."""
    if jitter is not None and jitter.shape != (n_steps, state.n_agents):
        raise ValueError(
            f"jitter must be [{n_steps}, {state.n_agents}], got "
            f"{tuple(jitter.shape)}"
        )
    permuting = _permuting(cfg)
    plan = None
    if cfg.separation_mode == "hashgrid" and cfg.hashgrid_skin > 0:
        plan = build_tick_plan(state, cfg)
    if (not record and replays_graphs(state.device)
            and _replayed_kernel(cfg, state) is not None
            and n_steps >= _chunk_length(cfg)):
        out, plan = _replayed_rollout(state, plan, obstacles, cfg, n_steps,
                                      jitter)
        return (out, plan) if return_plan else out
    frames = []
    for t in range(n_steps):
        jit_t = None if jitter is None else jitter[t]
        if plan is not None:
            state, plan = _swarm_tick_plan(state, obstacles, cfg, plan,
                                           jit_t)
        else:
            if permuting and t % cfg.sort_every == 0:
                state = _morton_sorted(state, cfg)
            state = swarm_tick(state, obstacles, cfg, jit_t,
                               sort_in_tick=not permuting)
        if record:
            frame = torch.empty_like(state.pos)
            frame[state.agent_id.long()] = state.pos
            frames.append(frame)
    out = state
    if record:
        traj = (
            torch.stack(frames)
            if frames
            else state.pos.new_zeros((0,) + tuple(state.pos.shape))
        )
        out = (state, traj)
    return (out, plan) if return_plan else out


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
        ``agents`` (matched by value: under the window mode's re-sort,
        array slots are internal)."""
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
        (the state is on ``.state``).  One tick without ``record`` is
        ``swarm_tick``, whose in-tick re-sort keeps the cadence of the
        swarm's tick counter; more ticks are ``swarm_rollout``, which
        re-sorts at the start of each chunk."""
        if record:
            self.state, traj = swarm_rollout(
                self.state, self.obstacles, self.config, n, record=True
            )
            return traj
        if n == 1:
            self.state = swarm_tick(self.state, self.obstacles, self.config)
        else:
            self.state = swarm_rollout(
                self.state, self.obstacles, self.config, n
            )
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
