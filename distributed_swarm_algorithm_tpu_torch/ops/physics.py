"""Artificial-potential-field motion for the whole swarm: the counterpart
of ``ops/physics.py`` of the JAX package, which documents the force terms
and the deliberate fixes over the reference.

Per tick: followers retarget on the V formation from their view of the
leader; the force is target attraction + obstacle repulsion + neighbor
separation; the velocity command is the force clamped to ``max_speed``,
and an explicit Euler step moves the agents that have a target.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..state import FOLLOWER, I32, SwarmState
from ..utils.config import SwarmConfig
from . import hashgrid_plan as _hp
from . import neighbors as _neighbors
from ._numerics import norm, rdiv
from .cuda import candidate_sweep as _cuda_candidates
from .cuda import grid_separation as _cuda_grid
from .cuda import separation as _cuda_separation
from .cuda import window_separation as _cuda_window

_ITEM_9 = ("ROADMAP Queue A item 9: ops/grid_moments.py, the moments "
           "field")


def formation_targets(state: SwarmState, cfg: SwarmConfig) -> SwarmState:
    """Followers derive their nav target from their view of the leader
    pose: V shape ("vee"), "line", or "none" (no retarget).  The rank is
    the ordinal among alive non-leader agents by id ("ordinal") or the
    raw id ("id")."""
    if cfg.formation_shape == "none":
        return state
    if cfg.formation_rank_mode == "id":
        rank = state.agent_id.to(torch.float32)
    else:
        n = state.n_agents
        aid = state.agent_id
        lid = state.leader_id
        lid_valid = (lid >= 0) & (lid < n)
        leader_below = (lid_valid & state.leader_live & (lid < aid)).to(I32)
        rank = (state.alive_below - leader_below + 1).to(torch.float32)

    spacing = cfg.formation_spacing
    x_off = -spacing * rank
    if cfg.formation_shape == "line":
        y_off = torch.zeros_like(x_off)
    else:
        side = torch.where((rank.to(I32) % 2) == 0, 1.0, -1.0)
        y_off = spacing * rank * side

    offset = torch.zeros_like(state.pos)
    offset[:, 0] = x_off
    if state.dim >= 2:
        offset[:, 1] = y_off

    is_follower = (state.fsm == FOLLOWER) & state.has_leader_pos & state.alive
    new_target = state.leader_pos + offset
    target = torch.where(is_follower[:, None], new_target, state.target)
    has_target = state.has_target | is_follower
    return state.replace(target=target, has_target=has_target)


def _apf_point_forces(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
) -> torch.Tensor:
    """Target attraction + obstacle repulsion, [N, D]."""
    pos = state.pos
    eps = cfg.dist_eps

    # Attraction, gated outside the arrival tolerance.
    delta = state.target - pos
    dist = norm(delta)
    pulling = state.has_target & (dist > cfg.arrival_tolerance)
    f_att = torch.where(pulling[:, None], cfg.k_att * delta, 0.0)

    # Obstacle repulsion.  obstacles: [O, D+1] rows of (center..., radius).
    if obstacles is None or obstacles.shape[0] == 0:
        return f_att
    centers = obstacles[:, : state.dim]               # [O, D]
    radii = obstacles[:, state.dim]                   # [O]
    away = pos[:, None, :] - centers[None, :, :]      # [N, O, D]
    center_dist = norm(away)                          # [N, O]
    surf = (center_dist - radii[None, :]).clamp(min=eps)
    mag = cfg.k_rep * (1.0 / surf - 1.0 / cfg.rho0) / (surf * surf)
    mag = torch.where(surf < cfg.rho0, mag, 0.0)
    unit = away / center_dist.clamp(min=eps)[..., None]
    f_rep = (mag[..., None] * unit).sum(1)
    return f_att + f_rep


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _candidate_table_shape(cfg: SwarmConfig):
    """(W, RK) of the candidates flavor's plan tables, as the JAX package
    sizes them (they are plan state compared with it): W is
    ``hashgrid_neighbor_cap`` rounded up to a multiple of 128; RK is
    ``hashgrid_recv_cap`` or, at 0, twice ``grid_max_per_cell``, never
    below ``grid_max_per_cell``, rounded up to a multiple of 8."""
    w = _ceil_to(max(int(cfg.hashgrid_neighbor_cap), 1), 128)
    rk = int(cfg.hashgrid_recv_cap)
    if rk <= 0:
        rk = 2 * int(cfg.grid_max_per_cell)
    rk = _ceil_to(max(rk, int(cfg.grid_max_per_cell)), 8)
    return w, rk


def _candidate_plan_g(cfg: SwarmConfig) -> int:
    """The candidates flavor's plan grid: the portable tiling."""
    cell_plan = max(float(cfg.grid_cell), float(cfg.personal_space))
    denom = cell_plan + float(cfg.hashgrid_skin)
    if cfg.world_hw <= 0 or denom <= 0:
        return 1
    return max(1, int(2.0 * float(cfg.world_hw) / denom))


def tick_uses_hashgrid_kernel(cfg: SwarmConfig, dim: int, dtype,
                              device) -> bool:
    """Whether ``separation_mode="hashgrid"`` takes the kernel path: a
    static predicate of the config and the device (``device`` a
    ``torch.device`` or a tensor).  ``hashgrid_backend``: "portable" never,
    "pallas" always (the plain version on a CPU tensor; raises outside the
    kernel's envelope), "auto" on CUDA inside the envelope.  With
    ``hashgrid_skin > 0`` the envelope is that of the inflated geometry.
    ``hashgrid_kernel`` picks the program: "slots" (B2) or "candidates"
    (B3)."""
    if cfg.hashgrid_kernel not in ("slots", "candidates"):
        raise ValueError(
            f"unknown hashgrid_kernel {cfg.hashgrid_kernel!r}; "
            "expected 'slots' or 'candidates'"
        )
    if isinstance(device, torch.Tensor):
        device = device.device
    on_cuda = torch.device(device).type == "cuda"
    if cfg.hashgrid_kernel == "candidates":
        w, rk = _candidate_table_shape(cfg)
        return _cuda_candidates.candidate_backend_choice(
            cfg.hashgrid_backend, dim, dtype, w, rk,
            g=_candidate_plan_g(cfg), knob="hashgrid_backend",
            on_cuda=on_cuda,
        )
    return _cuda_grid.hashgrid_backend_choice(
        cfg.hashgrid_backend, dim, dtype, cfg.world_hw,
        cfg.grid_cell + cfg.hashgrid_skin, cfg.grid_max_per_cell,
        cfg.personal_space + cfg.hashgrid_skin, knob="hashgrid_backend",
        on_cuda=on_cuda,
    )


def _check_field_off(cfg: SwarmConfig) -> None:
    if cfg.k_align != 0.0 or cfg.k_coh != 0.0:
        raise NotImplementedError(
            f"k_align/k_coh field forces are not ported yet ({_ITEM_9})"
        )


def resolve_plan_geometry(use_kernel, world_hw, sep_cell, personal_space,
                          skin):
    """(g_plan, cell_plan) of a hashgrid plan.  Kernel path: the slots
    kernel's 16-aligned grid on the skin-inflated cell.  Portable path:
    ``floor(2hw / (max(sep_cell, personal_space) + skin))``.  (The JAX
    package also returns whether the moments field shares the plan; with
    the field not ported, it never does.)"""
    if use_kernel:
        g_plan, _ = _cuda_grid._geometry(world_hw, sep_cell + skin)
        return g_plan, sep_cell
    cell_plan = max(sep_cell, personal_space)
    g_plan = max(1, int(2.0 * world_hw / (cell_plan + skin)))
    if g_plan < 3:
        raise ValueError(
            f"torus [-{world_hw}, {world_hw}) tiled by cell "
            f"{cell_plan + skin} gives a {g_plan}-cell grid; the wrapping "
            "3x3 stencil needs g >= 3 (use the dense separation mode for "
            "such tiny worlds)"
        )
    return g_plan, cell_plan


def build_tick_plan(state: SwarmState, cfg: SwarmConfig,
                    amortized: bool = True) -> _hp.HashgridPlan:
    """The hashgrid tick's shared plan for this config: the slots kernel's
    grid on the kernel path, the portable tiling otherwise, both inflated
    by ``hashgrid_skin``.  The candidates flavor always carries its
    ``cand`` and ``recv`` tables; the portable flavor carries the
    candidate table only for a rollout that reuses the plan (``amortized``
    with a skin).  Nothing here waits for the device."""
    pos = state.pos
    if cfg.world_hw <= 0:
        raise ValueError(
            "separation_mode='hashgrid' needs world_hw > 0 (the torus "
            "half-width the grid tiles); set it in SwarmConfig"
        )
    if pos.shape[1] != 2:
        raise ValueError(
            "separation_mode='hashgrid' is 2-D only (the cell grid tiles a "
            f"2-D torus); got dim={pos.shape[1]}"
        )
    _check_field_off(cfg)
    skin = float(cfg.hashgrid_skin)
    use_kernel = tick_uses_hashgrid_kernel(cfg, 2, pos.dtype, pos.device)
    candidates = cfg.hashgrid_kernel == "candidates"
    g_plan, cell_plan = resolve_plan_geometry(
        use_kernel and not candidates, cfg.world_hw, cfg.grid_cell,
        cfg.personal_space, skin,
    )
    if candidates:
        neighbor_cap, recv_cap = _candidate_table_shape(cfg)
    else:
        neighbor_cap = (cfg.hashgrid_neighbor_cap
                        if amortized and skin > 0.0 and not use_kernel
                        else 0)
        recv_cap = 0
    return _hp.build_hashgrid_plan(
        pos, state.alive, float(cfg.world_hw), float(cell_plan),
        cfg.grid_max_per_cell, need_csr=not use_kernel or candidates,
        g=g_plan, skin=skin, neighbor_cap=neighbor_cap, recv_cap=recv_cap,
    )


def separation_force(state: SwarmState, cfg: SwarmConfig, plan=None):
    """(force [N, D], plan): the separation-mode dispatch.  "dense" all
    pairs by broadcast, "pallas" all pairs by the CUDA kernel, "window"
    the +-``window_size`` Morton neighbours by the CUDA kernel, "grid" the
    spatial hash, "hashgrid" the torus hash off a shared plan (``plan``,
    or one built here) by the slots kernel, the candidates kernel or the
    portable sweep (:func:`tick_uses_hashgrid_kernel`), "off" none; each
    kernel's plain version on the CPU.  The plan is returned (None
    outside hashgrid mode).

    In window mode with ``sort_every > 1`` the swarm itself is kept
    approximately Morton-sorted (``models/swarm.py`` re-sorts it on that
    cadence), so the pass runs on the state's own order, with no sort,
    gather or scatter of its own."""
    mode = cfg.separation_mode
    pos = state.pos
    if mode == "dense":
        return _neighbors.separation_dense(
            pos, state.alive, cfg.k_sep, cfg.personal_space, cfg.dist_eps
        ), None
    if mode == "pallas":
        return _cuda_separation.separation(
            pos, state.alive, cfg.k_sep, cfg.personal_space, cfg.dist_eps
        ), None
    if mode == "window":
        return _cuda_window.separation_window(
            pos, state.alive, cfg.k_sep, cfg.personal_space, cfg.dist_eps,
            cell=cfg.grid_cell, window=cfg.window_size,
            presorted=cfg.sort_every > 1,
        ), None
    if mode == "grid":
        return _neighbors.separation_grid(
            pos, state.alive, cfg.k_sep, cfg.personal_space, cfg.dist_eps,
            cell=cfg.grid_cell, max_per_cell=cfg.grid_max_per_cell,
        ), None
    if mode == "hashgrid":
        use_kernel = tick_uses_hashgrid_kernel(cfg, pos.shape[1], pos.dtype,
                                               pos.device)
        if plan is None:
            plan = build_tick_plan(state, cfg, amortized=False)
        if use_kernel and cfg.hashgrid_kernel == "candidates":
            f = _cuda_candidates.candidate_sweep(
                pos, cfg.k_sep, cfg.personal_space, cfg.dist_eps, plan)
        elif use_kernel:
            f = _cuda_grid.separation_hashgrid(
                pos, state.alive, cfg.k_sep, cfg.personal_space,
                cfg.dist_eps, cell=float(cfg.grid_cell) + plan.skin,
                max_per_cell=cfg.grid_max_per_cell,
                torus_hw=float(cfg.world_hw),
                overflow_budget=cfg.hashgrid_overflow_budget, plan=plan,
            )
        else:
            f = _neighbors.separation_grid_plan(
                pos, state.alive, cfg.k_sep, cfg.personal_space,
                cfg.dist_eps, plan)
        return f, plan
    if mode == "off":
        return torch.zeros_like(pos), None
    raise ValueError(
        f"unknown separation_mode {mode!r}; expected 'dense', 'pallas', "
        "'grid', 'window', 'hashgrid', or 'off'"
    )


def apf_forces_plan(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    plan=None,
):
    """(total APF force [N, D], the hashgrid plan the tick dispatched on
    or None)."""
    _check_field_off(cfg)
    f_sep, plan = separation_force(state, cfg, plan)
    return _apf_point_forces(state, obstacles, cfg) + f_sep, plan


def apf_forces(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    plan=None,
) -> torch.Tensor:
    """Total APF force per agent, [N, D]."""
    return apf_forces_plan(state, obstacles, cfg, plan)[0]


def integrate(
    pos: torch.Tensor,
    force: torch.Tensor,
    moving: torch.Tensor,
    cfg: SwarmConfig,
    dt: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Force -> velocity command clamped to ``max_speed`` -> Euler step."""
    ms = cfg.max_speed
    speed = norm(force, keepdim=True)
    scale = torch.where(
        speed > ms, rdiv(ms, speed.clamp(min=cfg.dist_eps)), 1.0
    )
    vel = force * scale
    vel = torch.where(moving[:, None], vel, 0.0)
    return pos + vel * dt, vel


def physics_step(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    dt: Optional[float] = None,
) -> SwarmState:
    """One motion tick: formation retarget -> forces -> integrate.  The
    formation target steers this tick only; ``state.target`` keeps the
    user's nav goal."""
    return _physics_step_core(state, obstacles, cfg, None, dt)[0]


def physics_step_plan(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
    plan,
    dt: Optional[float] = None,
):
    """One motion tick with a carried hashgrid plan: refresh the Verlet
    plan against this tick's positions and alive set
    (``refresh_plan_partial`` with ``hashgrid_partial_refresh``, else
    ``refresh_plan``: one read from the device), run the tick off it, and
    return ``(state, plan)`` for the next tick.  Seed the carry with
    :func:`build_tick_plan`."""
    return _physics_step_core(state, obstacles, cfg, plan, dt)[:2]


def _physics_step_core(state, obstacles, cfg, plan, dt, on_device=False):
    """The tick body behind :func:`physics_step` and
    :func:`physics_step_plan`: ``(state, plan, full_needed or None)``.
    With ``on_device`` (a tick captured in a CUDA graph) a carried plan's
    refresh is decided on the device (``refresh_plan_on_device``):
    where the bool device scalar ``full_needed`` is false the result is
    :func:`physics_step_plan`'s, and where it is true the tick needed a
    full rebuild and the caller reruns it eagerly."""
    dt = cfg.dt if dt is None else dt
    full = None
    if plan is not None:
        # Refresh before the forces, so the exactness bound is checked
        # against the positions this tick's forces read.
        kw = dict(rebuild_every=cfg.hashgrid_rebuild_every)
        if on_device:
            plan, full = _hp.refresh_plan_on_device(
                state.pos, state.alive, plan,
                crosser_cap=cfg.hashgrid_partial_crosser_cap,
                partial=cfg.hashgrid_partial_refresh, **kw)
        elif cfg.hashgrid_partial_refresh:
            plan = _hp.refresh_plan_partial(
                state.pos, state.alive, plan,
                crosser_cap=cfg.hashgrid_partial_crosser_cap, **kw)
        else:
            plan = _hp.refresh_plan(state.pos, state.alive, plan, **kw)
    derived = formation_targets(state, cfg)
    force, _ = apf_forces_plan(derived, obstacles, cfg, plan)
    moving = derived.has_target & state.alive
    pos, vel = integrate(state.pos, force, moving, cfg, dt)
    pos = torch.where(moving[:, None], pos, state.pos)
    return state.replace(pos=pos, vel=vel), plan, full
