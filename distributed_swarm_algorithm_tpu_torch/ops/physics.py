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
from . import neighbors as _neighbors
from ._numerics import norm, rdiv
from .cuda import separation as _cuda_separation

# Modes of the JAX package that later slices port (ROADMAP Queue A).
_NOT_PORTED = {
    "grid": "item 6 (ops/neighbors.py:separation_grid)",
    "window": "item 6 (ops/neighbors.py:separation_window) and Queue B "
              "item 4 (window_separation.py)",
    "hashgrid": "items 7-8 (ops/hashgrid_plan.py, the plan path) and "
                "Queue B items 2-3",
}


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


def separation_force(state: SwarmState, cfg: SwarmConfig) -> torch.Tensor:
    """The separation-mode dispatch, [N, D]: "dense" all pairs by
    broadcast, "pallas" all pairs by the CUDA kernel (its plain version on
    the CPU), "off" none."""
    mode = cfg.separation_mode
    pos = state.pos
    if mode == "dense":
        return _neighbors.separation_dense(
            pos, state.alive, cfg.k_sep, cfg.personal_space, cfg.dist_eps
        )
    if mode == "pallas":
        return _cuda_separation.separation(
            pos, state.alive, cfg.k_sep, cfg.personal_space, cfg.dist_eps
        )
    if mode == "off":
        return torch.zeros_like(pos)
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"separation_mode={mode!r} is not ported yet (ROADMAP Queue A "
            f"{_NOT_PORTED[mode]})"
        )
    raise ValueError(
        f"unknown separation_mode {mode!r}; expected 'dense', 'pallas', "
        "'grid', 'window', 'hashgrid', or 'off'"
    )


def apf_forces(
    state: SwarmState,
    obstacles: Optional[torch.Tensor],
    cfg: SwarmConfig,
) -> torch.Tensor:
    """Total APF force per agent, [N, D]."""
    if cfg.k_align != 0.0 or cfg.k_coh != 0.0:
        raise NotImplementedError(
            "k_align/k_coh field forces are not ported yet (ROADMAP Queue "
            "A item 9: ops/grid_moments.py)"
        )
    return _apf_point_forces(state, obstacles, cfg) + separation_force(
        state, cfg
    )


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
    dt = cfg.dt if dt is None else dt
    derived = formation_targets(state, cfg)
    force = apf_forces(derived, obstacles, cfg)
    moving = derived.has_target & state.alive
    pos, vel = integrate(state.pos, force, moving, cfg, dt)
    pos = torch.where(moving[:, None], pos, state.pos)
    return state.replace(pos=pos, vel=vel)
