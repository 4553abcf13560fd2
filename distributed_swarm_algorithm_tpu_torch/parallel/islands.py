"""Island-model multi-swarm PSO with ring migration, on one device.

Counterpart of ``parallel/islands.py`` of the JAX package.  Each island is
an independent PSO swarm with its own gbest; every ``migrate_every``
iterations each island ships its ``k`` best particles to the next island
on a ring, replacing that island's ``k`` worst.

All island state is stacked on a leading island axis ``[I, n, ...]``.
Where the JAX package maps its single-swarm step over that axis with
``jax.vmap``, this module writes the axis out; the migration is a
``torch.roll`` along it.  The fused path is ``ops/cuda/islands_fused.py``.
Sharding the island axis over several devices is not ported yet (ROADMAP
Queue A item 17).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops import pso as _pso
from ..utils.platform import DeviceLike, resolve_device


@dataclass
class IslandPSOState:
    """Stacked per-island PSO state: I islands x n particles x D dims."""

    pso: _pso.PSOState        # every tensor carries a leading island axis
    iteration: torch.Tensor   # i32 scalar (shared; islands step in lockstep)

    def replace(self, **kw) -> "IslandPSOState":
        return dataclasses.replace(self, **kw)

    @property
    def n_islands(self) -> int:
        return self.pso.pos.shape[0]


def _take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[i, idx[i, j]]`` for ``arr`` [I, n] or [I, n, D]."""
    if arr.ndim == 3:
        idx = idx[..., None].expand(-1, -1, arr.shape[-1])
    return torch.gather(arr, 1, idx)


def _island_bests(pbest_fit, pbest_pos, gbest_fit, gbest_pos):
    """Refresh each island's gbest from its pbest arrays."""
    best = torch.argmin(pbest_fit, dim=1, keepdim=True)      # [I, 1]
    cand_fit = _take_rows(pbest_fit, best)[:, 0]
    cand_pos = _take_rows(pbest_pos, best)[:, 0]
    better = cand_fit < gbest_fit
    return (torch.where(better, cand_fit, gbest_fit),
            torch.where(better[:, None], cand_pos, gbest_pos))


def island_init(
    objective: Callable,
    n_islands: int,
    n_per_island: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> IslandPSOState:
    """Uniform positions in the domain for every island, drawn from one
    generator (not JAX's numbers for the same seed)."""
    dev = resolve_device(device)
    gen = _pso._generator(dev, seed)
    shape = (n_islands, n_per_island, dim)
    pos = _pso._uniform(gen, shape, dtype, dev, -half_width, half_width)
    vel = _pso._uniform(gen, shape, dtype, dev, -half_width, half_width) * 0.1
    fit = objective(pos)                                     # [I, n]
    best = torch.argmin(fit, dim=1, keepdim=True)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pso = _pso.PSOState(
        pos=pos, vel=vel, pbest_pos=pos, pbest_fit=fit,
        gbest_pos=_take_rows(pos, best)[:, 0],
        gbest_fit=_take_rows(fit, best)[:, 0],
        gen=gen, iteration=zero.expand(n_islands).clone(),
    )
    return IslandPSOState(pso=pso, iteration=zero)


def smallest_k(fit: torch.Tensor, k: int) -> torch.Tensor:
    """[I, k] indices of every island's ``k`` smallest entries of ``fit``
    [I, n], the lowest index first among equals (a stable sort, the order
    of ``jax.lax.top_k`` on the negated values)."""
    return torch.sort(fit, dim=1, stable=True).indices[:, :k]


def largest_k(fit: torch.Tensor, k: int) -> torch.Tensor:
    """[I, k] indices of the ``k`` largest entries, the lowest index first
    among equals (the order of ``jax.lax.top_k``)."""
    return torch.sort(fit, dim=1, descending=True,
                      stable=True).indices[:, :k]


def migrate(state: IslandPSOState, k: int) -> IslandPSOState:
    """Ring migration: island i's k best pbest particles replace island
    (i+1)'s k worst; their velocities are zeroed and the island gbests
    refreshed."""
    pso = state.pso
    fit = pso.pbest_fit                                   # [I, n]
    best_idx, worst_idx = smallest_k(fit, k), largest_k(fit, k)
    in_pos = torch.roll(_take_rows(pso.pbest_pos, best_idx), 1, 0)
    in_fit = torch.roll(_take_rows(fit, best_idx), 1, 0)  # ring: i -> i+1

    wide = worst_idx[..., None].expand(-1, -1, pso.pos.shape[-1])
    pos = pso.pos.scatter(1, wide, in_pos)
    pbest_pos = pso.pbest_pos.scatter(1, wide, in_pos)
    pbest_fit = fit.scatter(1, worst_idx, in_fit)
    vel = pso.vel.scatter(1, wide, torch.zeros_like(in_pos))

    gbest_fit, gbest_pos = _island_bests(pbest_fit, pbest_pos,
                                         pso.gbest_fit, pso.gbest_pos)
    return state.replace(
        pso=pso.replace(
            pos=pos, vel=vel, pbest_pos=pbest_pos, pbest_fit=pbest_fit,
            gbest_fit=gbest_fit, gbest_pos=gbest_pos,
        )
    )


def _islands_step(pso, objective, w, c1, c2, half_width, vmax_frac, r1, r2):
    """One gbest PSO iteration of every island (ops/pso.pso_step with the
    island axis written out)."""
    shape, dtype, dev = pso.pos.shape, pso.pos.dtype, pso.pos.device
    if r1 is None:
        r1 = torch.rand(shape, generator=pso.gen, dtype=dtype, device=dev)
        r2 = torch.rand(shape, generator=pso.gen, dtype=dtype, device=dev)
    vel = (
        w * pso.vel
        + c1 * r1 * (pso.pbest_pos - pso.pos)
        + c2 * r2 * (pso.gbest_pos[:, None, :] - pso.pos)
    )
    vmax = half_width * vmax_frac
    vel = torch.clamp(vel, -vmax, vmax)
    pos = torch.clamp(pso.pos + vel, -half_width, half_width)
    fit = objective(pos)
    improved = fit < pso.pbest_fit
    pbest_fit = torch.where(improved, fit, pso.pbest_fit)
    pbest_pos = torch.where(improved[..., None], pos, pso.pbest_pos)
    gbest_fit, gbest_pos = _island_bests(pbest_fit, pbest_pos,
                                         pso.gbest_fit, pso.gbest_pos)
    return pso.replace(
        pos=pos, vel=vel, pbest_pos=pbest_pos, pbest_fit=pbest_fit,
        gbest_pos=gbest_pos, gbest_fit=gbest_fit,
        iteration=pso.iteration + 1,
    )


def island_run(
    state: IslandPSOState,
    objective: Callable,
    n_steps: int,
    migrate_every: int = 25,
    migrate_k: int = 4,
    w: float = _pso.W,
    c1: float = _pso.C1,
    c2: float = _pso.C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    telemetry: bool = False,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> IslandPSOState:
    """Run all islands in lockstep, migrating whenever the iteration
    counter reaches a multiple of ``migrate_every``.  The counter is read
    from the device once, at the start.  ``uniforms = (r1, r2)``, each
    [n_steps, I, n, D], replaces the draws from the state's generator."""
    if telemetry:
        raise NotImplementedError(
            "island telemetry is not ported yet (ROADMAP Queue A item 11: "
            "utils/telemetry.py)"
        )
    iteration = int(state.iteration)
    for i in range(n_steps):
        r1, r2 = (None, None) if uniforms is None else (
            uniforms[0][i], uniforms[1][i])
        state = state.replace(
            pso=_islands_step(state.pso, objective, w, c1, c2, half_width,
                              vmax_frac, r1, r2),
            iteration=state.iteration + 1,
        )
        iteration += 1
        if iteration % migrate_every == 0:
            state = migrate(state, migrate_k)
    return state


def global_best(state: IslandPSOState):
    """(fit, pos) of the best particle across all islands."""
    i = torch.argmin(state.pso.gbest_fit).reshape(1)
    return (state.pso.gbest_fit.index_select(0, i)[0],
            state.pso.gbest_pos.index_select(0, i)[0])


def island_state_from_numpy(
    arrays: Mapping[str, np.ndarray],
    device: DeviceLike = None,
    seed: int = 0,
) -> IslandPSOState:
    """Build a state from the stacked PSO fields as numpy arrays (the JAX
    state's ``pso`` fields; its keys are ignored) and ``island_iteration``,
    the shared counter (default: the first island's)."""
    pso = _pso.pso_state_from_numpy(arrays, device, seed)
    shared = arrays.get("island_iteration")
    iteration = (pso.iteration.reshape(-1)[0].clone() if shared is None
                 else torch.from_numpy(np.array(shared, copy=True))
                 .to(pso.device))
    return IslandPSOState(pso=pso, iteration=iteration)


def island_state_to_numpy(state: IslandPSOState) -> dict[str, np.ndarray]:
    """The inverse of :func:`island_state_from_numpy`."""
    out = _pso.pso_state_to_numpy(state.pso)
    out["island_iteration"] = state.iteration.cpu().numpy()
    return out
