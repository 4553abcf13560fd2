"""Particle-swarm-optimization steps in plain PyTorch.

Counterpart of ``ops/pso.py`` of the JAX package: the portable path, on
any device, for any callable objective and every topology.  The fused
path for named objectives is ``ops/cuda/pso_fused.py``.

Update rule (standard constricted gbest PSO, Clerc & Kennedy 2002):
    v' = w*v + c1*r1*(pbest - x) + c2*r2*(gbest - x)
    x' = clip(x + clip(v', +-vmax), domain)

Draws come from ``state.gen`` unless the caller hands them in (``r1``,
``r2``, ``uniforms``): PyTorch's generator and JAX's keys give different
numbers from one seed, so a test computes JAX's draws and injects them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device
from . import topology as _topo

# Clerc-Kennedy constriction defaults.
W = 0.7298
C1 = 1.49618
C2 = 1.49618


@dataclass
class PSOState:
    """Struct-of-tensors particle state. N particles, D dims.  The island
    model stacks a leading island axis on every tensor field."""

    pos: torch.Tensor        # [N, D]
    vel: torch.Tensor        # [N, D]
    pbest_pos: torch.Tensor  # [N, D]
    pbest_fit: torch.Tensor  # [N]
    gbest_pos: torch.Tensor  # [D]
    gbest_fit: torch.Tensor  # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar

    def replace(self, **kw) -> "PSOState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.pos.device


PSO_TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(PSOState) if f.name != "gen"
)


def _uniform(gen, shape, dtype, device, lo: float, hi: float):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return lo + (hi - lo) * u


def pso_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> PSOState:
    """Uniform positions in the domain, velocities a tenth of it, drawn
    from the state's generator (not JAX's numbers for the same seed)."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    pos = _uniform(gen, (n, dim), dtype, dev, -half_width, half_width)
    vel = _uniform(gen, (n, dim), dtype, dev, -half_width, half_width) * 0.1
    fit = objective(pos)
    best = torch.argmin(fit)
    return PSOState(
        pos=pos,
        vel=vel,
        pbest_pos=pos,
        pbest_fit=fit,
        gbest_pos=pos[best],
        gbest_fit=fit[best],
        gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
    )


def pso_step(
    state: PSOState,
    objective: Callable,
    w: float = W,
    c1: float = C1,
    c2: float = C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    topology: str = "gbest",
    ring_radius: int = 1,
    grid_cols: int = 0,
    r1: Optional[torch.Tensor] = None,
    r2: Optional[torch.Tensor] = None,
) -> PSOState:
    """One PSO iteration, with no read from the device.

    ``topology`` selects the social attractor: ``"gbest"`` uses the running
    global best; ``"ring"``/``"vonneumann"`` use a per-particle neighborhood
    best over pbest (ops/topology.py).  ``r1``/``r2`` ([N, D] uniforms)
    replace the draws from ``state.gen``.
    """
    shape, dtype, dev = state.pos.shape, state.pos.dtype, state.device
    if r1 is None:
        r1 = torch.rand(shape, generator=state.gen, dtype=dtype, device=dev)
    if r2 is None:
        r2 = torch.rand(shape, generator=state.gen, dtype=dtype, device=dev)

    if topology == "gbest":
        social = state.gbest_pos[None, :]
    else:
        social, _ = _topo.neighbor_best(
            state.pbest_fit, state.pbest_pos, topology,
            radius=ring_radius, cols=grid_cols,
        )
    vel = (
        w * state.vel
        + c1 * r1 * (state.pbest_pos - state.pos)
        + c2 * r2 * (social - state.pos)
    )
    vmax = half_width * vmax_frac
    vel = torch.clamp(vel, -vmax, vmax)
    pos = torch.clamp(state.pos + vel, -half_width, half_width)

    fit = objective(pos)
    improved = fit < state.pbest_fit
    pbest_fit = torch.where(improved, fit, state.pbest_fit)
    pbest_pos = torch.where(improved[:, None], pos, state.pbest_pos)

    best = torch.argmin(pbest_fit)
    cand_fit = pbest_fit[best]
    cand_pos = pbest_pos[best]
    better = cand_fit < state.gbest_fit
    gbest_fit = torch.where(better, cand_fit, state.gbest_fit)
    gbest_pos = torch.where(better, cand_pos, state.gbest_pos)

    return PSOState(
        pos=pos,
        vel=vel,
        pbest_pos=pbest_pos,
        pbest_fit=pbest_fit,
        gbest_pos=gbest_pos,
        gbest_fit=gbest_fit,
        gen=state.gen,
        iteration=state.iteration + 1,
    )


def pso_run(
    state: PSOState,
    objective: Callable,
    n_steps: int,
    w: float = W,
    c1: float = C1,
    c2: float = C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    topology: str = "gbest",
    ring_radius: int = 1,
    grid_cols: int = 0,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> PSOState:
    """``n_steps`` iterations.  ``uniforms = (r1, r2)``, each
    [n_steps, N, D], replaces the draws from ``state.gen``."""
    for i in range(n_steps):
        r1, r2 = (None, None) if uniforms is None else (
            uniforms[0][i], uniforms[1][i])
        state = pso_step(state, objective, w, c1, c2, half_width, vmax_frac,
                         topology, ring_radius, grid_cols, r1=r1, r2=r2)
    return state


def pso_state_from_numpy(
    arrays: Mapping[str, np.ndarray],
    device: DeviceLike = None,
    seed: int = 0,
) -> PSOState:
    """Build a state from numpy arrays named like the fields (the JAX
    state's fields as numpy; its ``key`` is ignored).  Dtypes are kept as
    given; ``gen`` is a fresh generator seeded with ``seed``.  A stacked
    island state (a leading island axis on every field) passes through
    unchanged."""
    dev = resolve_device(device)
    missing = [f for f in PSO_TENSOR_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"pso_state_from_numpy: missing fields {missing}")
    return PSOState(
        gen=_generator(dev, seed),
        **{
            f: torch.from_numpy(np.array(arrays[f], copy=True)).to(dev)
            for f in PSO_TENSOR_FIELDS
        },
    )


def pso_state_to_numpy(state: PSOState) -> dict[str, np.ndarray]:
    """Every tensor field as a numpy array (the inverse of
    :func:`pso_state_from_numpy`; the generator is left out)."""
    return {f: getattr(state, f).cpu().numpy() for f in PSO_TENSOR_FIELDS}
