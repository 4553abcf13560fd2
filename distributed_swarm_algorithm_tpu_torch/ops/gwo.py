"""Grey wolf optimizer (Mirjalili et al. 2014) in plain PyTorch.

Counterpart of ``ops/gwo.py`` of the JAX package: the portable path, on any
device, for any callable objective.  The fused path for named objectives
is ``ops/cuda/gwo_fused.py``.

The pack moves toward its three leaders (alpha, beta, delta) under the
exploration schedule ``a: 2 -> 0`` over ``t_max`` iterations; after each
step the leaders are the best three of (incumbent leaders ++ pack), ranked
as ``lax.top_k`` ranks: by fitness, ties to the earlier entry
(:func:`stable_top3`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import div, monotone

_INT64_MAX = 2**63 - 1


@dataclass
class GWOState(_family.FamilyState):
    pos: torch.Tensor         # [N, D]
    fit: torch.Tensor         # [N]
    leaders: torch.Tensor     # [3, D] alpha/beta/delta positions
    leader_fit: torch.Tensor  # [3]
    gen: torch.Generator      # draws (JAX: key)
    iteration: torch.Tensor   # i32 scalar


GWO_TENSOR_FIELDS = _family.tensor_fields(GWOState)


def _order_key(fit: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (fitness, index) lexicographically: the
    f32 fitness's bits made monotone in the high word, the index in the low
    word.  Every key is distinct, so no tie is left to break."""
    mono = monotone(fit.view(torch.int32), 0x7FFFFFFF).to(torch.int64)
    idx = torch.arange(fit.shape[0], dtype=torch.int64, device=fit.device)
    return mono * 2**32 + idx


def stable_top3(fit: torch.Tensor) -> torch.Tensor:
    """int64 [3]: the indices of the three least entries of ``fit`` [M]
    (M >= 3), least first, equal values in index order: what
    ``lax.top_k(-fit, 3)`` returns.  Three argmins over distinct keys, each
    winner masked out; no sort, no read from the device.  (A float64
    pack, which the keys cannot hold, takes a stable sort of its bits.)"""
    if fit.dtype == torch.float64:
        mono = monotone(fit.view(torch.int64), 0x7FFFFFFFFFFFFFFF)
        return torch.sort(mono, stable=True).indices[:3]
    key = _order_key(fit.to(torch.float32).contiguous())
    picks = []
    for _ in range(3):
        j = torch.argmin(key).reshape(1)
        picks.append(j)
        key = key.index_fill(0, j, _INT64_MAX)
    return torch.cat(picks)


def rerank_leaders(leaders, leader_fit, pack_pos_t, pack_fit):
    """The best three of (incumbent leaders ++ pack): ``leaders`` [3, D],
    ``leader_fit`` [3], the pack as ``pack_pos_t`` [D, M] and ``pack_fit``
    [M].  Only the three winners' columns are gathered."""
    top = stable_top3(torch.cat([leader_fit.to(pack_fit.dtype), pack_fit]))
    from_pack = top >= 3
    cols = pack_pos_t.index_select(1, (top - 3).clamp(min=0)).T
    rows = leaders.to(cols.dtype).index_select(0, top.clamp(max=2))
    new_fit = torch.where(
        from_pack, pack_fit.index_select(0, (top - 3).clamp(min=0)),
        leader_fit.to(pack_fit.dtype).index_select(0, top.clamp(max=2)))
    return torch.where(from_pack[:, None], cols, rows), new_fit


def gwo_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> GWOState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    top3 = stable_top3(fit)
    return GWOState(
        pos=pos,
        fit=fit,
        leaders=pos[top3],
        leader_fit=fit[top3],
        gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def gwo_step(
    state: GWOState,
    objective: Callable,
    half_width: float = 5.12,
    t_max: int = 500,
    r: Optional[torch.Tensor] = None,
) -> GWOState:
    """One pack update, with no read from the device.  ``t_max`` sets the
    a: 2 -> 0 schedule; past it the pack stays in full exploitation (a=0).
    ``r`` [2, 3, N, D] replaces the draws from ``state.gen``."""
    if t_max < 1:
        raise ValueError(f"t_max must be >= 1, got {t_max}")
    n, d = state.pos.shape
    dt = state.pos.dtype
    frac = torch.clamp(div(state.iteration.to(dt), t_max), max=1.0)
    a = 2.0 * (1.0 - frac)
    if r is None:
        r = torch.rand((2, 3, n, d), generator=state.gen, dtype=dt,
                       device=state.device)
    big_a = 2.0 * a * r[0] - a                       # [3, N, D]
    big_c = 2.0 * r[1]                               # [3, N, D]
    lead = state.leaders[:, None, :]                 # [3, 1, D]
    dist = torch.abs(big_c * lead - state.pos[None])
    x = lead - big_a * dist
    pos = torch.clamp(div(x[0] + x[1] + x[2], 3.0), -half_width, half_width)

    fit = objective(pos)
    leaders, leader_fit = rerank_leaders(state.leaders, state.leader_fit,
                                         pos.T, fit)
    return GWOState(pos=pos, fit=fit, leaders=leaders.to(dt),
                    leader_fit=leader_fit.to(state.leader_fit.dtype),
                    gen=state.gen, iteration=state.iteration + 1)


def gwo_run(
    state: GWOState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    t_max: int = 500,
    r: Optional[torch.Tensor] = None,
) -> GWOState:
    """``n_steps`` pack updates; ``r`` [n_steps, 2, 3, N, D] replaces the
    draws."""
    for i in range(n_steps):
        state = gwo_step(state, objective, half_width, t_max,
                         r=None if r is None else r[i])
    return state


def gwo_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: DeviceLike = None, seed: int = 0
                         ) -> GWOState:
    """A GWOState from numpy arrays named like its fields."""
    return _family.state_from_numpy(GWOState, arrays, device, seed)


def gwo_state_to_numpy(state: GWOState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
