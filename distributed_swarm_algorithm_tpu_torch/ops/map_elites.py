"""MAP-Elites quality-diversity search (Mouret & Clune 2015) in PyTorch.

Counterpart of ``ops/map_elites.py`` of the JAX package.  The archive is a
dense ``[cells, D]`` array, empty cells marked by +inf fitness.  A
generation picks parents uniformly among the filled cells (Gumbel-argmax
over the filled mask), mutates them with Gaussian noise, evaluates
objective and descriptor, and inserts elitistically: per cell the best
candidate, ties to the lowest batch row, replaces a worse incumbent (two
``scatter_reduce("amin")`` passes, the JAX package's two ``segment_min``).

The JAX generation runs compiled, where XLA turns a division by a static
constant into a product with the f32 reciprocal; the cell index reads the
quotient, so the port computes that form everywhere (``cell_index`` here,
the model's default descriptor).  Both draws can be handed in.  A
generation on the card reads nothing back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device
from . import _family
from ._numerics import recip_mul

SIGMA_MUT = 0.1   # Gaussian mutation scale, in half_width units


@dataclass
class MapElitesState(_family.FamilyState):
    """Dense elite archive: C = bins**B cells, D solution dims."""

    archive_pos: torch.Tensor   # [C, D]
    archive_fit: torch.Tensor   # [C]; +inf = empty cell
    gen: torch.Generator        # draws (JAX: key)
    iteration: torch.Tensor     # i32 scalar

    @property
    def device(self) -> torch.device:
        return self.archive_pos.device


ME_TENSOR_FIELDS = _family.tensor_fields(MapElitesState)

# One generation's draws: the Gumbel noise [batch, C] of the parent choice
# and the mutation's standard normals [batch, D].
MEDraws = Tuple[torch.Tensor, torch.Tensor]


def cell_index(desc: torch.Tensor, bins: int, lo: float,
               hi: float) -> torch.Tensor:
    """[K] int32 flat cell index from [K, B] descriptors expected in
    [lo, hi] (out-of-range descriptors go to the boundary cells, NaN to
    cell 0 as XLA converts it)."""
    k, b = desc.shape
    idx = torch.floor(recip_mul(desc - lo, hi - lo) * bins)
    idx = torch.nan_to_num(idx, nan=0.0).clamp(0, bins - 1).to(torch.int32)
    flat = torch.zeros((k,), dtype=torch.int32, device=desc.device)
    for j in range(b):
        flat = flat * bins + idx[:, j]
    return flat


def insert(
    archive_pos: torch.Tensor,
    archive_fit: torch.Tensor,
    pos: torch.Tensor,
    fit: torch.Tensor,
    cells: torch.Tensor,
):
    """Batched elitist insert: per cell, the best of the incumbent and its
    candidates, candidates' ties to the lowest batch row.  Returns the
    updated (archive_pos, archive_fit)."""
    c = archive_fit.shape[0]
    k = fit.shape[0]
    cells = cells.long()
    best = torch.full((c,), float("inf"), dtype=fit.dtype,
                      device=fit.device).scatter_reduce(
        0, cells, fit, "amin")
    at_best = fit <= best.index_select(0, cells)
    rows = torch.arange(k, device=fit.device)
    row = torch.full((c,), k, dtype=rows.dtype, device=fit.device)
    row = row.scatter_reduce(0, cells, torch.where(
        at_best, rows, torch.full_like(rows, k)), "amin")
    better = (row < k) & (best < archive_fit)
    new_fit = torch.where(better, best, archive_fit)
    cand = pos.index_select(0, torch.clamp(row, max=k - 1))
    new_pos = torch.where(better[:, None], cand, archive_pos)
    return new_pos, new_fit


def me_init(
    objective: Callable,
    descriptor: Callable,
    dim: int,
    bins: int,
    behavior_dims: int,
    half_width: float,
    lo: float = 0.0,
    hi: float = 1.0,
    n_init: int = 256,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    pos: Optional[torch.Tensor] = None,
) -> MapElitesState:
    """Seed the archive with ``n_init`` solutions; ``pos`` [n_init, dim]
    replaces their uniform draw in the domain from a generator seeded with
    ``seed``."""
    dev = resolve_device(device)
    c = bins ** behavior_dims
    gen = _generator(dev, seed)
    if pos is None:
        pos = _family.uniform(gen, (n_init, dim), dtype, dev, -half_width,
                              half_width)
    a_pos, a_fit = insert(
        torch.zeros((c, dim), dtype=pos.dtype, device=dev),
        torch.full((c,), float("inf"), dtype=pos.dtype, device=dev),
        pos, objective(pos), cell_index(descriptor(pos), bins, lo, hi))
    return MapElitesState(archive_pos=a_pos, archive_fit=a_fit, gen=gen,
                          iteration=torch.zeros((), dtype=torch.int32,
                                                device=dev))


def me_draws(state: MapElitesState, batch: int) -> MEDraws:
    """One generation's draws from ``state.gen``: Gumbel noise as JAX draws
    it, ``-log(-log(u))`` with u in [tiny, 1), and normals."""
    c, d = state.archive_pos.shape
    dt, dev = state.archive_pos.dtype, state.device
    u = torch.rand((batch, c), generator=state.gen, dtype=dt, device=dev)
    u = torch.clamp(u, min=torch.finfo(dt).tiny)
    gumbel = -torch.log(-torch.log(u))
    return gumbel, torch.randn((batch, d), generator=state.gen, dtype=dt,
                               device=dev)


def me_step(
    state: MapElitesState,
    objective: Callable,
    descriptor: Callable,
    bins: int,
    half_width: float = 5.12,
    lo: float = 0.0,
    hi: float = 1.0,
    batch: int = 256,
    sigma_mut: float = SIGMA_MUT,
    draws: Optional[MEDraws] = None,
) -> MapElitesState:
    """One generation: parents uniform over the filled cells, Gaussian
    mutation, evaluation, elitist insert.  ``draws`` replaces the draws
    from ``state.gen`` (see ``MEDraws``)."""
    gumbel, noise = me_draws(state, batch) if draws is None else draws
    filled = torch.isfinite(state.archive_fit)
    logits = torch.where(filled, torch.zeros_like(state.archive_fit),
                         torch.full_like(state.archive_fit, -float("inf")))
    parents = torch.argmax(logits[None, :] + gumbel, dim=1)
    children = (state.archive_pos.index_select(0, parents)
                + sigma_mut * half_width * noise)
    children = torch.clamp(children, -half_width, half_width)
    a_pos, a_fit = insert(
        state.archive_pos, state.archive_fit, children, objective(children),
        cell_index(descriptor(children), bins, lo, hi))
    return MapElitesState(archive_pos=a_pos, archive_fit=a_fit,
                          gen=state.gen, iteration=state.iteration + 1)


def me_run(
    state: MapElitesState,
    objective: Callable,
    descriptor: Callable,
    n_steps: int,
    bins: int,
    half_width: float = 5.12,
    lo: float = 0.0,
    hi: float = 1.0,
    batch: int = 256,
    sigma_mut: float = SIGMA_MUT,
    draws: Optional[Sequence[MEDraws]] = None,
) -> MapElitesState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = me_step(state, objective, descriptor, bins, half_width, lo,
                        hi, batch, sigma_mut,
                        draws=None if draws is None else draws[i])
    return state


def coverage(state: MapElitesState) -> torch.Tensor:
    """Fraction of cells holding an elite (a 0-dim tensor in [0, 1])."""
    return torch.isfinite(state.archive_fit).to(torch.float32).mean()


def qd_score(state: MapElitesState, offset: float = 0.0) -> torch.Tensor:
    """Sum of (offset - fitness) over the filled cells: the usual
    quality-diversity score for minimization."""
    filled = torch.isfinite(state.archive_fit)
    return torch.where(filled, offset - state.archive_fit,
                       torch.zeros_like(state.archive_fit)).sum()


def me_state_from_numpy(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike = None,
                        seed: int = 0) -> MapElitesState:
    """A MapElitesState from numpy arrays named like its fields."""
    return _family.state_from_numpy(MapElitesState, arrays, device, seed)


def me_state_to_numpy(state: MapElitesState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
