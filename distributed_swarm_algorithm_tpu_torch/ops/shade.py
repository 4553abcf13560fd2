"""SHADE (success-history adaptive DE, Tanabe & Fukunaga 2013) in plain
PyTorch.

Counterpart of ``ops/shade.py`` of the JAX package: the portable path, on
any device, for any callable objective.  The fused path for named
objectives is ``ops/cuda/shade_fused.py``.

Each individual samples F (Cauchy) and CR (normal) around a random slot of
a circular success memory, mutates with current-to-pbest/1 against an
external archive of defeated parents, and the memory takes the
improvement-weighted Lehmer mean (F) and arithmetic mean (CR) of the
successful settings.  As in the JAX package: F is one truncated Cauchy
draw, donor distinctness uses two mod-shift fixups, and the archive fills
in order and then replaces random slots (a slot written twice keeps the
later row).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import top_k

H = 10          # success-memory size
P_BEST = 0.11   # pbest fraction
F_SCALE = 0.1   # Cauchy scale for F
CR_SCALE = 0.1  # Normal scale for CR


@dataclass
class SHADEState(_family.FamilyState):
    """Struct-of-tensors SHADE population. N individuals, D dims."""

    pos: torch.Tensor        # [N, D]
    fit: torch.Tensor        # [N]
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    m_f: torch.Tensor        # [H] success memory for F
    m_cr: torch.Tensor       # [H] success memory for CR
    mem_k: torch.Tensor      # i32 scalar: next memory slot to update
    archive: torch.Tensor    # [N, D] defeated parents
    archive_n: torch.Tensor  # i32 scalar: valid archive rows
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


SHADE_TENSOR_FIELDS = _family.tensor_fields(SHADEState)

# One generation's draws, in the order of the JAX package's key split:
# slot [N] in [0, H), cauchy [N], normal [N], pb [N] in [0, n_top), r1 [N]
# in [0, N), r2 [N] in [0, N + archive_n), r [N, D] crossover uniforms,
# j_rand [N] in [0, D), rand_slot [N] in [0, N) (archive replacement).
SHADEDraws = Tuple[torch.Tensor, ...]


def n_top_of(n: int, p_best: float) -> int:
    """The size of the pbest pool: ``max(2, round(p_best * n))``."""
    return max(2, int(round(p_best * n)))


def shade_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> SHADEState:
    if n < 5:
        raise ValueError("SHADE needs a population of at least 5")
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    b = torch.argmin(fit)
    dev = pos.device
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa
    return SHADEState(
        pos=pos, fit=fit, best_pos=pos[b], best_fit=fit[b],
        m_f=torch.full((H,), 0.5, dtype=dtype, device=dev),
        m_cr=torch.full((H,), 0.5, dtype=dtype, device=dev),
        mem_k=i32(), archive=torch.zeros((n, dim), dtype=dtype, device=dev),
        archive_n=i32(), gen=gen, iteration=i32(),
    )


def shade_draws(state: SHADEState, p_best: float = P_BEST) -> SHADEDraws:
    """One generation's draws from ``state.gen``.  ``r2``'s range depends
    on ``archive_n``, a device value: it is a 62-bit draw reduced modulo
    ``N + archive_n`` (bias below 2^-40), so nothing is read back."""
    n, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen

    def ints(high):
        return torch.randint(0, high, (n,), generator=gen, device=dev)

    slot = ints(H)
    cauchy = torch.empty(n, dtype=dt, device=dev).cauchy_(generator=gen)
    normal = torch.randn(n, generator=gen, dtype=dt, device=dev)
    pb = ints(n_top_of(n, p_best))
    r1 = ints(n)
    r2 = ints(2**62) % (n + state.archive_n.long())
    r = torch.rand((n, d), generator=gen, dtype=dt, device=dev)
    return slot, cauchy, normal, pb, r1, r2, r, ints(d), ints(n)


def _mod_distinct(r, forbidden, size):
    """Shift ``r`` by one (mod size) where it collides with ``forbidden``."""
    return torch.where(r == forbidden, (r + 1) % size, r)


def last_write_scatter(dst: torch.Tensor, slots: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """``dst.at[slots].set(rows, mode="drop")`` as the JAX package runs it
    on the CPU: slots outside ``[0, len(dst))`` are dropped and a slot
    written twice keeps the later row.  Out of place, on the device."""
    m = dst.shape[0]
    src = torch.arange(slots.shape[0], device=dst.device)
    ok = (slots >= 0) & (slots < m)
    winner = torch.full((m + 1,), -1, dtype=torch.long, device=dst.device)
    winner = winner.scatter_reduce(0, torch.where(ok, slots, m), src, "amax")
    winner = winner[:m]
    took = winner >= 0
    return torch.where(took[:, None], rows[winner.clamp(min=0)], dst)


def memory_update(better, w, f, cr, m_f, m_cr, mem_k):
    """The success-history update, selected on the device: where any trial
    improved (``w`` its improvements, zero elsewhere), slot ``mem_k`` takes
    the weighted Lehmer mean of F and the weighted mean of CR, and the slot
    pointer advances."""
    w_sum = torch.sum(w)
    any_success = w_sum > 0.0
    safe = torch.where(any_success, w_sum, torch.ones_like(w_sum))
    new_mf = torch.sum(w * f * f) / torch.clamp(torch.sum(w * f), min=1e-12)
    new_mcr = torch.sum(w * cr) / safe
    at_k = (torch.arange(m_f.shape[0], device=m_f.device) == mem_k) \
        & any_success
    m_f = torch.where(at_k, new_mf.to(m_f.dtype), m_f)
    m_cr = torch.where(at_k, new_mcr.to(m_cr.dtype), m_cr)
    mem_k = torch.where(any_success, (mem_k + 1) % m_f.shape[0],
                        mem_k).to(torch.int32)
    return m_f, m_cr, mem_k


def shade_step(
    state: SHADEState,
    objective: Callable,
    half_width: float = 5.12,
    p_best: float = P_BEST,
    draws: Optional[SHADEDraws] = None,
) -> SHADEState:
    """One SHADE generation, with no read from the device: memory-sampled
    F and CR, current-to-pbest/1 with the archive, greedy selection, then
    the archive and memory updates.  ``draws`` replaces the draws from
    ``state.gen`` (see ``SHADEDraws``)."""
    n, d = state.pos.shape
    (slot, cauchy, normal, pb, r1, r2, r, j_rand, rand_slot) = (
        shade_draws(state, p_best) if draws is None else draws)
    slot, pb, r1, r2, j_rand, rand_slot = (
        t.long() for t in (slot, pb, r1, r2, j_rand, rand_slot))
    pos, fit = state.pos, state.fit

    f = torch.clamp(state.m_f[slot] + F_SCALE * cauchy, 0.01, 1.0)[:, None]
    cr = torch.clamp(state.m_cr[slot] + CR_SCALE * normal, 0.0, 1.0)

    top_idx = top_k(-fit, n_top_of(n, p_best))
    x_pb = pos[top_idx[pb]]
    rows = torch.arange(n, device=pos.device)
    r1 = _mod_distinct(r1, rows, n)
    pool = n + state.archive_n.long()
    r2 = _mod_distinct(_mod_distinct(r2, rows, pool), r1, pool)
    x_r2 = torch.where((r2 >= n)[:, None],
                       state.archive[torch.clamp(r2 - n, 0, n - 1)],
                       pos[torch.clamp(r2, 0, n - 1)])
    mutant = pos + f * (x_pb - pos) + f * (pos[r1] - x_r2)
    mutant = torch.clamp(mutant, -half_width, half_width)

    cols = torch.arange(d, device=pos.device)[None, :]
    cross = (r < cr[:, None]) | (cols == j_rand[:, None])
    trial = torch.where(cross, mutant, pos)
    trial_fit = objective(trial)

    better = trial_fit < fit                            # strict: success
    accept = trial_fit <= fit
    new_pos = torch.where(accept[:, None], trial, pos)
    new_fit = torch.where(accept, trial_fit, fit)

    # The archive: defeated parents in, filling in order, then at random.
    seq_slot = state.archive_n.long() + torch.cumsum(better.long(), 0) - 1
    a_slot = torch.where(seq_slot < n, seq_slot, rand_slot)
    a_slot = torch.where(better, a_slot, torch.full_like(a_slot, n))
    archive = last_write_scatter(state.archive, a_slot, pos)
    archive_n = torch.clamp(state.archive_n + better.sum(), max=n).to(
        torch.int32)

    w = torch.where(better, fit - trial_fit, torch.zeros_like(fit))
    m_f, m_cr, mem_k = memory_update(better, w, f[:, 0], cr, state.m_f,
                                     state.m_cr, state.mem_k)
    best_fit, best_pos = _family.track_best(new_fit, new_pos, state.best_fit,
                                            state.best_pos)
    return SHADEState(
        pos=new_pos, fit=new_fit, best_pos=best_pos, best_fit=best_fit,
        m_f=m_f, m_cr=m_cr, mem_k=mem_k, archive=archive,
        archive_n=archive_n, gen=state.gen, iteration=state.iteration + 1,
    )


def shade_run(
    state: SHADEState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    p_best: float = P_BEST,
    draws: Optional[Sequence[SHADEDraws]] = None,
) -> SHADEState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's."""
    for i in range(n_steps):
        state = shade_step(state, objective, half_width, p_best,
                           draws=None if draws is None else draws[i])
    return state


def shade_state_from_numpy(arrays: Mapping[str, np.ndarray],
                           device: DeviceLike = None, seed: int = 0
                           ) -> SHADEState:
    """A SHADEState from numpy arrays named like its fields."""
    return _family.state_from_numpy(SHADEState, arrays, device, seed)


def shade_state_to_numpy(state: SHADEState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
