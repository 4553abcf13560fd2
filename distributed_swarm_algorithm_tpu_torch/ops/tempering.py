"""Parallel tempering (replica exchange) in plain PyTorch.

Counterpart of ``ops/tempering.py`` of the JAX package: the portable path,
on any device, for any callable objective.  The fused path for named
objectives is ``ops/cuda/tempering_fused.py``.

N Metropolis chains run the same landscape on a geometric temperature
ladder ``T_c = t_min (t_max / t_min)^(c / (C - 1))`` (chain 0 the coldest);
every ``swap_every`` steps adjacent chains exchange configurations with the
detailed-balance probability ``exp(min((1/T_i - 1/T_j)(f_i - f_j), 0))``,
pairing ``(i, i ^ 1)`` shifted by the round's parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import DeviceLike
from . import _family
from ._numerics import rdiv

T_MIN = 0.01        # coldest temperature
T_MAX = 10.0        # hottest temperature
SIGMA0 = 0.1        # proposal scale at T=1, in half_width units
SWAP_EVERY = 5      # exchange-round cadence, steps


@dataclass
class PTState(_family.FamilyState):
    """Struct-of-tensors replica ladder. C chains, D dims."""

    pos: torch.Tensor        # [C, D]
    fit: torch.Tensor        # [C]
    temps: torch.Tensor      # [C] geometric ladder, index 0 coldest
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


PT_TENSOR_FIELDS = _family.tensor_fields(PTState)

# One step's draws: the proposal normals [C, D], the accept uniforms [C] and
# the swap uniforms [C] (read only at an exchange round).
PTDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pt_init(
    objective: Callable,
    n: int,
    dim: int,
    half_width: float,
    t_min: float = T_MIN,
    t_max: float = T_MAX,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> PTState:
    gen, pos, fit = _family.init_population(objective, n, dim, half_width,
                                            seed, dtype, device)
    expo = (torch.arange(n, dtype=dtype, device=pos.device)
            / torch.tensor(float(max(n - 1, 1)), dtype=dtype,
                           device=pos.device))
    temps = t_min * torch.pow(
        torch.tensor(t_max / t_min, dtype=dtype, device=pos.device), expo)
    b = torch.argmin(fit)
    return PTState(
        pos=pos, fit=fit, temps=temps, best_pos=pos[b], best_fit=fit[b],
        gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=pos.device),
    )


def exchange(u_swap, pos, fit, temps, parity):
    """One replica-exchange round: chain i pairs with ``((i - parity) ^ 1)
    + parity`` where that is a chain; each pair swaps configurations with
    the detailed-balance probability, decided on the lower chain's uniform
    so both members agree.  ``parity`` is a device scalar."""
    c = fit.shape[0]
    idx = torch.arange(c, device=fit.device)
    partner = ((idx - parity) ^ 1) + parity
    valid = (partner >= 0) & (partner < c)
    partner = torch.clamp(partner, 0, c - 1)
    beta = rdiv(1.0, temps)
    delta = (beta - beta[partner]) * (fit - fit[partner])
    lower = torch.minimum(idx, partner)
    do_swap = valid & (u_swap[lower] < torch.exp(torch.clamp(delta,
                                                             max=0.0)))
    return (torch.where(do_swap[:, None], pos[partner], pos),
            torch.where(do_swap, fit[partner], fit))


def pt_draws(state: PTState) -> PTDraws:
    """One step's draws from ``state.gen``."""
    c, d = state.pos.shape
    dt, dev, gen = state.pos.dtype, state.device, state.gen
    return (torch.randn((c, d), generator=gen, dtype=dt, device=dev),
            torch.rand((c,), generator=gen, dtype=dt, device=dev),
            torch.rand((c,), generator=gen, dtype=dt, device=dev))


def pt_step(
    state: PTState,
    objective: Callable,
    half_width: float = 5.12,
    sigma0: float = SIGMA0,
    swap_every: int = SWAP_EVERY,
    draws: Optional[PTDraws] = None,
) -> PTState:
    """One step, with no read from the device: a Metropolis move per chain,
    and a replica-exchange round where ``(iteration + 1) % swap_every ==
    0`` (computed every step and selected on the device flag), alternating
    the pairing parity between rounds.  ``draws`` replaces the draws from
    ``state.gen`` (see ``PTDraws``)."""
    noise, u_acc, u_swap = pt_draws(state) if draws is None else draws

    # Temperature-scaled Gaussian proposal: hot chains stride further.
    sigma = sigma0 * half_width * torch.sqrt(state.temps)[:, None]
    cand = torch.clamp(state.pos + sigma * noise, -half_width, half_width)
    cand_fit = objective(cand)
    accept = u_acc < torch.exp(torch.clamp((state.fit - cand_fit)
                                           / state.temps, max=0.0))
    pos = torch.where(accept[:, None], cand, state.pos)
    fit = torch.where(accept, cand_fit, state.fit)

    it = state.iteration + 1
    parity = (it // swap_every) % 2
    swapped = exchange(u_swap, pos, fit, state.temps, parity)
    do_round = it % swap_every == 0
    pos = torch.where(do_round, swapped[0], pos)
    fit = torch.where(do_round, swapped[1], fit)

    best_fit, best_pos = _family.track_best(fit, pos, state.best_fit,
                                            state.best_pos)
    return PTState(pos=pos, fit=fit, temps=state.temps, best_pos=best_pos,
                   best_fit=best_fit, gen=state.gen, iteration=it)


def pt_run(
    state: PTState,
    objective: Callable,
    n_steps: int,
    half_width: float = 5.12,
    sigma0: float = SIGMA0,
    swap_every: int = SWAP_EVERY,
    draws: Optional[Sequence[PTDraws]] = None,
) -> PTState:
    """``n_steps`` steps; ``draws[i]`` replaces step i's."""
    for i in range(n_steps):
        state = pt_step(state, objective, half_width, sigma0, swap_every,
                        draws=None if draws is None else draws[i])
    return state


def pt_state_from_numpy(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike = None, seed: int = 0) -> PTState:
    """A PTState from numpy arrays named like its fields."""
    return _family.state_from_numpy(PTState, arrays, device, seed)


def pt_state_to_numpy(state: PTState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
