"""CMA-ES, Hansen's (mu/mu_w, lambda) evolution strategy, in PyTorch.

Counterpart of ``ops/cmaes.py`` of the JAX package.  A generation
decomposes the covariance ``C = B diag(d) B^T`` (``torch.linalg.eigh``, as
the JAX package calls ``jnp.linalg.eigh``), samples ``x = m + sigma z (B
sqrt(d))^T``, recombines the best mu with log weights, and updates the two
evolution paths, the covariance (rank one and rank mu) and the step size.
The [lambda, D] and [D, D] products are ``torch.matmul`` with TF32 off.

Parity with the JAX package:

- an eigenbasis is not a contract between libraries (the eigenvectors'
  signs, the order of equal eigenvalues), so ``cmaes_step`` takes one, and
  the normal draw ``z``, as optional arguments;
- ``cmaes_run`` is compiled in JAX, where XLA turns the divisions by the
  static ``chi_n`` into products with the f32 reciprocal; the stall gate
  ``h_sigma`` reads that quotient, so the port computes that form;
- the square roots of the static constants are taken of their f32 values,
  in f32, as ``jnp.sqrt`` of a Python float is;
- ``cmaes_params`` builds the weights in f32 through ``log``, as the JAX
  package does; XLA's f32 ``log`` is not correctly rounded (PyTorch's is)
  and its sum runs in another order, so the weights may differ from JAX's
  in the last bits, and a test hands the JAX package's params in.

``eigh`` on the card reads its error code back on the host: the one
device wait of a generation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device
from . import _family
from ._numerics import matmul, recip_mul, sqrt_rn


@dataclass
class CMAESState(_family.FamilyState):
    """The strategy's state: D dims, lambda samples a generation."""

    mean: torch.Tensor       # [D]
    sigma: torch.Tensor      # scalar step size
    cov: torch.Tensor        # [D, D] covariance (symmetric PSD)
    p_sigma: torch.Tensor    # [D] conjugate evolution path
    p_c: torch.Tensor        # [D] covariance evolution path
    best_pos: torch.Tensor   # [D]
    best_fit: torch.Tensor   # scalar
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar

    @property
    def device(self) -> torch.device:
        return self.mean.device


CMAES_TENSOR_FIELDS = _family.tensor_fields(CMAESState)


class CMAESParams(NamedTuple):
    """Strategy constants from (dim, popsize), Hansen's defaults: Python
    scalars and a tuple, as the JAX package's."""

    popsize: int
    mu: int
    weights: tuple        # [mu] floats, positive, summing to 1
    mu_eff: float
    c_sigma: float
    d_sigma: float
    c_c: float
    c_1: float
    c_mu: float
    chi_n: float


def default_popsize(dim: int) -> int:
    return 4 + int(3 * math.log(dim))


def cmaes_params(dim: int, popsize: Optional[int] = None) -> CMAESParams:
    lam = default_popsize(dim) if popsize is None else int(popsize)
    if lam < 4:
        raise ValueError("CMA-ES needs popsize >= 4")
    mu = lam // 2
    w = math.log(mu + 0.5) - torch.log(
        torch.arange(1, mu + 1, dtype=torch.float32))
    w = w / w.sum()
    mu_eff = float(1.0 / (w * w).sum())

    c_sigma = (mu_eff + 2.0) / (dim + mu_eff + 5.0)
    d_sigma = (
        1.0
        + 2.0 * max(0.0, math.sqrt((mu_eff - 1.0) / (dim + 1.0)) - 1.0)
        + c_sigma
    )
    c_c = (4.0 + mu_eff / dim) / (dim + 4.0 + 2.0 * mu_eff / dim)
    c_1 = 2.0 / ((dim + 1.3) ** 2 + mu_eff)
    c_mu = min(
        1.0 - c_1,
        2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((dim + 2.0) ** 2 + mu_eff),
    )
    chi_n = math.sqrt(dim) * (
        1.0 - 1.0 / (4.0 * dim) + 1.0 / (21.0 * dim * dim)
    )
    return CMAESParams(
        popsize=lam, mu=mu, weights=tuple(float(v) for v in w),
        mu_eff=mu_eff, c_sigma=c_sigma, d_sigma=d_sigma, c_c=c_c, c_1=c_1,
        c_mu=c_mu, chi_n=chi_n,
    )


def cmaes_init(
    dim: int,
    sigma: float = 0.3,
    mean: Optional[torch.Tensor] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> CMAESState:
    dev = resolve_device(device)
    m = (torch.zeros(dim, dtype=torch.float32, device=dev) if mean is None
         else torch.as_tensor(mean, dtype=torch.float32, device=dev))
    if tuple(m.shape) != (dim,):
        raise ValueError(f"mean must have shape ({dim},), got "
                         f"{tuple(m.shape)}")
    zeros = torch.zeros(dim, dtype=torch.float32, device=dev)
    return CMAESState(
        mean=m, sigma=torch.tensor(sigma, dtype=torch.float32, device=dev),
        cov=torch.eye(dim, dtype=torch.float32, device=dev),
        p_sigma=zeros, p_c=zeros.clone(), best_pos=m,
        best_fit=torch.tensor(float("inf"), dtype=torch.float32,
                              device=dev),
        gen=_generator(dev, seed),
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _sqrt32(x: float) -> float:
    """``jnp.sqrt`` of a Python float: f32 of x, its f32 square root."""
    return float(np.sqrt(np.float32(x)))


def _weights(params: CMAESParams, device: torch.device) -> torch.Tensor:
    """The recombination weights on ``device``: on a card, copied from
    pinned memory without a wait (a pageable copy would wait for it)."""
    w = torch.tensor(params.weights, dtype=torch.float32)
    if device.type != "cuda":
        return w
    return w.pin_memory().to(device, non_blocking=True)


def stall_gate(p_sigma: torch.Tensor, iteration: torch.Tensor,
               params: CMAESParams):
    """(h_sigma, |p_sigma|): the Heaviside gate that stops the rank-one
    path while sigma still grows, 1.0 or 0.0, for the generation after
    ``iteration``."""
    p = params
    dim = p_sigma.shape[0]
    t = (iteration + 1).to(torch.float32)
    ps_norm = sqrt_rn((p_sigma * p_sigma).sum())
    decay = (1.0 - p.c_sigma) ** (2.0 * t)
    ratio = recip_mul(ps_norm / sqrt_rn(1.0 - decay), p.chi_n)
    return (ratio < 1.4 + 2.0 / (dim + 1.0)).to(torch.float32), ps_norm


def cmaes_step(
    state: CMAESState,
    objective: Callable,
    params: CMAESParams,
    half_width: Optional[float] = None,
    eig: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    z: Optional[torch.Tensor] = None,
) -> CMAESState:
    """One generation.  ``half_width`` projects samples into the box
    ``[-half_width, half_width]^D`` before evaluation (the strategy's state
    stays unconstrained).  ``eig = (eigenvalues [D], B [D, D])`` replaces
    ``eigh(cov)``; ``z`` [lambda, D] the normal draw from ``state.gen``."""
    dim = state.mean.shape[0]
    p = params
    eigvals, b_mat = torch.linalg.eigh(state.cov) if eig is None else eig
    d_sqrt = torch.sqrt(torch.clamp(eigvals, min=1e-20))
    inv_sqrt_c = matmul(b_mat / d_sqrt[None, :], b_mat.T)
    if z is None:
        z = torch.randn((p.popsize, dim), generator=state.gen,
                        dtype=torch.float32, device=state.device)
    y = matmul(z, (b_mat * d_sqrt[None, :]).T)
    x = state.mean[None, :] + state.sigma * y
    x_eval = x if half_width is None else torch.clamp(x, -half_width,
                                                       half_width)
    fit = objective(x_eval)

    order = torch.sort(fit, stable=True).indices
    w = _weights(p, state.device)
    y_mu = y.index_select(0, order[: p.mu])
    y_w = matmul(w, y_mu)
    mean = state.mean + state.sigma * y_w

    # The step-size path, whitened: N(0, I) under neutral selection.
    p_sigma = ((1.0 - p.c_sigma) * state.p_sigma
               + _sqrt32(p.c_sigma * (2.0 - p.c_sigma) * p.mu_eff)
               * matmul(inv_sqrt_c, y_w))
    h_sigma, ps_norm = stall_gate(p_sigma, state.iteration, p)

    p_c = ((1.0 - p.c_c) * state.p_c
           + h_sigma * _sqrt32(p.c_c * (2.0 - p.c_c) * p.mu_eff) * y_w)

    # Covariance: rank one (the p_c outer product) and rank mu.
    rank_one = torch.outer(p_c, p_c)
    rank_mu = matmul((y_mu * w[:, None]).T, y_mu)
    delta_h = (1.0 - h_sigma) * p.c_c * (2.0 - p.c_c)
    cov = ((1.0 - p.c_1 - p.c_mu + p.c_1 * delta_h) * state.cov
           + p.c_1 * rank_one + p.c_mu * rank_mu)
    cov = 0.5 * (cov + cov.T)

    sigma = state.sigma * torch.exp(
        (p.c_sigma / p.d_sigma) * (recip_mul(ps_norm, p.chi_n) - 1.0))

    first = order[:1]
    cand_fit = fit.index_select(0, first)[0]
    improved = cand_fit < state.best_fit
    return CMAESState(
        mean=mean, sigma=sigma, cov=cov, p_sigma=p_sigma, p_c=p_c,
        best_pos=torch.where(improved, x_eval.index_select(0, first)[0],
                             state.best_pos),
        best_fit=torch.where(improved, cand_fit, state.best_fit),
        gen=state.gen, iteration=state.iteration + 1,
    )


def cmaes_run(
    state: CMAESState,
    objective: Callable,
    params: CMAESParams,
    n_steps: int,
    half_width: Optional[float] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> CMAESState:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's
    normals."""
    for i in range(n_steps):
        state = cmaes_step(state, objective, params, half_width,
                           z=None if draws is None else draws[i])
    return state


def cmaes_state_from_numpy(arrays, device: DeviceLike = None,
                           seed: int = 0) -> CMAESState:
    """A CMAESState from numpy arrays named like its fields."""
    return _family.state_from_numpy(CMAESState, arrays, device, seed)


def cmaes_state_to_numpy(state: CMAESState) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)
