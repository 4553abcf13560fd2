"""Memetic (gradient-hybrid) refinement for population optimizers.

Counterpart of ``ops/memetic.py`` of the JAX package.  The objective is a
PyTorch function, so autograd differentiates the same batched objective the
swarm already evaluates, and a handful of vectorized gradient-descent steps
sharpen every particle's personal best at once: global stochastic search
plus local refinement.

Improvements are accepted greedily: refined points replace ``pbest`` only
where strictly better, so the swarm's bests stay monotone.
"""

from __future__ import annotations

from typing import Callable

import torch

from .pso import C1, C2, PSOState, W, pso_step


def gd_refine(
    pos: torch.Tensor,
    objective: Callable,
    n_steps: int,
    lr: float,
    half_width: float,
) -> torch.Tensor:
    """``n_steps`` of plain gradient descent on every point of ``pos``.

    The objective is batched with independent points (``[N, D] -> [N]``, or
    the transposed ``[D, N] -> [1, N]``), so the gradient of ``sum(f)`` is
    every point's own gradient in one backward pass.  Positions stay clipped
    to the search domain.
    """
    pos = pos.detach()
    for _ in range(n_steps):
        with torch.enable_grad():
            p = pos.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(p).sum(), p)
        # Guard against non-finite gradients at domain edges.
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        pos = torch.clamp(pos - lr * g, -half_width, half_width)
    return pos


def refine_pbest(
    state: PSOState,
    objective: Callable,
    n_steps: int = 5,
    lr: float = 0.01,
    half_width: float = 5.12,
) -> PSOState:
    """Refine every particle's personal best with GD; accept improvements.

    Monotone: ``pbest_fit``/``gbest_fit`` never worsen.
    """
    cand = gd_refine(state.pbest_pos, objective, n_steps, lr, half_width)
    cand_fit = objective(cand)
    better = cand_fit < state.pbest_fit
    pbest_fit = torch.where(better, cand_fit, state.pbest_fit)
    pbest_pos = torch.where(better[:, None], cand, state.pbest_pos)

    best = torch.argmin(pbest_fit)
    improved = pbest_fit[best] < state.gbest_fit
    return state.replace(
        pbest_pos=pbest_pos,
        pbest_fit=pbest_fit,
        gbest_pos=torch.where(improved, pbest_pos[best], state.gbest_pos),
        gbest_fit=torch.where(improved, pbest_fit[best], state.gbest_fit),
    )


def fused_memetic_run(
    state: PSOState,
    objective_name: str,
    objective: Callable,
    n_steps: int,
    refine_every: int = 10,
    refine_steps: int = 5,
    lr: float = 0.01,
    w: float = W,
    c1: float = C1,
    c2: float = C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    steps_per_kernel: int = 8,
) -> PSOState:
    """Memetic fast path: fused PSO blocks plus the gradient refinement,
    composed entirely in the kernel's transposed layout, with no read from
    the device.

    No new kernel: the global phase runs ``refine_every`` iterations
    through the fused PSO kernel (ops/cuda/pso_fused.py, gbest topology
    only), then the autograd refinement sharpens every pbest in the same
    ``[D, N]`` layout (through the transposed objective registry), so
    pos/vel/pbest transpose exactly once per run.  ``objective`` (the
    [N, D] callable) is unused on this path but kept in the signature so
    callers can pass both interchangeably.

    Refinement cadence matches the portable path: one pass per completed
    ``refine_every`` iterations, counted from the start of the run (a
    trailing remainder runs PSO blocks only).  The refinement's acceptance
    stays greedy, so the composition inherits the portable path's
    pbest/gbest invariants.
    """
    from .cuda import pso_fused as _pf

    if refine_every < 1:
        raise ValueError(
            f"refine_every must be >= 1, got {refine_every} "
            "(use fused_pso_run for no refinement)"
        )
    del objective  # the transposed registry drives both phases

    n, d = state.pos.shape
    _pf.require_supported(objective_name, state.pos.dtype, d)
    objective_t = _pf.OBJECTIVES_T[objective_name]
    pos_t, vel_t, bpos_t, bfit_t = _pf.prep_padded_t(state, n)
    seed = _pf.seed_base(state.gen, state.device)

    def pso_steps(carry, done, k):
        """k PSO iterations in fused blocks after ``done`` steps of the
        run (the generator's step counter)."""
        spk = min(steps_per_kernel, k)

        def block(carry, call_i, kk):
            pos_t, vel_t, bpos_t, bfit_t, gpos, gfit = carry
            pos_t, vel_t, bpos_t, bfit_t = _pf.fused_pso_step_t(
                seed, gpos[:, None], pos_t, vel_t, bpos_t, bfit_t,
                objective_name=objective_name, w=w, c1=c1, c2=c2,
                half_width=half_width, vmax_frac=vmax_frac, k_steps=kk,
                track_best=False, step0=done + call_i * spk,
            )
            gfit, gpos = _pf.merge_best(
                *_pf.best_of_block(bfit_t, bpos_t), gfit, gpos)
            return (pos_t, vel_t, bpos_t, bfit_t, gpos, gfit)

        return _pf.run_blocks(block, carry, k, spk)

    carry = (
        pos_t, vel_t, bpos_t, bfit_t,
        state.gbest_pos.to(torch.float32), state.gbest_fit.to(torch.float32),
    )
    n_chunks, rem = divmod(n_steps, refine_every)
    for chunk in range(n_chunks):
        carry = pso_steps(carry, chunk * refine_every, refine_every)
        pos_t, vel_t, bpos_t, bfit_t, gpos, gfit = carry
        # gd_refine is layout-agnostic (grad-of-sum and clip are
        # shape-blind), so it runs on the transposed objective as it is.
        cand = gd_refine(bpos_t, objective_t, refine_steps, lr, half_width)
        cand_fit = objective_t(cand)               # [1, N]
        better = cand_fit < bfit_t
        bpos_t = torch.where(better, cand, bpos_t)
        bfit_t = torch.where(better, cand_fit, bfit_t)
        gfit, gpos = _pf.merge_best(
            *_pf.best_of_block(bfit_t, bpos_t), gfit, gpos)
        carry = (pos_t, vel_t, bpos_t, bfit_t, gpos, gfit)
    if rem:
        # Trailing partial chunk: PSO only; the portable schedule refines
        # on refine_every multiples, never after a remainder.
        carry = pso_steps(carry, n_chunks * refine_every, rem)
    return _pf.rebuild_state(state, *carry, n_steps)


def memetic_run(
    state: PSOState,
    objective: Callable,
    n_steps: int,
    refine_every: int = 10,
    refine_steps: int = 5,
    lr: float = 0.01,
    w: float = W,
    c1: float = C1,
    c2: float = C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    topology: str = "gbest",
    ring_radius: int = 1,
    grid_cols: int = 0,
    uniforms=None,
) -> PSOState:
    """PSO with a GD refinement pass whenever the iteration counter reaches
    a multiple of ``refine_every``.  The counter is read from the device
    once, at the start.  ``uniforms = (r1, r2)``, each [n_steps, N, D],
    replaces the draws from ``state.gen``."""
    if refine_every < 1:
        raise ValueError(
            f"refine_every must be >= 1, got {refine_every} "
            "(use plain pso_run for no refinement)"
        )
    iteration = int(state.iteration)
    for i in range(n_steps):
        r1, r2 = (None, None) if uniforms is None else (
            uniforms[0][i], uniforms[1][i])
        state = pso_step(state, objective, w, c1, c2, half_width, vmax_frac,
                         topology, ring_radius, grid_cols, r1=r1, r2=r2)
        iteration += 1
        if iteration % refine_every == 0:
            state = refine_pbest(state, objective, refine_steps, lr,
                                 half_width)
    return state
