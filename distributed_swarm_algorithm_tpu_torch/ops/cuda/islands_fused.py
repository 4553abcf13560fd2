"""Island-model PSO on the fused kernel.

Replaces the TPU kernel ``ops/pallas/islands_fused.py:_islands_step_t`` of
the JAX package and carries its run function.  All islands share one launch:
particles flatten onto the lane axis ``[D, I * n_l]`` and the only
island-aware piece is the gbest operand, a ``[D, I]`` matrix of which lane
``l`` reads column ``l // n_l``.  The body is the single-swarm one
(``csrc/pso_fused.cu``, the second C entry); per-island bests and ring
migration run between k-step blocks as PyTorch reductions over the
``[I, n_l]`` fitness view.

- :func:`islands_step_cuda` launches the kernel on CUDA tensors and raises
  on anything else;
- :func:`islands_step_plain` is the plain PyTorch version (the shared body
  of ``pso_fused.pso_steps_plain`` with each lane's own gbest column);
- :func:`_islands_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  Nothing falls back.

Migration semantics mirror ``parallel/islands.py:migrate`` exactly (k best
pbest particles replace the next island's k worst, ring order, velocities
zeroed, island gbests refreshed), in the transposed layout, so the particle
arrays never leave ``[D, I * n_l]`` form between blocks.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...parallel.islands import IslandPSOState, largest_k, smallest_k
from ..pso import C1, C2, W
from . import _build, pso_fused as _pf

# Launches of the CUDA kernel through islands_step_cuda since the count was
# last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# The island kernel's body is the single-swarm PSO kernel's, so the
# envelope is exactly PSO's: objective coverage, f32, the michalewicz
# bound and the shared-memory tile.
islands_pallas_supported = _pf.pallas_supported


def islands_step_plain(
    seed, gbest_ti, pos_t, vel_t, bpos_t, bfit_t, r1=None, r2=None, *,
    objective_name: str, w: float = W, c1: float = C1, c2: float = C2,
    half_width: float = 5.12, vmax_frac: float = 0.5,
    lanes_per_island: int, rng: str = "device", k_steps: int = 1,
    step0: int = 0,
):
    """The plain PyTorch version of :func:`islands_step_cuda`, on any
    device; same arguments and results."""
    _pf.check_rng(rng, r1, r2, k_steps)
    if rng == "device":
        r1 = r2 = None
    island = torch.arange(pos_t.shape[1],
                          device=pos_t.device) // lanes_per_island
    return _pf.pso_steps_plain(
        seed, gbest_ti[:, island], pos_t, vel_t, bpos_t, bfit_t, r1, r2,
        objective_name, w, c1, c2, half_width, vmax_frac, k_steps, step0)


def _kernel():
    global _fn
    if _fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = _build.load("pso_fused").dsa_islands_fused_f32
        fn.argtypes = [p] * 12 + [i, i, i, i, i, ctypes.c_uint, i,
                                  f, f, f, f, f, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def islands_step_cuda(
    seed, gbest_ti, pos_t, vel_t, bpos_t, bfit_t, r1=None, r2=None, *,
    objective_name: str, w: float = W, c1: float = C1, c2: float = C2,
    half_width: float = 5.12, vmax_frac: float = 0.5,
    lanes_per_island: int, rng: str = "device", k_steps: int = 1,
    step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused PSO iterations of every
    island at once.  ``pos_t``/``vel_t``/``bpos_t`` are [D, I * n_l] and
    ``bfit_t`` [1, I * n_l] (f32, contiguous, one CUDA device), island
    ``i`` owning lanes ``i * n_l .. (i + 1) * n_l - 1`` with
    ``n_l = lanes_per_island``; ``gbest_ti`` is [D, I], held fixed over
    the launch.  ``seed`` and ``step0`` as for the single-swarm kernel.
    Returns new ``(pos, vel, bpos, bfit)`` without waiting."""
    global LAUNCHES
    _pf.check_rng(rng, r1, r2, k_steps)
    if rng == "device":
        r1 = r2 = None
    d, n = pos_t.shape if pos_t.ndim == 2 else (0, 0)
    if lanes_per_island < 1 or n % lanes_per_island:
        raise ValueError(
            f"islands_step_cuda: {n} lanes do not divide into islands of "
            f"{lanes_per_island}"
        )
    n_i = n // lanes_per_island
    _pf.check_step_operands("islands_step_cuda", seed, (d, n_i), gbest_ti,
                            pos_t, vel_t, bpos_t, bfit_t, r1, r2)
    outs = [torch.empty_like(t) for t in (pos_t, vel_t, bpos_t, bfit_t)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _kernel()(
        seed.data_ptr(), gbest_ti.data_ptr(), pos_t.data_ptr(),
        vel_t.data_ptr(), bpos_t.data_ptr(), bfit_t.data_ptr(), ptr(r1),
        ptr(r2), *(t.data_ptr() for t in outs),
        n, d, n_i, int(lanes_per_island), int(k_steps),
        int(step0) & 0xFFFFFFFF, _pf.OBJECTIVE_IDS[objective_name],
        float(w), float(c1), float(c2), float(half_width * vmax_frac),
        float(half_width), pos_t.device.index,
        torch.cuda.current_stream(pos_t.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused island kernel launch failed: CUDA error {err}"
        )
    LAUNCHES += 1
    return tuple(outs)


def _islands_step_t(seed, gbest_ti, pos_t, vel_t, bpos_t, bfit_t, r1=None,
                    r2=None, **kw) -> Tuple[torch.Tensor, ...]:
    """One fused k-step block over all islands: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors."""
    step = (islands_step_plain if pos_t.device.type == "cpu"
            else islands_step_cuda)
    return step(seed, gbest_ti, pos_t, vel_t, bpos_t, bfit_t, r1, r2, **kw)


def _island_gbest_update(bfit_t, bpos_t, gpos_ti, gfit_i, n_i, n_l):
    """Refresh per-island gbests from the flat pbest arrays."""
    bfit_r = bfit_t.reshape(n_i, n_l)                      # [I, n]
    best = torch.argmin(bfit_r, dim=1)                     # [I]
    cand_fit = torch.gather(bfit_r, 1, best[:, None])[:, 0]
    flat = torch.arange(n_i, device=best.device) * n_l + best
    cand_pos = bpos_t.index_select(1, flat)                # [D, I]
    better = cand_fit < gfit_i
    gfit_i = torch.where(better, cand_fit, gfit_i)
    gpos_ti = torch.where(better[None, :], cand_pos, gpos_ti)
    return gpos_ti, gfit_i


def _migrate_t(pos_t, vel_t, bpos_t, bfit_t, k, n_i, n_l, n_real=None,
               shift_fn=None):
    """Ring migration in transposed layout (parallel/islands.py:migrate).

    Padded lanes (index >= ``n_real`` within an island) are excluded from
    both emigrant and replacement selection, so migration touches exactly
    the particles the portable path would: immigrants are never written
    into lanes the final unpad slice discards.  The inputs are not
    modified.

    ``shift_fn`` is the sharded run's hook for a ring shift across
    devices; it is not ported yet.
    """
    if shift_fn is not None:
        raise NotImplementedError(
            "_migrate_t(shift_fn=...) is not ported yet (ROADMAP Queue A "
            "item 17: parallel/sharding.py, fused_island_run_shmap)"
        )
    n_real = n_l if n_real is None else n_real
    bfit_r = bfit_t.reshape(n_i, n_l)
    dev = bfit_t.device
    offs = (torch.arange(n_i, device=dev) * n_l)[:, None]      # [I, 1]
    valid = (torch.arange(n_l, device=dev) < n_real)[None, :]  # [1, n_l]

    # Padded lanes sort last in both selections (+inf among the smallest,
    # -inf among the largest), so the first k of each are real lanes.
    inf = torch.full((), float("inf"), dtype=bfit_r.dtype, device=dev)
    best_idx = smallest_k(torch.where(valid, bfit_r, inf), k)
    worst_idx = largest_k(torch.where(valid, bfit_r, -inf), k)
    flat_b = (offs + best_idx).reshape(-1)                 # [I*k]
    em_pos = bpos_t.index_select(1, flat_b).reshape(-1, n_i, k)  # [D, I, k]
    em_fit = torch.gather(bfit_r, 1, best_idx)             # [I, k]

    in_pos = torch.roll(em_pos, 1, 1).reshape(-1, n_i * k)
    in_fit = torch.roll(em_fit, 1, 0).reshape(-1)
    flat_w = (offs + worst_idx).reshape(-1)

    pos_t = pos_t.index_copy(1, flat_w, in_pos)
    bpos_t = bpos_t.index_copy(1, flat_w, in_pos)
    vel_t = vel_t.index_fill(1, flat_w, 0.0)
    bfit_t = bfit_t.index_copy(1, flat_w, in_fit[None, :])
    return pos_t, vel_t, bpos_t, bfit_t


def fused_island_run(
    state: IslandPSOState,
    objective_name: str,
    n_steps: int,
    migrate_every: int = 25,
    migrate_k: int = 4,
    w: float = W,
    c1: float = C1,
    c2: float = C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> IslandPSOState:
    """All islands, one fused launch per k-step block, on one device, with
    no read from the device.

    Migration fires between blocks on the first block boundary at or past
    each ``migrate_every`` multiple (exact when ``steps_per_kernel``
    divides ``migrate_every``; the portable path migrates mid-cadence
    otherwise).

    ``tile_n=None`` runs each island at its own width.  An explicit
    ``tile_n`` pads every island to a multiple of it with that island's
    own leading particles, as the JAX package does for its lane tile (a
    test that compares with the JAX package's run passes the same ``tile_n``).

    ``rng="host"`` runs one step per launch with ``uniforms = (r1, r2)``,
    each ``[n_steps, D, I * n_l]``, or with draws from the state's
    generator.
    """
    pso = state.pso
    n_i, n, d = pso.pos.shape
    _pf.require_supported(objective_name, pso.pos.dtype, d)
    if rng == "host":
        steps_per_kernel = 1
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    n_l = _pf.padded_width(n, tile_n)          # per-island padded width
    reps = -(-n_l // n)
    dev = pso.pos.device

    def prep(x_ind):                          # [I, n, D] -> [D, I*n_l]
        x = x_ind.to(torch.float32)
        if n_l != n:
            x = x.repeat(1, reps, 1)[:, :n_l]
        return x.reshape(n_i * n_l, d).T.contiguous()

    pos_t = prep(pso.pos)
    vel_t = prep(pso.vel)
    bpos_t = prep(pso.pbest_pos)
    bfit = pso.pbest_fit.to(torch.float32)
    if n_l != n:
        bfit = bfit.repeat(1, reps)[:, :n_l]
    bfit_t = bfit.reshape(1, n_i * n_l).contiguous()

    gpos_ti = pso.gbest_pos.to(torch.float32).T.contiguous()   # [D, I]
    gfit_i = pso.gbest_fit.to(torch.float32)                   # [I]
    seed = _pf.seed_base(pso.gen, dev)
    blocks_per_migration = max(1, migrate_every // steps_per_kernel)

    def block(carry, call_i, k):
        pos_t, vel_t, bpos_t, bfit_t, gpos_ti, gfit_i = carry
        r1 = r2 = None
        if rng == "host":
            r1, r2 = ((uniforms[0][call_i], uniforms[1][call_i])
                      if uniforms is not None
                      else _pf.host_uniforms(pso.gen, pos_t.shape, dev))
        pos_t, vel_t, bpos_t, bfit_t = _islands_step_t(
            seed, gpos_ti, pos_t, vel_t, bpos_t, bfit_t, r1, r2,
            objective_name=objective_name, w=w, c1=c1, c2=c2,
            half_width=half_width, vmax_frac=vmax_frac,
            lanes_per_island=n_l, rng=rng, k_steps=k,
            step0=call_i * steps_per_kernel,
        )
        if (call_i + 1) % blocks_per_migration == 0:
            pos_t, vel_t, bpos_t, bfit_t = _migrate_t(
                pos_t, vel_t, bpos_t, bfit_t, migrate_k, n_i, n_l, n_real=n)
        gpos_ti, gfit_i = _island_gbest_update(
            bfit_t, bpos_t, gpos_ti, gfit_i, n_i, n_l
        )
        return (pos_t, vel_t, bpos_t, bfit_t, gpos_ti.contiguous(), gfit_i)

    carry = _pf.run_blocks(
        block,
        (pos_t, vel_t, bpos_t, bfit_t, gpos_ti, gfit_i),
        n_steps, steps_per_kernel,
    )
    pos_t, vel_t, bpos_t, bfit_t, gpos_ti, gfit_i = carry

    dt = pso.pos.dtype

    def back(x_t):                            # [D, I*n_l] -> [I, n, D]
        return x_t.T.reshape(n_i, n_l, d)[:, :n].to(dt).contiguous()

    return state.replace(
        pso=pso.replace(
            pos=back(pos_t),
            vel=back(vel_t),
            pbest_pos=back(bpos_t),
            pbest_fit=bfit_t.reshape(n_i, n_l)[:, :n].to(
                pso.pbest_fit.dtype).contiguous(),
            gbest_pos=gpos_ti.T.to(pso.gbest_pos.dtype).contiguous(),
            gbest_fit=gfit_i.to(pso.gbest_fit.dtype),
            iteration=pso.iteration + n_steps,
        ),
        iteration=state.iteration + n_steps,
    )
