"""Fused SHADE generations ("SHADE-R"): one current-to-pbest/1 generation
per launch with rotational donors, and the success-history adaptation
between launches, exact at every generation.

Replaces the TPU kernel ``ops/pallas/shade_fused.py:fused_shade_step_t``
of the JAX package.

- :func:`fused_shade_step_cuda` launches the hand-written CUDA kernel
  ``csrc/shade_fused.cu`` on CUDA tensors and raises on anything else;
- :func:`fused_shade_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order and the same Philox draws;
- :func:`fused_shade_step_t` is the entry: the plain version for CPU
  tensors, the kernel for CUDA tensors.  Nothing falls back.

The JAX package's deltas from ``ops/shade.py`` hold here too: r1 is a
rotational donor (a tile shift and a lane roll of the population), r2 per
lane either a rotated population view or a rotated archive view (a uniform
against ``frac / 65536``), the pbest column ``(j - le) mod 128`` of an elite
pool of the 128 best per-tile champions, a pre-filled archive replaced by
windows, and no ``j_rand``.  The driver's per-generation work (the F and CR
draws, the elite pool, the memory update, the archive window, the best)
runs as PyTorch operations on the device, as the JAX package runs it
outside its kernel.

Random numbers (``rng="device"``): Philox4x32-10 keyed by the seed, the
crossover uniforms on stream 0 over the dimensions, counter (lane, block of
four dimensions, generation, 0); the source uniform is word 0 of the call
(lane, 0, generation, 1).  ``rng="host"`` takes them as the operands
``r_cross`` [D, N] and ``r_src`` [1, N].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .._numerics import top_k
from ..shade import CR_SCALE, F_SCALE, H, SHADEState, memory_update
from . import family
from .common import ceil_to, cyclic_pad_rows
from .family import donor_tiles, roll_lanes
from .pso_fused import (
    OBJECTIVE_IDS,
    OBJECTIVES_T,
    _MASK32,
    best_of_block,
    merge_best,
    philox_uniforms,
    seed_base,
)

# Launches of the CUDA kernel through fused_shade_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

ELITE = 128          # pbest pool width (the JAX package's _ELITE)
FRAC_FX = 1 << 16    # fixed-point denominator of the archive fraction


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel: the largest of 128, 64 and 32 whose
    ``[D][block]`` trial tile and ``[D][128]`` elite pool (f32) fit a
    block's shared memory, or 0 (D > 363)."""
    return family.pick_block(lambda block: dim * (block + ELITE) * 4)


def shade_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 363.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def shade_step_plain(scalars, pos, fit, f_row, cr_row, archive, elite,
                     r_cross, r_src, objective_name, half_width, tile_n,
                     step):
    """One generation on ``[D, N]``; ``r_cross is None`` draws from
    Philox."""
    d, n = pos.shape
    seed = scalars[0:1]
    x_r1 = roll_lanes(donor_tiles(pos, tile_n, scalars[1]), scalars[4])
    x_r2p = roll_lanes(donor_tiles(pos, tile_n, scalars[2]), scalars[5])
    x_r2a = roll_lanes(donor_tiles(archive, tile_n, scalars[3]), scalars[6])
    arch_frac = scalars[8].to(torch.float32) / FRAC_FX
    if r_cross is None:
        u_cross = philox_uniforms(seed, n, d, step, 0)
        u_src = philox_uniforms(seed, n, 1, step, 1)
    else:
        u_cross, u_src = r_cross, r_src
    x_r2 = torch.where(u_src < arch_frac, x_r2a, x_r2p)
    jl = torch.arange(n, device=pos.device) % tile_n
    x_pb = elite.index_select(1, (jl - scalars[7].long()) % ELITE)
    mutant = pos + f_row * (x_pb - pos) + f_row * (x_r1 - x_r2)
    mutant = torch.clamp(mutant, -half_width, half_width)
    trial = torch.where(u_cross < cr_row, mutant, pos)
    tfit = OBJECTIVES_T[objective_name](trial)
    accept = tfit <= fit
    return torch.where(accept, trial, pos), torch.where(accept, tfit, fit)


def _check(rng, r_cross, r_src, tile_n, n):
    family.check_rng(rng, (r_cross, r_src), 1)
    if n % tile_n or tile_n % ELITE:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n}), "
                         f"and tile_n of {ELITE}")


def fused_shade_step_plain(
    scalars, pos, fit, f_row, cr_row, archive, elite, r_cross=None,
    r_src=None, *, objective_name: str, half_width: float = 5.12,
    tile_n: int = 4096, rng: str = "device", step: int = 0,
):
    """The plain PyTorch version of :func:`fused_shade_step_cuda`, on any
    device; same arguments and results."""
    _check(rng, r_cross, r_src, tile_n, pos.shape[1])
    if rng == "device":
        r_cross = r_src = None
    return shade_step_plain(scalars, pos, fit, f_row, cr_row, archive, elite,
                            r_cross, r_src, objective_name, half_width,
                            tile_n, step)


def _kernel():
    global _fn
    if _fn is None:
        i = ctypes.c_int
        _fn = family.bind("shade_fused", "dsa_shade_fused_f32", 11,
                          [i, i, i, ctypes.c_uint, i, ctypes.c_float])
    return _fn


def fused_shade_step_cuda(
    scalars, pos, fit, f_row, cr_row, archive, elite, r_cross=None,
    r_src=None, *, objective_name: str, half_width: float = 5.12,
    tile_n: int = 4096, rng: str = "device", step: int = 0,
):
    """Launch the CUDA kernel: one fused SHADE-R generation on ``pos`` [D,
    N] and ``fit`` [1, N] with the per-individual ``f_row`` and ``cr_row``
    [1, N], the archive [D, N] and the elite pool [D, 128] (f32,
    contiguous, one CUDA device; N a multiple of ``tile_n``, ``tile_n`` of
    128).  ``scalars`` is [9] int32 on the device: the seed, the tile
    shifts of r1, r2 and the archive, their lane shifts, the elite pool's
    shift and the archive fraction in 16.16 fixed point; ``step`` is the
    generation (the Philox counter).  Returns new tensors ``(pos, fit)``
    without waiting for the kernel."""
    global LAUNCHES
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, r_cross, r_src, tile_n, n)
    if rng == "device":
        r_cross = r_src = None
    row = (1, n)
    family.check_operands(
        "fused_shade_step_cuda", scalars, 9, pos,
        dict(fit=(fit, row), f_row=(f_row, row), cr_row=(cr_row, row),
             archive=(archive, (d, n)), elite=(elite, (d, ELITE)),
             r_cross=(r_cross, (d, n)), r_src=(r_src, row)))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_shade_step_cuda: D = {d} is outside the kernel's "
            f"envelope ([D][32 + 128] f32 must fit "
            f"{family.MAX_SHARED_BYTES} bytes of shared memory)")
    pos_out = torch.empty_like(pos)
    fit_out = torch.empty_like(fit)
    err = _kernel()(
        scalars.data_ptr(),
        *(t.data_ptr() for t in (pos, fit, f_row, cr_row, archive, elite)),
        family.ptr(r_cross), family.ptr(r_src), pos_out.data_ptr(),
        fit_out.data_ptr(), n, d, int(tile_n), int(step) & _MASK32,
        OBJECTIVE_IDS[objective_name], float(half_width),
        *family.stream_args(pos),
    )
    family.check_launch(err, "shade")
    LAUNCHES += 1
    return pos_out, fit_out


def fused_shade_step_t(scalars, pos, fit, f_row, cr_row, archive, elite,
                       r_cross=None, r_src=None,
                       **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused SHADE-R generation: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors (see :func:`fused_shade_step_cuda`)."""
    step = (fused_shade_step_plain if pos.device.type == "cpu"
            else fused_shade_step_cuda)
    return step(scalars, pos, fit, f_row, cr_row, archive, elite, r_cross,
                r_src, **kw)


def tile_champion_elite(pos_t: torch.Tensor, fit_row: torch.Tensor,
                        n_tiles: int, tile_n: int) -> torch.Tensor:
    """[D, 128] pbest pool: the best individual of each lane tile (the
    first least fitness, as ``jnp.argmin``), then the best 128 champions in
    ``lax.top_k(-champ_fit)``'s order, repeated cyclically when there are
    fewer tiles.  On the device, a gather of 128 columns."""
    per_tile = fit_row.reshape(n_tiles, tile_n)
    champ_lane = torch.argmin(per_tile, dim=1)
    champ_col = champ_lane + torch.arange(n_tiles, device=pos_t.device) \
        * tile_n
    champ_fit = per_tile.gather(1, champ_lane[:, None])[:, 0]
    k = min(ELITE, n_tiles)
    cols = champ_col[top_k(-champ_fit, k)]
    cols = cols.repeat(-(-ELITE // k))[:ELITE]
    return pos_t.index_select(1, cols).contiguous()


# One generation's draws, in the JAX package's order: slot [n_pad] in
# [0, H), cauchy [n_pad], normal [n_pad], the three tile shifts [3] in
# [1, max(n_tiles, 2)), the four lane shifts [4] (r1, r2, archive in
# [0, tile_n); the elite pool's in [0, 128)), the archive window's index
# [] in [0, n_pad / 128), and with rng="host" r_cross [D, n_pad] and
# r_src [1, n_pad] (else None).
SHADEGenDraws = Tuple[Optional[torch.Tensor], ...]


def generation_draws(gen, n_pad, d, n_tiles, tile_n, host, device
                     ) -> SHADEGenDraws:
    """One generation's draws from ``gen``, on ``device``."""
    ints = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=device)
    slot = ints(0, H, (n_pad,))
    cauchy = torch.empty(n_pad, device=device).cauchy_(generator=gen)
    normal = torch.randn(n_pad, generator=gen, device=device)
    tshift = ints(1, max(n_tiles, 2), (3,))
    lshift = torch.cat([ints(0, tile_n, (3,)), ints(0, ELITE, (1,))])
    win = ints(0, n_pad // 128, ())
    r_cross = r_src = None
    if host:
        r_cross = torch.rand((d, n_pad), generator=gen, device=device)
        r_src = torch.rand((1, n_pad), generator=gen, device=device)
    return slot, cauchy, normal, tshift, lshift, win, r_cross, r_src


def fused_shade_run(
    state: SHADEState,
    objective_name: str,
    n_steps: int,
    half_width: float = 5.12,
    tile_n: Optional[int] = None,
    rng: str = "device",
    archive_window_frac: int = 8,
    draws: Optional[Sequence[SHADEGenDraws]] = None,
) -> SHADEState:
    """``n_steps`` SHADE-R generations with no read from the device:
    SHADEState in, SHADEState out, the fast path beside
    ``ops.shade.shade_run``.  The memory adaptation, the archive window and
    the best tracking run every generation, as PyTorch operations on the
    device.  ``draws[g]`` replaces generation g's draws (see
    ``SHADEGenDraws``); by default they come from ``state.gen``."""
    n, d = state.pos.shape
    family.require_family_supported("shade", objective_name,
                                    state.pos.dtype, d, kernel_block, 363)
    family.check_rng(rng, (), 1)
    tile_n, _ = family.lane_tiling(n, tile_n, d)
    tile_n, n_pad, n_tiles = family.shrink_tile_for_donors(n, tile_n)
    win = max(tile_n, n_pad // archive_window_frac)
    win = min(ceil_to(win, 128), n_pad)
    dev = state.device

    pos_t = cyclic_pad_rows(state.pos, n_pad).T.contiguous()
    fit_t = cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous()
    # The pre-filled archive: rows not filled yet alias the population.
    row = torch.arange(n, device=dev)[:, None]
    arch_src = torch.where(row < state.archive_n, state.archive, state.pos)
    arch_t = cyclic_pad_rows(arch_src, n_pad).T.contiguous()
    seed = seed_base(state.gen, dev)
    frac = torch.full((1,), FRAC_FX // 2, dtype=torch.int32, device=dev)
    valid = torch.arange(n_pad, device=dev) < n
    win_lanes = torch.arange(win, device=dev)
    m_f, m_cr = state.m_f.to(torch.float32), state.m_cr.to(torch.float32)
    mem_k = state.mem_k
    best_pos = state.best_pos.to(torch.float32)
    best_fit = state.best_fit.to(torch.float32)

    for g in range(n_steps):
        slot, cauchy, normal, tshift, lshift, win_i, r_cross, r_src = (
            draws[g] if draws is not None else generation_draws(
                state.gen, n_pad, d, n_tiles, tile_n, rng == "host", dev))
        slot = slot.long()
        f_i = torch.clamp(m_f[slot] + F_SCALE * cauchy, 0.01, 1.0)
        cr_i = torch.clamp(m_cr[slot] + CR_SCALE * normal, 0.0, 1.0)
        scalars = torch.cat([seed, tshift.to(torch.int32).reshape(3),
                             lshift.to(torch.int32).reshape(4), frac])
        elite = tile_champion_elite(pos_t, fit_t[0], n_tiles, tile_n)
        new_pos_t, new_fit_t = fused_shade_step_t(
            scalars, pos_t, fit_t, f_i[None, :].contiguous(),
            cr_i[None, :].contiguous(), arch_t, elite, r_cross, r_src,
            objective_name=objective_name, half_width=half_width,
            tile_n=tile_n, rng=rng, step=g)

        # Success bookkeeping; the cyclic pad lanes do not count.
        better = (new_fit_t[0] < fit_t[0]) & valid
        w = torch.where(better, fit_t[0] - new_fit_t[0],
                        torch.zeros_like(fit_t[0]))
        m_f, m_cr, mem_k = memory_update(better, w, f_i, cr_i, m_f, m_cr,
                                         mem_k)

        # Defeated parents into the archive, in a window at a random
        # multiple of 128 lanes.
        off = torch.clamp(win_i.long().reshape(()) * 128, max=n_pad - win)
        idx = off + win_lanes
        kept = torch.where(better.index_select(0, idx)[None, :],
                           pos_t.index_select(1, idx),
                           arch_t.index_select(1, idx))
        arch_t = arch_t.index_copy(1, idx, kept)

        best_fit, best_pos = merge_best(*best_of_block(new_fit_t, new_pos_t),
                                        best_fit, best_pos)
        pos_t, fit_t = new_pos_t, new_fit_t

    dt = state.pos.dtype
    return SHADEState(
        pos=pos_t.T[:n].to(dt).contiguous(),
        fit=fit_t[0, :n].to(state.fit.dtype),
        best_pos=best_pos.to(state.best_pos.dtype),
        best_fit=best_fit.to(state.best_fit.dtype),
        m_f=m_f.to(state.m_f.dtype),
        m_cr=m_cr.to(state.m_cr.dtype),
        mem_k=mem_k,
        archive=arch_t.T[:n].to(state.archive.dtype).contiguous(),
        archive_n=torch.full((), n, dtype=torch.int32, device=dev),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
