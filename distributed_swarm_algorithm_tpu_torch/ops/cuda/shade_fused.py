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

On a card with ``rng="device"`` and no ``draws``, :func:`fused_shade_run`
replays its generations two at a time from one captured CUDA graph
(:func:`_graph_run`), as ``fused_aco_run`` replays its iterations; the
generation then reaches the kernel as a counter on the device that the
graph advances.  The results are the eager loop's bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .._numerics import top_k
from ..shade import CR_SCALE, F_SCALE, H, SHADEState, memory_update
from . import family
from .common import (
    capture_graph,
    ceil_to,
    cyclic_pad_rows,
    replays_graphs,
)
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
# was last set to 0, one per launch; a launch while the stream captures a
# CUDA graph adds to _captured instead, and each replay of a captured run
# adds what its capture recorded.
LAUNCHES = 0
_captured = 0

_fn = None   # the C entry, bound at the first launch

ELITE = 128          # pbest pool width (the JAX package's _ELITE)
FRAC_FX = 1 << 16    # fixed-point denominator of the archive fraction
MAX_DIM = 363        # the envelope (the first version's widest D)


def kernel_block(dim: int) -> int:
    """Threads per block of the kernel: the largest of 128, 64 and 32 whose
    two ``[D][block]`` tiles (x and the trial, f32) fit a block's shared
    memory, or 0 outside the envelope (D > 363)."""
    if not 0 < dim <= MAX_DIM:
        return 0
    return family.pick_block(lambda block: 2 * dim * block * 4)


def shade_pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernel covers this config (else use the portable
    path): a named objective, float32, michalewicz within its phase bound,
    and D <= 363.  The name is the JAX package's."""
    return family.family_supported(objective_name, dtype, dim, kernel_block)


def shade_step_plain(scalars, pos, fit, f_row, cr_row, archive, elite,
                     r_cross, r_src, objective_name, half_width, tile_n,
                     step):
    """One generation on ``[D, N]``; ``r_cross is None`` draws from
    Philox.  ``step`` is the generation, an int or a [1] integer tensor
    (the counter a replayed run keeps on the device)."""
    d, n = pos.shape
    seed = scalars[0:1]
    if torch.is_tensor(step):
        step = step.reshape(()).to(torch.int64)
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
    tile_n: int = 4096, rng: str = "device", step=0,
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
        _fn = family.bind("shade_fused", "dsa_shade_fused_f32", 12,
                          [i, i, i, ctypes.c_uint, i, ctypes.c_float])
    return _fn


def fused_shade_step_cuda(
    scalars, pos, fit, f_row, cr_row, archive, elite, r_cross=None,
    r_src=None, *, objective_name: str, half_width: float = 5.12,
    tile_n: int = 4096, rng: str = "device", step=0, out=None,
):
    """Launch the CUDA kernel: one fused SHADE-R generation on ``pos`` [D,
    N] and ``fit`` [1, N] with the per-individual ``f_row`` and ``cr_row``
    [1, N], the archive [D, N] and the elite pool [D, 128] (f32,
    contiguous, one CUDA device; N a multiple of ``tile_n``, ``tile_n`` of
    128).  ``scalars`` is [9] int32 on the device: the seed, the tile
    shifts of r1, r2 and the archive, their lane shifts, the elite pool's
    shift and the archive fraction in 16.16 fixed point; ``step`` is the
    generation (the Philox counter): an int, or a [1] int32 tensor on the
    device that the kernel reads.  ``out`` takes ``(pos, fit)`` tensors to
    write (neither may be an input).  Returns ``(pos, fit)``, new tensors
    unless ``out``, without waiting for the kernel."""
    global LAUNCHES, _captured
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    _check(rng, r_cross, r_src, tile_n, n)
    if rng == "device":
        r_cross = r_src = None
    row = (1, n)
    pos_out, fit_out = ((torch.empty_like(pos), torch.empty_like(fit))
                        if out is None else out)
    family.check_operands(
        "fused_shade_step_cuda", scalars, 9, pos,
        dict(fit=(fit, row), f_row=(f_row, row), cr_row=(cr_row, row),
             archive=(archive, (d, n)), elite=(elite, (d, ELITE)),
             r_cross=(r_cross, (d, n)), r_src=(r_src, row),
             pos_out=(pos_out, (d, n)), fit_out=(fit_out, row)))
    if kernel_block(d) == 0:
        raise ValueError(
            f"fused_shade_step_cuda: D = {d} is outside the kernel's "
            f"envelope (D <= {MAX_DIM})")
    step_dev = None
    if torch.is_tensor(step):
        if (step.dtype != torch.int32 or step.numel() != 1
                or step.device != pos.device):
            raise ValueError("fused_shade_step_cuda: a step tensor must be "
                             f"one int32 on {pos.device}")
        step_dev, step = step, 0
    err = _kernel()(
        scalars.data_ptr(), family.ptr(step_dev),
        *(t.data_ptr() for t in (pos, fit, f_row, cr_row, archive, elite)),
        family.ptr(r_cross), family.ptr(r_src), pos_out.data_ptr(),
        fit_out.data_ptr(), n, d, int(tile_n), int(step) & _MASK32,
        OBJECTIVE_IDS[objective_name], float(half_width),
        *family.stream_args(pos),
    )
    family.check_launch(err, "shade")
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
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


class _Run(NamedTuple):
    """What a run's generations share: the generator, the sizes, the
    seed, the archive fraction, the pad lanes' mask, the archive window's
    lanes and the kernel's keywords."""

    gen: torch.Generator
    n_pad: int
    d: int
    n_tiles: int
    tile_n: int
    seed: torch.Tensor
    frac: torch.Tensor
    valid: torch.Tensor
    win_lanes: torch.Tensor
    step_kw: dict


# What a generation carries to the next beside pos_t, fit_t and the archive
# (which it writes in place).
_CARRIED = ("m_f", "m_cr", "mem_k", "best_fit", "best_pos")


def _generation(run: _Run, c: dict, step, draws=None, out=None) -> dict:
    """One generation on the carry ``c`` (``pos_t``, ``fit_t``, ``arch_t``
    and ``_CARRIED``): the draws (``draws``, else from the generator), F
    and CR, the elite pool, the kernel (into ``out`` if given), the success
    memory, the archive window (in place) and the best.  Returns the next
    carry."""
    pos_t, fit_t, arch_t = c["pos_t"], c["fit_t"], c["arch_t"]
    slot, cauchy, normal, tshift, lshift, win_i, r_cross, r_src = (
        draws if draws is not None else generation_draws(
            run.gen, run.n_pad, run.d, run.n_tiles, run.tile_n,
            run.step_kw["rng"] == "host", pos_t.device))
    slot = slot.long()
    f_i = torch.clamp(c["m_f"][slot] + F_SCALE * cauchy, 0.01, 1.0)
    cr_i = torch.clamp(c["m_cr"][slot] + CR_SCALE * normal, 0.0, 1.0)
    scalars = torch.cat([run.seed, tshift.to(torch.int32).reshape(3),
                         lshift.to(torch.int32).reshape(4), run.frac])
    elite = tile_champion_elite(pos_t, fit_t[0], run.n_tiles, run.tile_n)
    args = (scalars, pos_t, fit_t, f_i[None, :].contiguous(),
            cr_i[None, :].contiguous(), arch_t, elite, r_cross, r_src)
    if out is None:
        new_pos_t, new_fit_t = fused_shade_step_t(*args, **run.step_kw,
                                                  step=step)
    else:
        new_pos_t, new_fit_t = fused_shade_step_cuda(
            *args, **run.step_kw, step=step, out=out)

    # Success bookkeeping; the cyclic pad lanes do not count.
    better = (new_fit_t[0] < fit_t[0]) & run.valid
    w = torch.where(better, fit_t[0] - new_fit_t[0],
                    torch.zeros_like(fit_t[0]))
    m_f, m_cr, mem_k = memory_update(better, w, f_i, cr_i, c["m_f"],
                                     c["m_cr"], c["mem_k"])

    # Defeated parents into the archive, in a window at a random multiple
    # of 128 lanes, written in place.
    win = run.win_lanes.numel()
    off = torch.clamp(win_i.long().reshape(()) * 128, max=run.n_pad - win)
    idx = off + run.win_lanes
    kept = torch.where(better.index_select(0, idx)[None, :],
                       pos_t.index_select(1, idx),
                       arch_t.index_select(1, idx))
    arch_t.index_copy_(1, idx, kept)

    best_fit, best_pos = merge_best(*best_of_block(new_fit_t, new_pos_t),
                                    c["best_fit"], c["best_pos"])
    return dict(pos_t=new_pos_t, fit_t=new_fit_t, arch_t=arch_t, m_f=m_f,
                m_cr=m_cr, mem_k=mem_k, best_fit=best_fit, best_pos=best_pos)


class _Replay(NamedTuple):
    """Two captured generations: the graph, the static tensors it reads
    and writes (``pos`` and ``fit`` a pair each: the first generation
    reads the first and writes the second, the next back), the launches
    its capture recorded, and what it was captured for (the run's sizes
    and parameters; the generator is ``run``'s)."""

    graph: torch.cuda.CUDAGraph
    run: _Run
    pos: Tuple[torch.Tensor, torch.Tensor]
    fit: Tuple[torch.Tensor, torch.Tensor]
    static: dict
    launches: int
    key: tuple


# The last capture, replayed by the next run whose state has the same
# generator, sizes and parameters (a model's later runs).
_replay: Optional[_Replay] = None


def _capture(run: _Run, c0: dict, key: tuple) -> _Replay:
    """Capture two generations into one CUDA graph over static copies of
    the carry, with the run's generator registered and the generation a
    counter on the device (``static["step"]``) that the graph advances.
    Raises if the capture fails or did not record one launch a
    generation."""
    global _captured
    dev = c0["pos_t"].device
    static = {f: c0[f].clone() for f in _CARRIED}
    static.update(arch_t=c0["arch_t"].clone(), seed=run.seed.clone(),
                  step=torch.zeros(1, dtype=torch.int32, device=dev))
    pos = (c0["pos_t"].clone(), torch.empty_like(c0["pos_t"]))
    fit = (c0["fit_t"].clone(), torch.empty_like(c0["fit_t"]))
    run = run._replace(seed=static["seed"])

    def body():
        c = dict(static, pos_t=pos[0], fit_t=fit[0])
        for k in (0, 1):
            c = _generation(run, c, static["step"],
                            out=(pos[1 - k], fit[1 - k]))
            static["step"].add_(1)
        for f in _CARRIED:
            static[f].copy_(c[f])

    _captured = 0
    graph = capture_graph(body, run.gen, dev)
    if _captured != 2:
        raise RuntimeError("two captured SHADE generations must launch the "
                           f"kernel twice, got {_captured}")
    return _Replay(graph, run, pos, fit, static, _captured, key)


def _graph_run(run: _Run, c0: dict, n_steps: int, key: tuple) -> dict:
    """``n_steps`` generations from the carry ``c0``: pairs replayed from
    the graph of two captured ones (captured anew unless the last capture
    was made for this generator and ``key``), an odd last one eagerly.

    The generator is registered with the graph, so a replay draws from the
    generator's offset at that replay and advances it as the eager
    generations do: the run draws what the eager loop draws.  The
    generation counter starts at 0 and the graph adds one a generation.
    Each replay adds the launches its capture recorded.  ``c0`` is copied
    into the graph's static tensors, so the caller's tensors are never
    written; the returned carry holds the static tensors."""
    global _replay, LAUNCHES
    r = _replay
    if r is None or r.run.gen is not run.gen or r.key != key:
        _replay = r = None          # the old graph's memory goes first
        r = _replay = _capture(run, c0, key)
    r.pos[0].copy_(c0["pos_t"])
    r.fit[0].copy_(c0["fit_t"])
    for f in _CARRIED + ("arch_t",):
        r.static[f].copy_(c0[f])
    r.static["seed"].copy_(run.seed)
    r.static["step"].zero_()
    pairs, odd = divmod(n_steps, 2)
    for _ in range(pairs):
        r.graph.replay()
        LAUNCHES += r.launches
    c = dict(r.static, pos_t=r.pos[0], fit_t=r.fit[0])
    if odd:
        c = _generation(run, c, n_steps - 1)
    return c


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
    ``ops.shade.shade_run``.  The memory adaptation, the archive window
    (written in place on the run's own archive) and the best tracking run
    every generation, as PyTorch operations on the device.  ``draws[g]``
    replaces generation g's draws (see ``SHADEGenDraws``); by default they
    come from ``state.gen``.  On a card with ``rng="device"`` and no
    ``draws`` the generations are replayed from a CUDA graph
    (:func:`_graph_run`); on the CPU and with host draws they run
    eagerly."""
    n, d = state.pos.shape
    family.require_family_supported("shade", objective_name,
                                    state.pos.dtype, d, kernel_block, 363)
    family.check_rng(rng, (), 1)
    tile_n, _ = family.lane_tiling(n, tile_n, d)
    tile_n, n_pad, n_tiles = family.shrink_tile_for_donors(n, tile_n)
    win = max(tile_n, n_pad // archive_window_frac)
    win = min(ceil_to(win, 128), n_pad)
    dev = state.device

    # The pre-filled archive: rows not filled yet alias the population.
    row = torch.arange(n, device=dev)[:, None]
    arch_src = torch.where(row < state.archive_n, state.archive, state.pos)
    c = dict(
        pos_t=cyclic_pad_rows(state.pos, n_pad).T.contiguous(),
        fit_t=cyclic_pad_rows(state.fit, n_pad)[None, :].contiguous(),
        arch_t=cyclic_pad_rows(arch_src, n_pad).T.contiguous(),
        m_f=state.m_f.to(torch.float32), m_cr=state.m_cr.to(torch.float32),
        mem_k=state.mem_k, best_pos=state.best_pos.to(torch.float32),
        best_fit=state.best_fit.to(torch.float32))
    run = _Run(gen=state.gen, n_pad=n_pad, d=d, n_tiles=n_tiles,
               tile_n=tile_n, seed=seed_base(state.gen, dev),
               frac=torch.full((1,), FRAC_FX // 2, dtype=torch.int32,
                               device=dev),
               valid=torch.arange(n_pad, device=dev) < n,
               win_lanes=torch.arange(win, device=dev),
               step_kw=dict(objective_name=objective_name,
                            half_width=half_width, tile_n=tile_n, rng=rng))
    if (rng == "device" and draws is None and replays_graphs(dev)
            and n_steps >= 2):
        key = (n, d, n_pad, tile_n, win, objective_name, float(half_width))
        c = _graph_run(run, c, n_steps, key)
    else:
        for g in range(n_steps):
            c = _generation(run, c, g, None if draws is None else draws[g])

    dt = state.pos.dtype
    return SHADEState(
        pos=c["pos_t"].T[:n].to(dt).contiguous(),
        fit=c["fit_t"][0, :n].to(state.fit.dtype).clone(),
        best_pos=c["best_pos"].to(state.best_pos.dtype).clone(),
        best_fit=c["best_fit"].to(state.best_fit.dtype).clone(),
        m_f=c["m_f"].to(state.m_f.dtype).clone(),
        m_cr=c["m_cr"].to(state.m_cr.dtype).clone(),
        mem_k=c["mem_k"].clone(),
        archive=c["arch_t"].T[:n].to(state.archive.dtype).contiguous(),
        archive_n=torch.full((), n, dtype=torch.int32, device=dev),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )
