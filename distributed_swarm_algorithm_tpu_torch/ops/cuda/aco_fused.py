"""Fused whole-tour ACO: tour construction and the deposit matrix.

Replaces the TPU kernels ``ops/pallas/aco_fused.py:fused_construct_tours``
(B20) and ``ops/pallas/aco_fused.py:fused_deposit_matrix`` (B21) of the JAX
package.  Both live in ``csrc/aco_fused.cu``.

- :func:`construct_tours_cuda` / :func:`deposit_matrix_cuda` launch the
  hand-written CUDA kernels on CUDA tensors and raise on anything else;
- :func:`construct_tours_plain` / :func:`deposit_matrix_plain` are the
  plain PyTorch versions: the same arithmetic in the same order and the same
  Philox draws, so tours, lengths and D equal the kernels' bit for bit;
- :func:`construct_tours_t` / :func:`deposit_matrix_t` are the entries: the
  plain version for CPU tensors, the kernel for CUDA tensors.  Nothing
  falls back.

Tour construction follows the JAX package's fused kernel, not its portable
step: each ant scores the cities by column ``cur`` of the log-space scores
(the TPU kernel's ``logits @ onehot(cur)``; the portable step reads row
``cur``, the same for a symmetric instance only), samples by Gumbel-argmax
over the unvisited cities with the Gumbel noise ``-ln(-ln(u))`` through the
bit-field ``log2``, and adds ``dist[next, cur]`` to its length step by step,
then the closing edge ``dist[start, last]``.  Ties of the argmax go to the
lowest city.  ``rng="device"`` draws on the chip (Philox4x32-10, counter
(ant, block of four cities, step, 0), the exploit uniform word 0 of (ant, 0,
step, 1)); ``rng="host"`` takes ``(start [A], u [C - 1, C, A], u_q [C - 1,
A])`` as operands, JAX's host uniforms ``[(C - 1) Cp, A_pad]`` reshaped and
sliced.

The deposit ``D[i, j] = sum_a q / L_a #{t : tour_a[t] = i, tour_a[t + 1] =
j}`` sums over the ants in ascending order (and t ascending), so it does not
change from run to run; the step adds ``D + D^T`` to the evaporated
pheromone.  On the card it is two kernels a call, reading the tours where
they lie: a stable bucketing of the edges by row, then one block a row
adding its edges in order (``csrc/aco_fused.cu`` says why).

The envelope is the kernel's (no VMEM fit model): C <= 2,048 cities (a team
of at most 128 lanes an ant, 16 cities and a 32-bit visited mask a lane;
:func:`tour_geometry`), any number of ants with A C < 2^31.

On the card, :func:`fused_aco_run` with device draws replays one captured
colony iteration from a CUDA graph, so the host launches one graph an
iteration instead of its ~35 operations; the capture is kept for the next
run of the same colony.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..aco import (
    _NEG,
    ACOState,
    aco_logits,
    elite_deposit,
    track_best_tour,
)
from .._numerics import rdiv
from . import _build
from .common import capture_graph
from .fast_math import LN2, log2_fast
from .pso_fused import philox_uniforms, seed_base

# Launches of each kernel since its count was last set to 0: one per call
# of construct_tours_cuda (B20) and of deposit_matrix_cuda (B21; a call
# launches its two kernels).  A call made while the stream is capturing a
# CUDA graph adds to _captured instead, and each replay of a colony
# iteration that fused_aco_run captured adds what its capture recorded.
TOURS_LAUNCHES = 0
DEPOSIT_LAUNCHES = 0
_captured = {"tours": 0, "deposit": 0}

MAX_CITIES = 2048

# Threads of a tours block and the most lanes of one ant's team
# (csrc/aco_fused.cu: kTourThreads, kMaxTeamLanes; its entry rejects a
# geometry that does not fit them).
TOUR_THREADS = 256
MAX_TEAM_LANES = 128

_fns = {}   # the C entries, bound at the first launch


def aco_cuda_supported(n_cities: int, n_ants: int = 1024) -> bool:
    """True when the fused kernels hold this instance: 1 <= C <= 2,048 and
    1 <= A with A C < 2^31."""
    return (1 <= n_cities <= MAX_CITIES and n_ants >= 1
            and n_ants * n_cities < 2**31)


def require_supported(n_cities: int, n_ants: int) -> None:
    """Raise, naming the limit, unless the kernels hold the instance: the
    fused path does not fall back to the portable one."""
    if not aco_cuda_supported(n_cities, n_ants):
        raise ValueError(
            f"the fused ACO kernels take 1 <= C <= {MAX_CITIES} cities and "
            f"A >= 1 ants with A C < 2^31, got C = {n_cities}, A = {n_ants}; "
            "use the portable ops/aco.py path")


class TourGeometry(NamedTuple):
    """How the tours kernel lays out ants: ``lanes`` per ant (its team),
    ``ants_per_block`` teams a block of ``TOUR_THREADS``, ``blocks_per_lane``
    blocks of four cities a lane, and the ``shared`` bytes a block takes
    for the team's exchange of its warps' bests."""

    lanes: int
    ants_per_block: int
    blocks_per_lane: int
    shared: int


def tour_geometry(n_cities: int) -> TourGeometry:
    """The tours kernel's team for C cities, handed to its entry, which
    checks it (``csrc/aco_fused.cu: tour_geometry_ok``): a lane per block
    of four cities, at least a warp and at most ``MAX_TEAM_LANES`` (32
    lanes up to 128 cities, 64 up to 256, 128 above, with 2 blocks a lane
    up to 1,024 and 4 up to 2,048; three would do up to 1,536, but that
    variant spilled registers); two parities of a (key, city) pair of each
    rule for each warp of a block where a team spans warps."""
    if not 1 <= n_cities <= MAX_CITIES:
        raise ValueError(f"the tours kernel takes 1 <= C <= {MAX_CITIES} "
                         f"cities, got {n_cities}")
    blocks = -(-n_cities // 4)
    lanes = 32 if blocks <= 32 else 64 if blocks <= 64 else MAX_TEAM_LANES
    per_lane = -(-blocks // lanes)
    shared = 2 * (TOUR_THREADS // 32) * 2 * 8 if lanes > 32 else 0
    return TourGeometry(lanes, TOUR_THREADS // lanes,
                        per_lane if per_lane <= 2 else 4, shared)


def q0_mode(q0: float) -> int:
    """The kernel's static rule: 0 samples only (q0 <= 0), 2 greedy only
    (q0 >= 1), 1 mixed."""
    return 0 if q0 <= 0.0 else 2 if q0 >= 1.0 else 1


def gumbel_fast(u: torch.Tensor) -> torch.Tensor:
    """The kernels' Gumbel noise from U[0, 1) draws:
    ``-LN2 log2(-LN2 log2(clip(1 - u, 1e-7, 0.9999999)))``."""
    v = torch.clamp(1.0 - u, 1e-7, 0.9999999)
    return -(LN2 * log2_fast(-(LN2 * log2_fast(v))))


def tour_lengths_in_order(dist: torch.Tensor,
                          tours: torch.Tensor) -> torch.Tensor:
    """[A] closed-tour lengths summed as the kernel sums them:
    ``dist[tour[t], tour[t - 1]]`` for t = 1 .. C - 1 from 0, then
    ``dist[tour[0], tour[-1]]``."""
    t = tours.long()
    length = torch.zeros(t.shape[0], dtype=dist.dtype, device=dist.device)
    for k in range(1, t.shape[1]):
        length = length + dist[t[:, k], t[:, k - 1]]
    return length + dist[t[:, 0], t[:, -1]]


def _check_tours_operands(name, logits, dist, start, seed, u, uq):
    c = logits.shape[0] if logits.ndim == 2 else 0
    a = start.shape[0] if start.ndim == 1 else 0
    if logits.ndim != 2 or logits.shape != (c, c) or tuple(dist.shape) != (
            c, c):
        raise ValueError(f"{name} takes square [C, C] logits and dist, got "
                         f"{tuple(logits.shape)} and {tuple(dist.shape)}")
    if (u is None) != (uq is None):
        raise ValueError(f"{name}: pass both u and uq (host draws) or "
                         "neither")
    if u is not None and (tuple(u.shape) != (c - 1, c, a)
                          or tuple(uq.shape) != (c - 1, a)):
        raise ValueError(f"{name}: u must be {(c - 1, c, a)} and uq "
                         f"{(c - 1, a)}, got {tuple(u.shape)} and "
                         f"{tuple(uq.shape)}")
    require_supported(c, a)
    if u is None and (seed is None or seed.numel() != 1):
        raise ValueError(f"{name}: device draws need a [1] int32 seed")
    return c, a


def construct_tours_plain(logits: torch.Tensor, dist: torch.Tensor,
                          start: torch.Tensor, seed: Optional[torch.Tensor],
                          q0: float = 0.0, u: Optional[torch.Tensor] = None,
                          uq: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`construct_tours_cuda`, on any
    device: ``(tours [A, C] int32, lengths [A] f32)``."""
    c, a = _check_tours_operands("construct_tours_plain", logits, dist,
                                 start, seed, u, uq)
    mode = q0_mode(q0)
    ants = torch.arange(a, device=logits.device)
    cur = start.long()
    first = cur
    visited = torch.zeros((a, c), dtype=torch.bool, device=logits.device)
    visited[ants, cur] = True
    neg = torch.full((), _NEG, dtype=logits.dtype, device=logits.device)
    length = torch.zeros(a, dtype=dist.dtype, device=dist.device)
    steps = [cur]
    for s in range(c - 1):
        row = logits[:, cur].T                              # [A, C]
        if mode != 2:
            draw = (philox_uniforms(seed, a, c, s, 0) if u is None
                    else u[s]).T
            s_idx = torch.argmax(
                torch.where(visited, neg, row + gumbel_fast(draw)), dim=1)
        if mode != 0:
            g_idx = torch.argmax(torch.where(visited, neg, row), dim=1)
        if mode == 0:
            nxt = s_idx
        elif mode == 2:
            nxt = g_idx
        else:
            draw = (philox_uniforms(seed, a, 1, s, 1)[0] if uq is None
                    else uq[s])
            nxt = torch.where(draw < q0, g_idx, s_idx)
        length = length + dist[nxt, cur]
        visited[ants, nxt] = True
        cur = nxt
        steps.append(cur)
    length = length + dist[first, cur]
    return torch.stack(steps, dim=1).to(torch.int32), length


def _bind(entry, argtypes):
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load("aco_fused"), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def _check_cuda(name, tensors):
    """Every operand: a contiguous tensor of its dtype on one CUDA
    device."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for label, t, dtype in tensors:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {label} lies on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def construct_tours_cuda(logits: torch.Tensor, dist: torch.Tensor,
                         start: torch.Tensor, seed: Optional[torch.Tensor],
                         q0: float = 0.0, u: Optional[torch.Tensor] = None,
                         uq: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tour kernel: ``logits`` and ``dist`` [C, C] f32 (the
    scores are read by column, as the TPU kernel reads them), ``start``
    [A] int32 in [0, C) (an ant starting elsewhere gets tour -1 and length
    NaN), ``seed`` [1] int32 (device draws) or ``u``
    [C - 1, C, A] and ``uq`` [C - 1, A] f32 (host draws), on one CUDA
    device.  Returns ``(tours [A, C] int32, lengths [A] f32)`` without
    waiting for the kernel."""
    global TOURS_LAUNCHES
    _check_cuda("construct_tours_cuda", [
        ("logits", logits, torch.float32), ("dist", dist, torch.float32),
        ("start", start, torch.int32), ("seed", seed, torch.int32),
        ("u", u, torch.float32), ("uq", uq, torch.float32)])
    c, a = _check_tours_operands("construct_tours_cuda", logits, dist, start,
                                 seed, u, uq)
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int32, device=logits.device)
    logits_t, dist_t = logits.T.contiguous(), dist.T.contiguous()
    tours = torch.empty((a, c), dtype=torch.int32, device=logits.device)
    lengths = torch.empty(a, dtype=torch.float32, device=logits.device)
    p = ctypes.c_void_p
    fn = _bind("dsa_aco_tours_f32", [p] * 8 + [ctypes.c_int] * 2
               + [ctypes.c_float] + [ctypes.c_int] * 6 + [p])
    err = fn(logits_t.data_ptr(), dist_t.data_ptr(), start.data_ptr(),
             None if u is None else u.data_ptr(),
             None if uq is None else uq.data_ptr(), seed.data_ptr(),
             tours.data_ptr(), lengths.data_ptr(), c, a, float(q0),
             q0_mode(q0), *tour_geometry(c), logits.device.index,
             torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ACO tour kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        _captured["tours"] += 1
    else:
        TOURS_LAUNCHES += 1
    return tours, lengths


def construct_tours_t(logits, dist, start, seed, q0=0.0, u=None, uq=None):
    """Tour construction: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    fn = (construct_tours_plain if logits.device.type == "cpu"
          else construct_tours_cuda)
    return fn(logits, dist, start, seed, q0, u, uq)


def _deposit_edges(tours: torch.Tensor, amount: torch.Tensor):
    """(flat cell i C + j, amount) of every in-range edge, in (ant, t)
    order."""
    c = tours.shape[1]
    cur = tours.long()
    nxt = torch.roll(cur, -1, dims=1)
    ok = (cur >= 0) & (cur < c) & (nxt >= 0) & (nxt < c)
    return (cur * c + nxt)[ok], amount[:, None].expand(cur.shape)[ok]


def deposit_matrix_plain(tours: torch.Tensor,
                         amount: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`deposit_matrix_cuda`, on any
    device: [C, C] f32, each cell the sum of its edges' amounts from 0 in
    (ant, t) order."""
    a, c = tours.shape
    keys, amt = _deposit_edges(tours, amount)
    d = torch.zeros(c * c, dtype=torch.float32, device=tours.device)
    if keys.numel():
        order = torch.sort(keys, stable=True).indices
        keys, amt = keys[order], amt[order]
        idx = torch.arange(keys.numel(), device=keys.device)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        rank = idx - torch.cummax(torch.where(first, idx,
                                              torch.zeros_like(idx)),
                                  dim=0).values
        # The r-th edge of every cell at once: the cells of one rank differ.
        by_rank = torch.sort(rank, stable=True).indices
        keys, amt = keys[by_rank], amt[by_rank]
        offset = 0
        for size in torch.bincount(rank).tolist():
            k = keys[offset:offset + size]
            d[k] = d[k] + amt[offset:offset + size]
            offset += size
    return d.reshape(c, c)


def deposit_scratch_ints(n_cities: int, n_ants: int) -> int:
    """The int32 scratch of one deposit call: each bucketing chunk's row
    starts (``C + 1`` each, chunks of ``max(1024, 4 C)`` edges rounded up
    to 32), then every edge as (next city, amount), 8-byte aligned; as the
    kernel's ``dsa_aco_deposit_scratch_ints``."""
    c, e = n_cities, n_ants * n_cities
    chunk = max(1024, -(-4 * c // 32) * 32)
    starts = -(-e // chunk) * (c + 1)
    return starts + (starts & 1) + 2 * e


def deposit_matrix_cuda(tours: torch.Tensor,
                        amount: torch.Tensor) -> torch.Tensor:
    """Launch the deposit on ``tours`` [A, C] int32, read where it lies,
    and ``amount`` [A] f32 on one CUDA device (C <= 2,048).  One call is
    two kernels (the edges bucketed by row, then an ordered sum a row) and
    counts as one launch.  Returns D [C, C] f32 without waiting for the
    kernels."""
    global DEPOSIT_LAUNCHES
    _check_cuda("deposit_matrix_cuda", [("tours", tours, torch.int32),
                                        ("amount", amount, torch.float32)])
    if tours.ndim != 2 or tuple(amount.shape) != (tours.shape[0],):
        raise ValueError("deposit_matrix_cuda takes [A, C] tours and [A] "
                         f"amounts, got {tuple(tours.shape)} and "
                         f"{tuple(amount.shape)}")
    a, c = tours.shape
    require_supported(c, a)
    d = torch.empty((c, c), dtype=torch.float32, device=tours.device)
    n_scratch = deposit_scratch_ints(c, a)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=tours.device)
    p = ctypes.c_void_p
    fn = _bind("dsa_aco_deposit_f32",
               [p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [p])
    err = fn(tours.data_ptr(), amount.data_ptr(), d.data_ptr(),
             scratch.data_ptr(), n_scratch, c, a, tours.device.index,
             torch.cuda.current_stream(tours.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ACO deposit kernel launch failed: CUDA error "
                           f"{err}")
    if torch.cuda.is_current_stream_capturing():
        _captured["deposit"] += 1
    else:
        DEPOSIT_LAUNCHES += 1
    return d


def deposit_matrix_t(tours: torch.Tensor, amount: torch.Tensor):
    """The deposit matrix: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    fn = (deposit_matrix_plain if tours.device.type == "cpu"
          else deposit_matrix_cuda)
    return fn(tours, amount)


def host_draws(gen: torch.Generator, n_cities: int, n_ants: int, device):
    """``(start [A] int32, u [C - 1, C, A], uq [C - 1, A])`` for
    ``rng="host"`` when the caller hands in none."""
    c, a = n_cities, n_ants
    return (torch.randint(0, c, (a,), generator=gen, dtype=torch.int32,
                          device=device),
            torch.rand((c - 1, c, a), generator=gen, device=device),
            torch.rand((c - 1, a), generator=gen, device=device))


def fused_construct_tours(
    tau: torch.Tensor,
    dist: torch.Tensor,
    gen: torch.Generator,
    n_ants: int,
    alpha: float = 1.0,
    beta: float = 2.0,
    q0: float = 0.0,
    rng: str = "device",
    draws: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ants' whole tours in one launch: ``(tours [A, C] int32, lengths
    [A] f32)``, the lengths summed in the kernel.  ``rng="host"`` takes
    ``draws = (start, u, uq)`` (or draws them from ``gen``)."""
    if rng not in ("device", "host"):
        raise ValueError(f'rng must be "device" or "host", got {rng!r}')
    if rng == "device" and draws is not None:
        raise ValueError('draws are operands of rng="host"')
    c = dist.shape[0]
    require_supported(c, n_ants)
    logits = aco_logits(tau, dist, alpha, beta).to(torch.float32)
    dist = dist.to(torch.float32)
    if rng == "host":
        start, u, uq = (host_draws(gen, c, n_ants, dist.device)
                        if draws is None else draws)
        return construct_tours_t(logits, dist, start.to(torch.int32), None,
                                 q0, u, uq)
    start = torch.randint(0, c, (n_ants,), generator=gen, dtype=torch.int32,
                          device=dist.device)
    return construct_tours_t(logits, dist, start, seed_base(gen, dist.device),
                             q0)


def fused_deposit_matrix(tours: torch.Tensor, lengths: torch.Tensor,
                         q: float = 1.0) -> torch.Tensor:
    """[C, C] directed deposit ``D[i, j] = sum_a q / L_a`` over each ant's
    consecutive (and closing) edges."""
    return deposit_matrix_t(tours, rdiv(q, lengths.to(torch.float32)))


def fused_aco_step(
    state: ACOState,
    n_ants: int,
    alpha: float = 1.0,
    beta: float = 2.0,
    rho: float = 0.1,
    q0: float = 0.0,
    elite: float = 0.0,
    rng: str = "device",
    draws: Optional[Tuple[torch.Tensor, ...]] = None,
    out: Optional[dict] = None,
) -> ACOState:
    """One colony iteration on the two kernels, with no read from the
    device: construct (B20), best tracking, ``tau = (1 - rho) tau + D +
    D^T`` with D from B21, and the elitist deposit through the portable
    ``deposit`` with ``rho = 0``.  A dict ``out`` receives the iteration's
    ``tours`` [A, C] and in-kernel ``lengths`` [A]."""
    tours, lengths = fused_construct_tours(
        state.tau, state.dist, state.gen, n_ants, alpha, beta, q0, rng=rng,
        draws=draws)
    if out is not None:
        out.update(tours=tours, lengths=lengths)
    best_tour, best_len = track_best_tour(tours, lengths, state)
    d = fused_deposit_matrix(tours, lengths)
    tau = (1.0 - rho) * state.tau + d + d.T
    if elite > 0.0:
        tau = elite_deposit(tau, best_tour, best_len, elite)
    return state.replace(tau=tau, best_tour=best_tour, best_len=best_len,
                         iteration=state.iteration + 1)


def fused_aco_run(
    state: ACOState,
    n_steps: int,
    n_ants: int,
    alpha: float = 1.0,
    beta: float = 2.0,
    rho: float = 0.1,
    q0: float = 0.0,
    elite: float = 0.0,
    rng: str = "device",
    draws: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
    out: Optional[dict] = None,
) -> ACOState:
    """``n_steps`` fused colony iterations; ``draws[i]`` replaces
    iteration i's host draws, and ``out`` receives the last one's tours and
    lengths.

    With ``rng="device"`` on a card the iterations replay one captured
    :func:`fused_aco_step` from a CUDA graph (:func:`_graph_run`), as the
    JAX package runs them under one ``lax.scan``; the host then launches
    one graph an iteration where it would launch some 35 operations.  The
    results are the eager loop's bit for bit.  On the CPU and with host
    draws the loop runs eagerly."""
    if rng == "device" and state.device.type == "cuda" and n_steps > 0:
        if draws is not None:
            raise ValueError('draws are operands of rng="host"')
        return _graph_run(state, n_steps, n_ants,
                          (alpha, beta, rho, q0, elite), out)
    for i in range(n_steps):
        state = fused_aco_step(state, n_ants, alpha, beta, rho, q0, elite,
                               rng=rng,
                               draws=None if draws is None else draws[i],
                               out=out)
    return state


# The fields a colony iteration carries to the next.
_CARRIED = ("tau", "best_tour", "best_len", "iteration")


class _Replay(NamedTuple):
    """A captured colony iteration: its graph, the static state it reads
    and writes and the last tours and lengths it writes, the launches its
    capture recorded, and what it was captured for (the colony's sizes
    and parameters; the generator and distances are ``static``'s own)."""

    graph: torch.cuda.CUDAGraph
    static: ACOState
    last: dict
    launches: dict
    key: tuple


# The last captured iteration, replayed by the next run whose state has the
# same generator, distances, sizes and parameters (a colony's later runs).
_replay: Optional[_Replay] = None


def _capture(state: ACOState, n_ants: int, params: tuple,
             key: tuple) -> _Replay:
    """Capture one :func:`fused_aco_step` into a CUDA graph over static
    copies of the state's tensors, with the state's generator registered.
    Raises if the capture fails or did not record one launch of each
    kernel."""
    dev = state.device
    static = state.replace(**{f: getattr(state, f).clone()
                              for f in _CARRIED})
    last = {}

    def body():
        nxt = fused_aco_step(static, n_ants, *params, out=last)
        for f in _CARRIED:
            getattr(static, f).copy_(getattr(nxt, f))

    _captured.update(tours=0, deposit=0)
    graph = capture_graph(body, state.gen, dev)
    launches = dict(_captured)
    if launches != {"tours": 1, "deposit": 1}:
        raise RuntimeError("a captured colony iteration must launch the tours "
                           f"and deposit kernels once each, got {launches}")
    return _Replay(graph, static, last, launches, key)


def _graph_run(state: ACOState, n_steps: int, n_ants: int, params: tuple,
               out: Optional[dict]) -> ACOState:
    """``n_steps`` iterations replayed from the graph of one captured
    iteration, captured anew unless the last one was captured for this
    state's generator, distances, sizes and ``params``.

    The generator is registered with the graph, so a replay draws the start
    cities and the kernel's seed from the generator's offset at that replay
    and advances it as the eager step does: the run draws what the eager
    loop draws.  Each replay adds the launches its capture recorded.  The
    state is copied into the graph's static tensors and the result copied
    out of them, so the caller's tensors are never written.  No step waits
    for the device."""
    global _replay, TOURS_LAUNCHES, DEPOSIT_LAUNCHES
    key = (n_ants, params) + tuple(
        (tuple(getattr(state, f).shape), getattr(state, f).dtype)
        for f in _CARRIED)
    r = _replay
    if (r is None or r.static.gen is not state.gen
            or r.static.dist is not state.dist or r.key != key):
        _replay = r = None          # the old graph's memory goes first
        r = _replay = _capture(state, n_ants, params, key)
    for f in _CARRIED:
        getattr(r.static, f).copy_(getattr(state, f))
    for _ in range(n_steps):
        r.graph.replay()
        TOURS_LAUNCHES += r.launches["tours"]
        DEPOSIT_LAUNCHES += r.launches["deposit"]
    if out is not None:
        out.update(tours=r.last["tours"].clone(),
                   lengths=r.last["lengths"].clone())
    return state.replace(**{f: getattr(r.static, f).clone()
                            for f in _CARRIED})
