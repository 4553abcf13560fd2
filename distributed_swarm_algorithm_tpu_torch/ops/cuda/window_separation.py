"""Morton-window separation without a roll chain.

Replaces the TPU kernel ``ops/pallas/window_separation.py:
separation_window_pallas`` of the JAX package, the fused form of the
window pass that ``separation_mode="window"`` runs every tick:

- :func:`separation_window_cuda` launches the hand-written CUDA kernel
  ``csrc/window_separation.cu`` (built on first use by ``_build.py``) on
  Morton-sorted CUDA tensors and raises on anything else; its cut needs no
  square root (:func:`cut_threshold`), and its warps work their near pairs
  off in a queue (:func:`near_pair_queue` is the same queue in numpy);
- the plain version is ``ops/neighbors.py:separation_window``, the roll
  chain the JAX package runs off the TPU, on any device;
- :func:`separation_window` is the tick's entry: the plain version for a
  CPU tensor, the kernel for a CUDA tensor.  Unless ``presorted``, the
  Morton keys, the stable sort, the gather and the final scatter run as
  PyTorch operations around the kernel, as the JAX package runs them
  around its Pallas call.  A kernel that fails to build or launch raises;
  nothing falls back.

The kernel's arithmetic is that of the plain version, op for op; the
source says why and what bounds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import neighbors as _neighbors
from . import _build

# Launches of the CUDA kernel since the count was last set to 0.  Only
# separation_window_cuda adds to it, once per launch; a launch while the
# stream captures a CUDA graph adds to _captured instead, and each replay
# of a captured rollout chunk adds what its capture recorded
# (models/swarm.py).
LAUNCHES = 0
_captured = 0

_fn = None   # the C entry, bound at the first launch

WARP = 32      # receivers a warp: one queue
GROUP = 32     # tests a group: 16 shifts, both signs


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("window_separation").dsa_window_separation_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _f32(bits: int) -> np.float32:
    return np.array([bits], dtype=np.uint32).view(np.float32)[0]


@functools.lru_cache(maxsize=64)
def cut_threshold(r_cut: float) -> float:
    """The least float32 ``t`` whose correctly rounded square root is at
    least ``f32(r_cut)``, so that for every float32 ``s >= 0``
    ``sqrt_rn(s) < r_cut`` exactly when ``s < t`` (``sqrt_rn`` is monotone;
    NaN and +Inf fail both).  Found by bisection over the bit patterns of
    the non-negative floats; 0 where no float qualifies (a NaN ``r_cut``:
    nothing is near)."""
    r = np.float32(r_cut)
    lo, hi = 0, 0x7F800000                 # +0 .. +Inf
    if not np.sqrt(_f32(hi)) >= r:
        return 0.0
    while lo < hi:
        mid = (lo + hi) // 2
        if np.sqrt(_f32(mid)) >= r:
            hi = mid
        else:
            lo = mid + 1
    return float(_f32(lo))


class QueueCounts(NamedTuple):
    """What the staged kernel's warps do on an input (:func:`near_pair_queue`),
    per warp and group of 32 tests, [warps, groups] int64 each: ``total``
    near pairs, ``most`` near pairs of one lane, ``crowded`` whether the
    warp adds its own pairs lane by lane (rounds >= most), ``rounds`` of the
    queue (0 where crowded) and ``sums`` the receivers' add loop iterations
    summed over the rounds (each round the most entries one receiver
    holds in it)."""

    total: np.ndarray
    most: np.ndarray
    crowded: np.ndarray
    rounds: np.ndarray
    sums: np.ndarray


def near_pair_queue(pos: np.ndarray, alive: np.ndarray, k_sep: float,
                    r_cut: float, eps: float, window: int, sqrt=np.sqrt):
    """The staged kernel in numpy, float32 op for op: ``(force [n, 2],
    QueueCounts)``.  Each slot tests its 2W partners against
    :func:`cut_threshold` in groups of 32 (shifts +1, -1, +2, -2, ...), a
    dead or missing partner being a NaN position; each warp of 32 receivers
    lays its near pairs out lane by lane and shift by shift at the offsets
    of a prefix sum of its lanes' counts, computes entry p from the entry's
    (lane, test) alone, and each receiver adds the entries in its own range
    in queue order (a crowded warp: each lane its own pairs in shift
    order).  The sums are those of ``ops/neighbors.separation_window`` on
    the same presorted arrays.  ``sqrt`` rounds the near pairs' distances:
    numpy's is IEEE's, as the card's; PyTorch's on the CPU is not always
    (a few tenths of a percent of f32 inputs land an ulp off), so a
    comparison with the plain version on the CPU hands the model that."""
    f32 = np.float32
    pos = np.asarray(pos, dtype=f32)
    alive = np.asarray(alive).astype(bool)
    n = pos.shape[0]
    n_warps = -(-n // WARP)
    slots = n_warps * WARP
    pad = window
    staged = np.full((slots + 2 * pad, 2), np.nan, dtype=f32)
    staged[pad:pad + n][alive] = pos[alive]
    me = staged[pad:pad + slots]
    live = np.zeros(slots, dtype=bool)
    live[:n] = alive
    cut = f32(cut_threshold(r_cut))
    k_sep, eps = f32(k_sep), f32(eps)
    groups = -(-window // 16)
    force = np.zeros((slots, 2), dtype=f32)
    counts = {k: np.zeros((n_warps, groups), dtype=np.int64)
              for k in QueueCounts._fields}
    rows = np.arange(slots)

    def partner(r, g, k):
        shift = 16 * g + (k >> 1) + 1
        return staged[pad + r + np.where(k & 1, shift, -shift)]

    def term(r, g, k):
        p = partner(r, g, k)
        d = me[r] - p
        s = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        dc = np.maximum(sqrt(s), eps)
        mag = k_sep / (dc * dc)
        return (mag[:, None] * d) / dc[:, None]

    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for g in range(groups):
            near = np.zeros((slots, GROUP), dtype=bool)
            for k in range(GROUP):
                if 16 * g + (k >> 1) + 1 > window:
                    continue
                d = me - partner(rows, g, np.full(slots, k))
                near[:, k] = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) < cut
            near &= live[:, None]
            count = near.sum(1).reshape(n_warps, WARP)
            total, most = count.sum(1), count.max(1)
            rounds = -(-total // WARP)
            crowded = (total > 0) & (rounds >= most)
            off = (np.cumsum(count, 1) - count).reshape(-1)
            # The queue: each lane writes (lane << 5) | test at its offset
            # and on, in test order.
            recv, test = np.nonzero(near)
            warp = recv // WARP
            rank = np.arange(recv.size) - np.searchsorted(recv, recv)
            p = off[recv] + rank
            queue = np.zeros((n_warps, WARP * GROUP), dtype=np.int64)
            queue[warp, p] = ((recv % WARP) << 5) | test
            # Worker p % 32 of round p // 32 computes entry p from the entry
            # alone.
            entry = queue[warp, p]
            t = term(warp * WARP + (entry >> 5), g, entry & 31)
            worker_round = p // WARP
            # Each receiver adds the entries in [off, off + count), in queue
            # order.
            for j in range(GROUP):
                at = rank == j
                force[recv[at]] += t[at]
            # The receivers' add loops: in each round, the most entries one
            # receiver holds in it.
            q = ~crowded[warp]
            per = np.zeros((n_warps, max(int(rounds.max()), 1), WARP),
                           dtype=np.int64)
            np.add.at(per, (warp[q], worker_round[q], recv[q] % WARP), 1)
            counts["total"][:, g] = total
            counts["most"][:, g] = most
            counts["crowded"][:, g] = crowded
            counts["rounds"][:, g] = np.where(crowded, 0, rounds)
            counts["sums"][:, g] = per.max(2).sum(1)
    return force[:n], QueueCounts(**counts)


def separation_window_cuda(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    window: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on ``pos`` [N, 2] f32 and ``alive`` [N]
    bool or uint8, contiguous, on one CUDA device, with the agent axis in
    the order the window runs over.  Returns the force [N, 2] f32 in that
    order, without waiting for the kernel."""
    global LAUNCHES, _captured
    if pos.device.type != "cuda":
        raise ValueError(
            f"separation_window_cuda needs a CUDA tensor, got {pos.device}"
        )
    if pos.dtype != torch.float32:
        raise TypeError(
            f"separation_window_cuda takes float32 positions, got {pos.dtype}"
        )
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError(
            f"separation_window_cuda takes [N, 2] positions, got "
            f"{tuple(pos.shape)}"
        )
    n = pos.shape[0]
    if alive.shape != (n,) or alive.dtype not in (torch.bool, torch.uint8):
        raise ValueError(
            f"separation_window_cuda takes an [{n}] bool or uint8 alive "
            f"mask, got {tuple(alive.shape)} {alive.dtype}"
        )
    if alive.device != pos.device:
        raise ValueError("pos and alive lie on different devices")
    if not (pos.is_contiguous() and alive.is_contiguous()):
        raise ValueError("separation_window_cuda takes contiguous tensors")
    if not 1 <= window < 2**30:
        raise ValueError(f"window must be in [1, 2^30), got {window}")
    if n >= 2**30:
        raise ValueError(
            f"separation_window_cuda: N = {n} overflows int32 offsets"
        )
    out = torch.empty_like(pos)
    if n == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = fn(
        pos.data_ptr(), alive.data_ptr(), out.data_ptr(), n, int(window),
        float(k_sep), float(personal_space),
        cut_threshold(float(personal_space)), float(eps),
        pos.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"window separation kernel launch failed: CUDA error {err}"
        )
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        LAUNCHES += 1
    return out


def separation_window(
    pos: torch.Tensor,
    alive: torch.Tensor,
    k_sep: float,
    personal_space: float,
    eps: float,
    cell: float,
    window: int,
    presorted: bool = False,
) -> torch.Tensor:
    """The tick's separation for ``separation_mode="window"`` (one pass),
    [N, D]: the plain version on a CPU tensor, the CUDA kernel on a CUDA
    tensor.  Positions that are not 2-D get all-pairs separation, as in
    the JAX package."""
    if pos.device.type == "cpu" or pos.shape[1] != 2:
        return _neighbors.separation_window(
            pos, alive, k_sep, personal_space, eps, cell, window,
            presorted=presorted,
        )
    if presorted:
        return separation_window_cuda(
            pos, alive, k_sep, personal_space, eps, window
        )
    order = torch.sort(_neighbors.morton_keys(pos, cell), stable=True).indices
    force_s = separation_window_cuda(
        pos[order], alive[order], k_sep, personal_space, eps, window
    )
    force = torch.empty_like(pos)
    force[order] = force_s
    return force
