"""What the fused optimizer families share beyond ``pso_fused.py``'s
registry, generator and block loop: the JAX package's lane tiling (the
salp, whale, DE, SHADE and GA kernels compute with their tile), the
rotational donors' lane schedule and tile shifts, Hopper's shared-memory
envelope, the operand checks of the kernel wrappers and the device scalars
each launch reads.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .common import ceil_to
from .pso_fused import (
    _BLOCKS as BLOCKS,
    MAX_SHARED_BYTES,
    MICHALEWICZ_DIM_MAX,
    OBJECTIVES_T,
)

# The JAX package's lane tile bound (ops/pallas/pso_fused.py: MAX_TILE_N).
MAX_TILE_N = 8192

# The per-step lane rotations of the rotational donors: the port's copy of
# the JAX package's ops/pallas/de_fused.py:_LANE_SHIFTS.  Step s of a
# launch rolls donor k by a per-launch offset plus LANE_SHIFTS[s % 8][k].
# The whale reads the first column; DE and GA take all three.
LANE_SHIFTS = (
    (1, 45, 89), (3, 51, 101), (7, 57, 113), (11, 63, 5),
    (17, 71, 19), (23, 77, 31), (29, 83, 43), (37, 95, 59),
)


# The tile-in-step kernels' cluster variant (cuckoo, ABC): a thread a lane,
# at most 256 lanes a block where 16 blocks hold the tile, else at most
# 512; the cluster sizes their entries take (16 as a non-portable size).
CLUSTER_LANES, CLUSTER_MAX_LANES = 256, 512
CLUSTER_SIZES = (1, 2, 4, 8, 16)


class TileGeometry(NamedTuple):
    """How a tile-in-step kernel runs a tile, handed to its entry, which
    checks it."""
    variant: int    # 0: on chip across a cluster; 1: through global scratch
    cluster: int    # blocks a tile
    lanes: int      # lanes a block
    threads: int    # threads a block
    shared: int     # dynamic shared memory a block, bytes


def cluster_geometry(tile_n: int,
                     block_bytes: Callable[[int], int]
                     ) -> Optional[TileGeometry]:
    """The smallest cluster whose blocks, ``ceil(tile_n / cluster)`` lanes
    each, at most 256 (else 512), hold their share of a tile's state
    (``block_bytes(lanes)``) within a block's shared memory, or None."""
    for most in (CLUSTER_LANES, CLUSTER_MAX_LANES):
        for cluster in CLUSTER_SIZES:
            lanes = -(-tile_n // cluster)
            shared = block_bytes(lanes)
            if lanes <= most and shared <= MAX_SHARED_BYTES:
                return TileGeometry(0, cluster, lanes, ceil_to(lanes, 32),
                                    shared)
    return None


def auto_tile(d_pad: int) -> int:
    """The JAX package's lane tile for a padded depth (``_auto_tile`` of
    its ``ops/pallas/pso_fused.py``): 4,096 lanes at D = 30."""
    tile = (131072 // d_pad) // 128 * 128
    return max(128, min(MAX_TILE_N, tile))


def lane_tiling(n: int, tile_n: Optional[int], depth: int) -> Tuple[int, int]:
    """``(tile_n, n_pad)`` as the JAX package's fused runs pick them: the
    tile from the working depth (``auto_tile``) unless given, at most ``n``
    rounded up to 128, and the swarm padded to a whole number of tiles.
    The salp and whale kernels compute with the tile (the chain link, the
    peer roll); the others keep it so that their padding is JAX's."""
    if tile_n is None:
        tile_n = auto_tile(ceil_to(max(depth, 8), 8))
    tile_n = min(tile_n, ceil_to(n, 128))
    return tile_n, ceil_to(n, tile_n)


def shrink_tile_for_donors(n: int, tile_n: int) -> Tuple[int, int, int]:
    """``(tile_n, n_pad, n_tiles)`` with at least 4 tiles, so that three
    donor tile shifts can be distinct and nonzero: the tile halves in
    128-lane steps (the JAX package's ``shrink_tile_for_donors`` of
    ``ops/pallas/de_fused.py``, one device).  Raises where even 128-lane
    tiles give fewer than 4."""
    n_pad = ceil_to(n, tile_n)
    n_tiles = n_pad // tile_n
    while n_tiles < 4 and tile_n > 128:
        tile_n = max(128, (tile_n // 2) // 128 * 128)
        n_pad = ceil_to(n, tile_n)
        n_tiles = n_pad // tile_n
    if n_tiles < 4:
        raise ValueError(
            f"population n={n} too small for rotational donors (need >= 4 "
            "lane tiles of 128); use the portable path")
    return tile_n, n_pad, n_tiles


def distinct_tile_shifts(gen: torch.Generator, n_tiles: int,
                         device) -> torch.Tensor:
    """[3] int32: three distinct nonzero tile shifts mod ``n_tiles`` (>= 4),
    drawn on the device with the incremental-shift trick of the JAX
    package's ``de_fused._distinct_tile_shifts``: each draw comes from a
    shrunken range and is bumped past the shifts already taken."""
    def draw(high):
        return torch.randint(1, high, (), generator=gen, dtype=torch.int64,
                             device=device)
    a = draw(n_tiles)
    b = draw(n_tiles - 1)
    b = b + (b >= a).long()
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    c = draw(n_tiles - 2)
    c = c + (c >= lo).long()
    c = c + (c >= hi).long()
    return torch.stack([a, b, c]).to(torch.int32)


def donor_tiles(pos: torch.Tensor, tile_n: int, tile_shift) -> torch.Tensor:
    """[D, n_tiles, tile_n]: tile ``(i + tile_shift) mod n_tiles`` of
    ``pos`` in place of tile i (``tile_shift`` a device scalar)."""
    d, n = pos.shape
    n_tiles = n // tile_n
    tiles = (torch.arange(n_tiles, device=pos.device)
             + tile_shift.long()) % n_tiles
    return pos.reshape(d, n_tiles, tile_n).index_select(1, tiles)


def roll_lanes(tiles: torch.Tensor, shift) -> torch.Tensor:
    """``jnp.roll(tiles, shift, axis=-1)`` for a device scalar ``shift``:
    lane j reads lane ``(j - shift) mod tile_n``.  Returns [D, N]."""
    d, n_tiles, tile_n = tiles.shape
    lanes = torch.arange(tile_n, device=tiles.device)
    return tiles.index_select(2, (lanes - shift) % tile_n).reshape(d, -1)


def branch_order(classes: torch.Tensor, lanes: int = 256) -> torch.Tensor:
    """The order in which a kernel that regroups its lanes by branch (the
    Harris-hawks and whale kernels) advances a step's lanes: within each
    block of ``lanes`` lanes (the last may be short), the block's lanes
    sorted by class, stably, as a block does it (a count of each class in
    each warp, a prefix over the classes and the warps, each lane's rank in
    its warp's ballot).  ``classes`` [N], small integers from 0; returns
    [N], the lane at each place."""
    n = classes.numel()
    n_classes = int(classes.max()) + 1 if n else 0
    out = torch.empty(n, dtype=torch.int64, device=classes.device)
    for b0 in range(0, n, lanes):
        cls = classes[b0:b0 + lanes].long()
        warp = torch.arange(cls.numel(), device=cls.device) // 32
        n_warps = int(warp[-1]) + 1
        counts = torch.zeros((n_classes, n_warps), dtype=torch.int64,
                             device=cls.device)
        counts.index_put_((cls, warp), torch.ones_like(cls),
                          accumulate=True)
        # A class's start, then the counts of the warps before this one.
        starts = torch.cumsum(counts.sum(1), 0) - counts.sum(1)
        before = torch.cumsum(counts, 1) - counts
        rank = torch.zeros_like(cls)
        for c in range(n_classes):
            hit = (cls == c).long().reshape(-1)
            # The lanes of the class below this one in its warp.
            within = torch.cumsum(hit, 0) - hit
            first_of_warp = within[warp * 32]
            rank = torch.where(cls == c, within - first_of_warp, rank)
        place = starts[cls] + before[cls, warp] + rank
        out[b0 + place] = b0 + torch.arange(cls.numel(), device=cls.device)
    return out


def pick_block(shared_bytes: Callable[[int], int]) -> int:
    """The largest of 128, 64 and 32 threads whose shared memory
    (``shared_bytes(block)``) fits a block, or 0 when none does."""
    for block in BLOCKS:
        if shared_bytes(block) <= MAX_SHARED_BYTES:
            return block
    return 0


def family_supported(objective_name: str, dtype, dim, block_of) -> bool:
    """True if a fused family kernel covers this config: a named
    objective, float32, michalewicz within its poly-trig phase bound, and
    a dimension whose staged tile fits a block (``block_of(dim) > 0``).
    ``dim=None`` skips the checks on it."""
    if objective_name not in OBJECTIVES_T or dtype != torch.float32:
        return False
    if dim is None:
        return True
    if objective_name == "michalewicz" and dim > MICHALEWICZ_DIM_MAX:
        return False
    return block_of(dim) > 0


def require_family_supported(family: str, objective_name: str, dtype,
                             dim: int, block_of,
                             dim_max: Optional[int] = None) -> None:
    """Raise unless the family's kernel covers this configuration: the
    fused runs do not fall back to the portable path.  ``dim_max=None``:
    the kernel takes any D."""
    if not family_supported(objective_name, dtype, dim, block_of):
        bound = "" if dim_max is None else f"D <= {dim_max} "
        raise ValueError(
            f"the fused {family} kernel does not cover objective "
            f"{objective_name!r} with {dtype} state at D = {dim}: it takes "
            f"a named objective of {sorted(OBJECTIVES_T)}, float32 state, "
            f"{bound}(michalewicz: D <= {MICHALEWICZ_DIM_MAX})"
        )


def check_rng(rng: str, host_draws, k_steps: int) -> None:
    """The rng contract of every fused step: ``"device"`` draws in the
    kernel, ``"host"`` takes the draws as operands, one step per call."""
    if rng not in ("device", "host"):
        raise ValueError(f'rng must be "device" or "host", got {rng!r}')
    if rng == "host" and any(r is None for r in host_draws):
        raise ValueError('rng="host" requires every draw operand')
    if rng == "host" and k_steps != 1:
        raise ValueError('rng="host" supports k_steps=1 only')
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")


def check_operands(name: str, scalars: torch.Tensor, n_scalars: int,
                   pos: torch.Tensor, want: Dict[str, tuple]) -> None:
    """What every family kernel wrapper requires: ``pos`` a [D, N] CUDA
    tensor, each ``want[label] = (tensor, shape)`` float32, contiguous, of
    its shape, on pos's device (a ``None`` tensor is skipped), and
    ``scalars`` ``n_scalars`` int32 on that device."""
    if pos.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {pos.device}")
    if pos.ndim != 2:
        raise ValueError(f"{name} takes [D, N] arrays, got "
                         f"{tuple(pos.shape)}")
    for label, (t, shape) in dict(want, pos=(pos, tuple(pos.shape))).items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got "
                            f"{t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name}: {label} lies on {t.device}, pos on "
                             f"{pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if (scalars.dtype != torch.int32 or scalars.numel() != n_scalars
            or scalars.device != pos.device or not scalars.is_contiguous()):
        raise ValueError(f"{name}: scalars must be {n_scalars} int32 on "
                         f"{pos.device}")
    d, n = pos.shape
    if not 0 < n < 2**31 or d * n >= 2**40:
        raise ValueError(f"{name}: N = {n}, D = {d} is out of range")


def bind(source: str, entry: str, n_pointers: int, tail) -> Callable:
    """The C entry ``entry`` of ``csrc/<source>.cu`` with its argument
    types: ``n_pointers`` pointers, then ``tail`` (ctypes types), then the
    device index and the stream."""
    fn = getattr(_build.load(source), entry)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + list(tail)
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address, or None for a missing operand."""
    return None if t is None else t.data_ptr()


def stream_args(t: torch.Tensor) -> tuple:
    """(device index, current stream) of the tensor's card."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, family: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"fused {family} kernel launch failed: CUDA error {err}")


def block_scalars(*values: torch.Tensor) -> torch.Tensor:
    """[len(values)] int32 on the device, from [1] or 0-dim integer
    tensors: the scalars a launch reads (seed, block-start iteration,
    shifts), assembled without a read from the device."""
    return torch.cat([v.reshape(1).to(torch.int32) for v in values])


def random_int(gen: torch.Generator, high: int, device) -> torch.Tensor:
    """[1] int32 uniform in [0, high), drawn on the device."""
    return torch.randint(0, high, (1,), generator=gen, dtype=torch.int32,
                         device=device)
