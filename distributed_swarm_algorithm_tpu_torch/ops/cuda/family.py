"""What the fused bat, grey-wolf, salp and whale modules share beyond
``pso_fused.py``'s registry, generator and block loop: the JAX package's
lane tiling (the salp and whale kernels compute with their tile), Hopper's
shared-memory envelope, the operand checks of the kernel wrappers and the
device scalars each launch reads.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

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
                             dim: int, block_of, dim_max: int) -> None:
    """Raise unless the family's kernel covers this configuration: the
    fused runs do not fall back to the portable path."""
    if not family_supported(objective_name, dtype, dim, block_of):
        raise ValueError(
            f"the fused {family} kernel does not cover objective "
            f"{objective_name!r} with {dtype} state at D = {dim}: it takes "
            f"a named objective of {sorted(OBJECTIVES_T)}, float32 state, "
            f"D <= {dim_max} (michalewicz: D <= {MICHALEWICZ_DIM_MAX})"
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
