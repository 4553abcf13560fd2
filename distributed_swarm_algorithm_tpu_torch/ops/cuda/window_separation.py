"""Morton-window separation without a roll chain.

Replaces the TPU kernel ``ops/pallas/window_separation.py:
separation_window_pallas`` of the JAX package, the fused form of the
window pass that ``separation_mode="window"`` runs every tick:

- :func:`separation_window_cuda` launches the hand-written CUDA kernel
  ``csrc/window_separation.cu`` (built on first use by ``_build.py``) on
  Morton-sorted CUDA tensors and raises on anything else;
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

import torch

from .. import neighbors as _neighbors
from . import _build

# Launches of the CUDA kernel since the count was last set to 0.  Only
# separation_window_cuda adds to it, once per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("window_separation").dsa_window_separation_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    global LAUNCHES
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
        float(k_sep), float(personal_space), float(eps),
        pos.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"window separation kernel launch failed: CUDA error {err}"
        )
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
