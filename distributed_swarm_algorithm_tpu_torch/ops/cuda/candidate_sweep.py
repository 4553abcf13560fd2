"""The plan-native candidate sweep.

Replaces the TPU kernel ``ops/pallas/candidate_sweep.py:
candidate_sweep_pallas`` of the JAX package, the kernel path of
``separation_mode="hashgrid"`` with ``hashgrid_kernel="candidates"``: its
operands are the plan's own tables, so a plan carried across ticks (the
Verlet regime) costs no per-tick operand build.  For each cell ``c`` and
each receiver ``a = recv[c, r] < n``:

    f_a = sum_w near * k_sep / max(d, eps)^3 * (p_a - p_b),  b = cand[c, w]
    near = b < n, b != a, d < personal_space,  d = sqrt(dx^2 + dy^2)

with the select-form minimum image, at the CURRENT positions, so a stale
plan stays exact within its Verlet window.  A live agent sits in at most
one receiver slot; agents in none (dead, or past ``RK`` in a crowded cell)
get zero force.  Every row of both tables is a prefix of valid entries
followed by padding, as the plan builds them; the kernel reads a row only
up to its first padded chunk of 32.

- :func:`candidate_sweep_cuda` launches the hand-written CUDA kernel
  ``csrc/candidate_sweep.cu`` on CUDA tensors and raises on anything else;
- :func:`candidate_sweep_plain` is the same function in plain PyTorch: the
  union sweep of ``ops/neighbors.py`` over each receiver's row, its terms
  summed in row order as the kernel sums them;
- :func:`candidate_sweep` is the tick's entry: the plain version for a CPU
  tensor, the kernel for a CUDA tensor.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import neighbors as _neighbors
from . import _build
from .window_separation import cut_threshold

# Launches of the CUDA kernel since the count was last set to 0.  Only
# candidate_sweep_cuda adds to it, once per launch; a launch while the
# stream captures a CUDA graph adds to _captured instead, and each replay
# of a captured rollout adds what its capture recorded.
LAUNCHES = 0
_captured = 0

# The kernel stages its cells' candidates (index and position, 12 bytes)
# in shared memory, G cells a block of one warp: G * W <= 1024 keeps a
# block's 12 KB (19 blocks an SM), so W <= 1024.
MAX_WIDTH = 1024
MAX_CELLS_PER_WARP = 6       # the kernel's kMaxCells


def cells_per_warp(width: int) -> int:
    """G, the cells a warp of the kernel owns: 6 (about 18 receivers at
    the fast movers' density; fewer lanes than 8 would fill, but more
    blocks an SM), fewer for rows wider than 170 so that a warp's staging
    stays within 12 KB."""
    return max(1, min(MAX_CELLS_PER_WARP, MAX_WIDTH // width))

_fn = None   # the C entry, bound at the first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("candidate_sweep").dsa_candidate_sweep_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _cut2(personal_space: float) -> float:
    """The kernel's cut: d^2 < this exactly where sqrt_rn(d^2) <
    personal_space."""
    return cut_threshold(personal_space)


def candidate_sweep_supported(dim, dtype, width, recv_cap,
                              g=None) -> bool:
    """Whether the tables are inside the CUDA kernel's envelope: 2-D
    float32, ``1 <= W <= MAX_WIDTH`` (shared memory), ``RK >= 1`` and
    ``g >= 3`` when known.  (The wrapper also refuses agent counts whose
    indices overflow int32.)  The TPU kernel's VMEM model (W a multiple of
    128, RK of 8, 13 MB) does not apply."""
    if dim != 2 or dtype != torch.float32:
        return False
    if not 1 <= width <= MAX_WIDTH or recv_cap < 1:
        return False
    return g is None or g >= 3


def candidate_backend_choice(backend, dim, dtype, width, recv_cap, g=None,
                             knob="hashgrid_backend", on_cuda=False) -> bool:
    """The dispatch predicate of the candidates flavor, the twin of
    ``grid_separation.hashgrid_backend_choice``."""
    if backend not in ("auto", "pallas", "portable"):
        raise ValueError(
            f"unknown {knob} {backend!r}; "
            "expected 'auto', 'pallas', or 'portable'"
        )
    if backend == "portable":
        return False
    supported = candidate_sweep_supported(dim, dtype, width, recv_cap, g=g)
    if backend == "pallas" and not supported:
        raise ValueError(
            f"{knob}='pallas' with hashgrid_kernel='candidates' but this "
            "configuration is outside the candidate sweep's envelope "
            f"(needs 2-D f32, candidate width in [1, {MAX_WIDTH}], a "
            "receiver cap >= 1 and g >= 3)"
        )
    return supported and (backend == "pallas" or on_cuda)


def _check(pos, cand, recv):
    if pos.dtype != torch.float32:
        raise TypeError(f"candidate sweep takes float32 positions, got "
                        f"{pos.dtype}")
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError(f"candidate sweep takes [N, 2] positions, got "
                         f"{tuple(pos.shape)}")
    if (cand.dtype != torch.int32 or recv.dtype != torch.int32
            or cand.ndim != 2 or recv.ndim != 2
            or cand.shape[0] != recv.shape[0]):
        raise ValueError("candidate sweep takes int32 tables cand [C, W] and "
                         "recv [C, RK] with one row per cell")
    if cand.device != pos.device or recv.device != pos.device:
        raise ValueError("candidate sweep: tensors lie on different devices")
    if not (pos.is_contiguous() and cand.is_contiguous()
            and recv.is_contiguous()):
        raise ValueError("candidate sweep takes contiguous tensors")


def candidate_sweep_cuda(pos, cand, recv, k_sep, personal_space, eps, hw):
    """Launch the CUDA kernel on ``pos`` [N, 2] f32 and the plan's tables
    ``cand`` [C, W], ``recv`` [C, RK] int32 (each row a valid prefix
    padded with N), contiguous on one CUDA device.  Returns the force
    [N, 2] without waiting."""
    global LAUNCHES, _captured
    if pos.device.type != "cuda":
        raise ValueError(
            f"candidate_sweep_cuda needs CUDA tensors, got {pos.device}")
    _check(pos, cand, recv)
    n = pos.shape[0]
    cells, w = cand.shape
    rk = recv.shape[1]
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"candidate width {w} outside [1, {MAX_WIDTH}]")
    if 2 * n >= 2**31 or cells * max(w, rk) >= 2**31:
        raise ValueError("candidate sweep: indices overflow int32")
    out = torch.zeros_like(pos)
    if n == 0 or cells == 0 or rk == 0:
        return out
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = _kernel()(
        pos.data_ptr(), cand.data_ptr(), recv.data_ptr(), out.data_ptr(),
        n, cells, w, rk, cells_per_warp(w), float(k_sep),
        _cut2(float(personal_space)), float(eps), float(hw),
        pos.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"candidate sweep kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        LAUNCHES += 1
    return out


def candidate_sweep_plain(pos, cand, recv, k_sep, personal_space, eps, hw,
                          absolute=False):
    """The kernel's function in plain PyTorch, on any device.  With
    ``absolute``, ``sum |term|`` per receiver and axis (the scale of the
    band the kernel is held to)."""
    n = pos.shape[0]
    rk = recv.shape[1]
    agents = recv.reshape(-1)
    cells = torch.arange(recv.shape[0], device=pos.device).repeat_interleave(
        rk)
    valid = agents < n
    agents, cells = agents[valid], cells[valid]
    f = _neighbors.union_sweep_rows(pos, agents, cand[cells], k_sep,
                                    personal_space, eps, hw,
                                    absolute=absolute, sequential=True)
    out = torch.zeros_like(pos)
    out[agents.long()] = f
    return out


def candidate_sweep(pos, k_sep, personal_space, eps, plan):
    """The tick's candidate sweep off ``plan`` (which must carry ``cand``,
    ``recv`` and the CSR tables, as ``build_tick_plan`` builds them for
    ``hashgrid_kernel="candidates"``): the plain version on a CPU tensor,
    the kernel on a CUDA tensor."""
    if pos.ndim != 2 or pos.shape[1] != 2:
        raise ValueError(f"candidate sweep is 2-D only (pos shape "
                         f"{tuple(pos.shape)})")
    if not (plan.has_list and plan.has_recv and plan.has_csr):
        raise ValueError(
            "candidate_sweep needs a plan carrying cand, recv and the CSR "
            "occupancy (physics.build_tick_plan with hashgrid_kernel="
            "'candidates', or build_hashgrid_plan with neighbor_cap and "
            "recv_cap)"
        )
    if plan.cell_eff < personal_space + plan.skin:
        raise ValueError(
            f"plan cell_eff={plan.cell_eff:.4g} cannot cover personal_space="
            f"{personal_space} + skin={plan.skin}"
        )
    if pos.device.type == "cpu":
        return candidate_sweep_plain(pos, plan.cand, plan.recv, k_sep,
                                     personal_space, eps, plan.torus_hw)
    return candidate_sweep_cuda(pos, plan.cand, plan.recv, k_sep,
                                personal_space, eps, plan.torus_hw)
