"""NSGA-II's non-dominated ranks: kernel N1 and its plain version.

The JAX package ranks by peeling fronts in a ``lax.while_loop``
(``ops/nsga2.py:nondominated_ranks``, the loop at ``:113``), whose trip
count (the number of fronts) only the device knows.  No ``pallas_call``
lies on it; this module is its counterpart on the card:

- :func:`nsga2_ranks_cuda` launches ``csrc/nsga2_ranks.cu`` (the domination
  packed into bits, then one block that peels every front, each thread's
  column of bits in registers up to P = 1,024) on CUDA tensors and raises
  on anything else: a generation reads nothing back, and a CUDA graph can
  capture the call;
- :func:`nsga2_ranks_plain` is the JAX loop in plain PyTorch, one masked
  reduction over the [P, P] domination matrix a front, its flag read on the
  host each round;
- :func:`domination_matrix` is the comparison both make.

Both return the same ranks exactly: the function is comparisons only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import family

# Launches of the CUDA kernel (one a call: the pack and the peel) since the
# count was last set to 0.  Only nsga2_ranks_cuda adds to it; a launch while
# the stream captures a CUDA graph adds to _captured instead, and each replay
# adds what its capture recorded (ops/nsga2.nsga2_run).
LAUNCHES = 0
_captured = 0

_fn = None   # the C entry, bound at the first launch


def _kernel():
    global _fn
    if _fn is None:
        _fn = family.bind("nsga2_ranks", "dsa_nsga2_ranks_f32", 5,
                          [ctypes.c_int, ctypes.c_int, ctypes.c_float])
    return _fn


def domination_matrix(
    objs: torch.Tensor,
    viol: Optional[torch.Tensor] = None,
    feas_tol: float = 1e-4,
) -> torch.Tensor:
    """[P, P] bool: ``dom[i, j]`` = i dominates j (minimization).

    Unconstrained: every objective ``<=``, at least one ``<``.  With
    ``viol`` ([P] total constraint violations) Deb's constrained
    domination: a feasible point (``viol <= feas_tol``) dominates every
    infeasible one, the smaller violation decides between infeasible
    points, Pareto domination between feasible ones."""
    a = objs[:, None, :]
    b = objs[None, :, :]
    pareto = (a <= b).all(-1) & (a < b).any(-1)
    if viol is None:
        return pareto
    feas = viol <= feas_tol
    fi, fj = feas[:, None], feas[None, :]
    less_viol = viol[:, None] < viol[None, :]
    return (fi & ~fj) | (~fi & ~fj & less_viol) | (fi & fj & pareto)


def nsga2_ranks_plain(
    objs: torch.Tensor,
    viol: Optional[torch.Tensor],
    feas_tol: float,
) -> torch.Tensor:
    """[P] int32 front index (0 = the Pareto front): the JAX loop, one
    front a round until every point has its rank (the flag read on the
    host, so a CPU tensor's path)."""
    dom = domination_matrix(objs, viol, feas_tol)
    rank = torch.full((objs.shape[0],), -1, dtype=torch.int32,
                      device=objs.device)
    front = 0
    while bool((rank < 0).any()):
        unassigned = rank < 0
        dominated = (dom & unassigned[:, None]).any(0)
        rank = torch.where(unassigned & ~dominated,
                           torch.full_like(rank, front), rank)
        front += 1
    return rank


def nsga2_ranks_cuda(
    objs: torch.Tensor,
    viol: Optional[torch.Tensor],
    feas_tol: float,
    fronts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch N1 on ``objs`` [P, M] float32 and ``viol`` [P] float32 (or
    None: unconstrained) on one CUDA device.  Returns ``rank`` [P] int32
    without waiting for the card; ``fronts`` ([1] int32 on that device), if
    given, receives the number of fronts."""
    global LAUNCHES, _captured
    if objs.ndim != 2 or objs.dtype != torch.float32:
        raise ValueError(f"nsga2_ranks_cuda takes [P, M] float32 objectives, "
                         f"got {tuple(objs.shape)} {objs.dtype}")
    p, m = objs.shape
    if fronts is None:
        fronts = torch.empty((1,), dtype=torch.int32, device=objs.device)
    objs = objs.contiguous()    # the kernel reads [P, M] as it is given
    family.check_operands("nsga2_ranks_cuda", fronts, 1, objs,
                          {"viol": (viol, (p,))})
    p_pad = -(-p // 32) * 32
    bits = torch.empty((p_pad // 32) * p_pad, dtype=torch.int32,
                       device=objs.device)
    rank = torch.empty((p,), dtype=torch.int32, device=objs.device)
    err = _kernel()(objs.data_ptr(), family.ptr(viol), rank.data_ptr(),
                    fronts.data_ptr(), bits.data_ptr(), p, m,
                    float(feas_tol), *family.stream_args(objs))
    family.check_launch(err, "nsga2_ranks")
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        LAUNCHES += 1
    return rank
