"""Fused PSO iterations: ``k_steps`` steps of the whole swarm in one pass.

Replaces the TPU kernel ``ops/pallas/pso_fused.py:fused_pso_step_t`` of the
JAX package and carries what the other fused families share with it: the
transposed objective registry, the in-kernel random generator and the block
loop.

- :func:`fused_pso_step_cuda` launches the hand-written CUDA kernel
  ``csrc/pso_fused.cu`` (built on first use by ``_build.py``) on CUDA
  tensors and raises on anything else;
- :func:`fused_pso_step_plain` is the plain PyTorch version: the same
  arithmetic in the same order (sums over ``d`` row by row, no fused
  multiply-add) and the same Philox draws, on any device;
- :func:`fused_pso_step_t` is the entry: the plain version for CPU tensors,
  the kernel for CUDA tensors.  A kernel that fails to build or launch
  raises; nothing falls back.

Layout: particles lie on the fast axis, arrays are ``[D, N]`` (transposed
from the portable ``[N, D]``), as in the JAX package, so neighbouring
threads read neighbouring addresses at each ``d``.

Random numbers: ``rng="device"`` draws two uniforms per element and step
from Philox4x32-10 keyed by ``seed``, with the counter (lane, block of four
dimensions, global step index, stream).  No launch geometry enters, so the
kernel and the plain version draw the same numbers.  They are not the TPU's
numbers: ``rng="host"`` takes ``r1``/``r2`` as operands (one step per
call), which is how tests feed both packages the same draws.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .._numerics import div as _div
from ..pso import C1, C2, W, PSOState
from . import _build
from .common import ceil_to, cyclic_pad_rows

# Launches of the CUDA kernel through fused_pso_step_cuda since the count
# was last set to 0, one per launch.
LAUNCHES = 0

_fn = None   # the C entry, bound at the first launch

# Shared memory one block may take on sm_90, and the block sizes the kernel
# picks from (csrc/pso_fused.cu: pick_block).
MAX_SHARED_BYTES = 227 * 1024
_BLOCKS = (128, 64, 32)


# --------------------------------------------------------------------------
# Objectives in transposed [D, n] layout: f(x[D, n]) -> fit[1, n].
# The plain versions of csrc/swarm_objectives.cuh, op for op: every sum
# over d runs row by row, every division is a true division, powers are
# products.  They match the JAX package's OBJECTIVES_T to a few ulps.
# --------------------------------------------------------------------------

_TWO_PI = 2.0 * math.pi
_INV_TWO_PI = 1.0 / _TWO_PI

# Degree-7 polynomial in f^2 for cos(2 pi f), f in [-0.5, 0.5]: the one the
# TPU kernel evaluates (max error 5.7e-7 through a float32 Horner).
_COS2PI_COEFS = (
    -1.4609579972486311, 7.8066162731190429, -26.406763442656118,
    60.242465057957851, -85.456685407770465, 64.939390114297879,
    -19.739208758219114, 0.99999999991936284,
)


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """[K, n] -> [1, n], the rows added one by one in order (the order of
    the kernel's per-thread loop; ``torch.sum`` adds in another)."""
    if t.shape[0] == 0:
        return torch.zeros((1,) + t.shape[1:], dtype=t.dtype,
                           device=t.device)
    acc = t[0:1]
    for j in range(1, t.shape[0]):
        acc = acc + t[j:j + 1]
    return acc


def _cos2pi(t):
    """cos(2*pi*t): single-round range reduction + even polynomial."""
    f = t - torch.round(t)
    z = f * f
    p = torch.full_like(z, _COS2PI_COEFS[0])
    for a in _COS2PI_COEFS[1:]:
        p = p * z + a
    return p


def _sin2pi(t):
    """sin(2*pi*t) = cos(2*pi*(t - 1/4))."""
    return _cos2pi(t - 0.25)


def _cosx(u):
    """cos(u) for radian arguments up to a few hundred (the phase error
    grows as |u| * 6e-8)."""
    return _cos2pi(u * _INV_TWO_PI)


def _sinx(u):
    """sin(u) for radian arguments."""
    return _cos2pi(u * _INV_TWO_PI - 0.25)


def _iota_1based(x):
    """[d, 1] column 1..d in ``x``'s dtype."""
    return torch.arange(1, x.shape[0] + 1, dtype=x.dtype,
                        device=x.device)[:, None]


def _sphere_t(x):
    return _sum_rows(x * x)


def _rastrigin_t(x):
    d = x.shape[0]
    return 10.0 * d + _sum_rows(x * x - 10.0 * _cos2pi(x))


def _ackley_t(x):
    d = x.shape[0]
    s1 = _div(_sum_rows(x * x), d)
    s2 = _div(_sum_rows(_cos2pi(x)), d)
    return -20.0 * torch.exp(-0.2 * torch.sqrt(s1)) - torch.exp(s2) \
        + 20.0 + math.e


def _rosenbrock_t(x):
    lo = x[:-1, :]
    a = x[1:, :] - lo * lo
    b = 1.0 - lo
    return _sum_rows(100.0 * a * a + b * b)


def _griewank_t(x):
    d = x.shape[0]
    c = _cosx(x / torch.sqrt(_iota_1based(x)))
    p = c[0:1, :]
    for j in range(1, d):
        p = p * c[j:j + 1, :]
    return _div(_sum_rows(x * x), 4000.0) - p + 1.0


def _schwefel_t(x):
    d = x.shape[0]
    return 418.9829 * d - _sum_rows(x * _sinx(torch.sqrt(torch.abs(x))))


def _sq(t):
    return t * t


def _levy_t(x):
    w = 1.0 + _div(x - 1.0, 4.0)
    head = _sq(_sin2pi(w[0:1, :] * 0.5))          # sin(pi*w)^2
    wi = w[:-1, :]
    mid = _sum_rows(
        _sq(wi - 1.0) * (1.0 + 10.0 * _sq(_sinx(math.pi * wi + 1.0)))
    )
    wd = w[-1:, :]
    tail = _sq(wd - 1.0) * (1.0 + _sq(_sin2pi(wd)))
    return head + mid + tail


def _zakharov_t(x):
    i = _iota_1based(x)
    s1 = _sum_rows(x * x)
    s2 = _sum_rows(0.5 * i * x)
    s2_2 = s2 * s2
    return s1 + s2_2 + s2_2 * s2_2


def _styblinski_tang_t(x):
    d = x.shape[0]
    return (
        0.5 * _sum_rows(_sq(x * x) - 16.0 * x * x + 5.0 * x)
        + 39.16616570377142 * d
    )


def _michalewicz_t(x):
    # The registry's shifted form: the symmetric search domain
    # [-pi/2, pi/2] maps onto the canonical [0, pi].
    x = x + math.pi / 2.0
    i = _iota_1based(x)
    p4 = _sq(_sq(_sinx(_div(i * x * x, math.pi))))
    p20 = p4 * _sq(_sq(p4))                        # s^4 * s^16
    return -_sum_rows(_sinx(x) * p20)


OBJECTIVES_T: Dict[str, Callable] = {
    "sphere": _sphere_t,
    "rastrigin": _rastrigin_t,
    "ackley": _ackley_t,
    "rosenbrock": _rosenbrock_t,
    "griewank": _griewank_t,
    "schwefel": _schwefel_t,
    "levy": _levy_t,
    "zakharov": _zakharov_t,
    "styblinski_tang": _styblinski_tang_t,
    "michalewicz": _michalewicz_t,
}

# The kernel's objective numbers (csrc/swarm_objectives.cuh: Objective).
OBJECTIVE_IDS = {name: i for i, name in enumerate(OBJECTIVES_T)}

# Past this dimension michalewicz's poly-trig phase i*x*x/pi outgrows the
# single-round range reduction (see _cosx): at D=100 the added error is
# ~2e-6, by D=300 the phase hits ~471 rad and the reduction loses ~3e-5.
MICHALEWICZ_DIM_MAX = 100


def kernel_block(dim: int) -> int:
    """Threads per block the kernel uses for ``dim``: the largest of 128,
    64 and 32 whose ``[3][D][block]`` f32 tile fits the shared memory a
    block may take, or 0 when none does (D > 605)."""
    for block in _BLOCKS:
        if 3 * dim * block * 4 <= MAX_SHARED_BYTES:
            return block
    return 0


def pallas_supported(objective_name: str, dtype, dim=None) -> bool:
    """True if the fused kernels cover this config (else use the portable
    path).  The name is the JAX package's; on this port it gates the CUDA
    kernel: a named objective, float32, michalewicz within its poly-trig
    phase bound, and a dimension whose tile fits a block's shared memory
    (:func:`kernel_block`).  ``dim=None`` skips the checks on it."""
    if objective_name not in OBJECTIVES_T:
        return False
    if dtype != torch.float32:
        return False
    if dim is None:
        return True
    if objective_name == "michalewicz" and dim > MICHALEWICZ_DIM_MAX:
        return False
    return kernel_block(dim) > 0


# --------------------------------------------------------------------------
# Philox4x32-10 in integer tensor arithmetic: the plain version of
# csrc/philox.cuh.  Words are int64 tensors holding values in [0, 2^32).
# --------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant and a
    tensor of 32-bit values, through 16-bit limbs so that no int64
    product overflows."""
    t0 = a * (b & 0xFFFF)
    t1 = a * (b >> 16)
    lo_sum = ((t1 & 0xFFFF) << 16) + (t0 & _MASK32)
    return (t1 >> 16) + (t0 >> 32) + (lo_sum >> 32), lo_sum & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10 for counter ``(c0..c3)`` and
    key ``(k0, k1)``: int64 tensors (or ints) in [0, 2^32), broadcast
    together."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_uniforms(seed: torch.Tensor, n: int, dim: int, step: int,
                    stream: int) -> torch.Tensor:
    """[dim, n] f32 uniforms in [0, 1) of one step and stream (0: r1,
    1: r2), the numbers the kernel draws: element (d, lane) is word
    ``d % 4`` of the call with counter (lane, d // 4, step, stream) and key
    (seed, 0), its top 23 bits made the mantissa of a float in [1, 2),
    minus 1."""
    dev = seed.device
    lanes = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    groups = torch.arange(ceil_to(dim, 4) // 4, dtype=torch.int64,
                          device=dev)[:, None]
    zeros = torch.zeros((groups.shape[0], n), dtype=torch.int64, device=dev)
    words = philox4x32_10(
        lanes + zeros, groups + zeros, zeros + (step & _MASK32),
        zeros + stream, seed.reshape(()).to(torch.int64) & _MASK32, 0,
    )
    bits = torch.stack(words, dim=1).reshape(-1, n)[:dim]
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mantissa.view(torch.float32) - 1.0


# --------------------------------------------------------------------------
# The step: plain version, kernel wrapper, entry
# --------------------------------------------------------------------------


def pso_steps_plain(seed, g, pos, vel, bpos, bfit, r1, r2, objective_name,
                    w, c1, c2, half_width, vmax_frac, k_steps, step0):
    """``k_steps`` iterations on ``[D, N]`` arrays with the attractor ``g``
    ([D, 1], or [D, N] with each lane's own column) held fixed: the body
    the swarm and the island versions share.  ``r1 is None`` draws from
    Philox."""
    objective_t = OBJECTIVES_T[objective_name]
    d, n = pos.shape
    vmax = half_width * vmax_frac
    for step in range(k_steps):
        if r1 is None:
            rr1 = philox_uniforms(seed, n, d, step0 + step, 0)
            rr2 = philox_uniforms(seed, n, d, step0 + step, 1)
        else:
            rr1, rr2 = r1, r2
        vel = w * vel + c1 * rr1 * (bpos - pos) + c2 * rr2 * (g - pos)
        vel = torch.clamp(vel, -vmax, vmax)
        pos = torch.clamp(pos + vel, -half_width, half_width)
        fit = objective_t(pos)                      # [1, N]
        improved = fit < bfit
        bfit = torch.where(improved, fit, bfit)
        bpos = torch.where(improved, pos, bpos)
    return pos, vel, bpos, bfit


def check_rng(rng, r1, r2, k_steps):
    if rng not in ("device", "host"):
        raise ValueError(f'rng must be "device" or "host", got {rng!r}')
    if rng == "host" and (r1 is None or r2 is None):
        raise ValueError('rng="host" requires r1 and r2')
    if rng == "host" and k_steps != 1:
        raise ValueError('rng="host" supports k_steps=1 only')
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")


def best_of_block(bfit_t: torch.Tensor, bpos_t: torch.Tensor):
    """Block-level gbest candidate from the pbest arrays: one argmin over
    ``bfit_t [1, N]`` (the first of equal minima) and a column gather from
    ``bpos_t [D, N]``, without a read from the device."""
    j = torch.argmin(bfit_t[0]).reshape(1)
    return (bfit_t[0].index_select(0, j)[0],
            bpos_t.index_select(1, j)[:, 0])


def fused_pso_step_plain(
    seed, gbest_pos, pos, vel, bpos, bfit, r1=None, r2=None, *,
    objective_name: str, w: float = W, c1: float = C1, c2: float = C2,
    half_width: float = 5.12, vmax_frac: float = 0.5, rng: str = "device",
    k_steps: int = 1, track_best: bool = True, step0: int = 0,
):
    """The plain PyTorch version of :func:`fused_pso_step_cuda`, on any
    device; same arguments and results."""
    check_rng(rng, r1, r2, k_steps)
    if rng == "device":
        r1 = r2 = None
    out = pso_steps_plain(seed, gbest_pos, pos, vel, bpos, bfit, r1, r2,
                          objective_name, w, c1, c2, half_width, vmax_frac,
                          k_steps, step0)
    if not track_best:
        return out
    fit, best = best_of_block(out[3], out[2])
    return out + (fit.reshape(1, 1), best[:, None])


def _kernel():
    global _fn
    if _fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = _build.load("pso_fused").dsa_pso_fused_f32
        fn.argtypes = [p] * 14 + [i, i, i, ctypes.c_uint, i,
                                  f, f, f, f, f, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_step_operands(name, seed, g_shape, gbest, pos, vel, bpos, bfit,
                        r1, r2):
    """What both kernel wrappers require of their tensors: float32,
    contiguous, on one CUDA device, of the shapes the kernel indexes."""
    if pos.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {pos.device}")
    if pos.ndim != 2:
        raise ValueError(f"{name} takes [D, N] arrays, got "
                         f"{tuple(pos.shape)}")
    d, n = pos.shape
    want = {"gbest": (gbest, g_shape), "pos": (pos, (d, n)),
            "vel": (vel, (d, n)), "bpos": (bpos, (d, n)),
            "bfit": (bfit, (1, n))}
    if r1 is not None:
        want.update(r1=(r1, (d, n)), r2=(r2, (d, n)))
    for label, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got "
                            f"{t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name}: {label} lies on {t.device}, pos on "
                             f"{pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or seed.device != pos.device):
        raise ValueError(f"{name}: seed must be one int32 on {pos.device}")
    if not 0 < n < 2**31 or d * n >= 2**40:
        raise ValueError(f"{name}: N = {n}, D = {d} is out of range")
    if kernel_block(d) == 0:
        raise ValueError(
            f"{name}: D = {d} is outside the kernel's envelope (a "
            f"[3][D][32] f32 tile must fit {MAX_SHARED_BYTES} bytes of "
            "shared memory)"
        )


def fused_pso_step_cuda(
    seed, gbest_pos, pos, vel, bpos, bfit, r1=None, r2=None, *,
    objective_name: str, w: float = W, c1: float = C1, c2: float = C2,
    half_width: float = 5.12, vmax_frac: float = 0.5, rng: str = "device",
    k_steps: int = 1, track_best: bool = True, step0: int = 0,
):
    """Launch the CUDA kernel: ``k_steps`` fused PSO iterations on
    ``pos``/``vel``/``bpos`` [D, N] and ``bfit`` [1, N] (f32, contiguous,
    one CUDA device) toward ``gbest_pos`` [D, 1], held fixed over the
    launch.  ``seed`` is one int32 on the device; ``step0`` is the global
    index of the launch's first step (the generator's counter).  Returns
    new tensors, without waiting for the kernel:
    ``(pos, vel, bpos, bfit)`` and, with ``track_best``, the swarm's best
    pbest after the launch, ``best_fit [1, 1]`` and ``best_pos [D, 1]``
    (each block writes its candidate, the first of equal minima wins)."""
    global LAUNCHES
    check_rng(rng, r1, r2, k_steps)
    if rng == "device":
        r1 = r2 = None
    d, n = pos.shape if pos.ndim == 2 else (0, 0)
    check_step_operands("fused_pso_step_cuda", seed, (d, 1), gbest_pos,
                        pos, vel, bpos, bfit, r1, r2)
    outs = [torch.empty_like(t) for t in (pos, vel, bpos, bfit)]
    block_fit = block_lane = None
    if track_best:
        blocks = -(-n // kernel_block(d))
        block_fit = torch.empty(blocks, dtype=torch.float32,
                                device=pos.device)
        block_lane = torch.empty(blocks, dtype=torch.int32,
                                 device=pos.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _kernel()(
        seed.data_ptr(), gbest_pos.data_ptr(), pos.data_ptr(),
        vel.data_ptr(), bpos.data_ptr(), bfit.data_ptr(), ptr(r1), ptr(r2),
        *(t.data_ptr() for t in outs), ptr(block_fit), ptr(block_lane),
        n, d, int(k_steps), int(step0) & _MASK32,
        OBJECTIVE_IDS[objective_name], float(w), float(c1), float(c2),
        float(half_width * vmax_frac), float(half_width),
        pos.device.index, torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused PSO kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if not track_best:
        return tuple(outs)
    j = torch.argmin(block_fit).reshape(1)
    lane = block_lane.index_select(0, j).long()
    return tuple(outs) + (block_fit.index_select(0, j).reshape(1, 1),
                          outs[2].index_select(1, lane))


def fused_pso_step_t(seed, gbest_pos, pos, vel, bpos, bfit, r1=None,
                     r2=None, **kw) -> Tuple[torch.Tensor, ...]:
    """``k_steps`` fused PSO iterations in transposed layout, one pass over
    memory: the plain version on CPU tensors, the CUDA kernel on CUDA
    tensors (see :func:`fused_pso_step_cuda` for arguments and results).
    gbest is constant within the block (delayed-gbest PSO)."""
    step = (fused_pso_step_plain if pos.device.type == "cpu"
            else fused_pso_step_cuda)
    return step(seed, gbest_pos, pos, vel, bpos, bfit, r1, r2, **kw)


# --------------------------------------------------------------------------
# Shared plumbing of the fused runs: fused_pso_run here, the island run
# and the memetic composition.
# --------------------------------------------------------------------------


def prep_padded_t(state: PSOState, n_pad: int):
    """State -> transposed f32 arrays ``(pos_t, vel_t, bpos_t, bfit_t)`` of
    lane width ``n_pad``.  Padding duplicates leading particles cyclically
    (common.cyclic_pad_rows), which preserves the swarm optimum."""
    return (
        cyclic_pad_rows(state.pos, n_pad).T.contiguous(),
        cyclic_pad_rows(state.vel, n_pad).T.contiguous(),
        cyclic_pad_rows(state.pbest_pos, n_pad).T.contiguous(),
        cyclic_pad_rows(state.pbest_fit, n_pad)[None, :].contiguous(),
    )


def padded_width(n: int, tile_n: Optional[int]) -> int:
    """Lane width the fused runs use: ``n`` itself with ``tile_n=None``
    (the kernel masks its ragged edge), else ``n`` rounded up to the tile
    as the JAX package rounds it."""
    if tile_n is None:
        return n
    return ceil_to(n, min(tile_n, ceil_to(n, 128)))


def seed_base(gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """[1] i32 seed for the in-kernel generator, drawn on the device from
    the state's generator (no read from the device)."""
    return torch.randint(0, 2**31 - 1, (1,), generator=gen,
                         dtype=torch.int32, device=device)


def host_uniforms(gen: torch.Generator, shape, device):
    """(r1, r2) for rng="host" mode when the caller injects none."""
    return (torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device),
            torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device))


def run_blocks(block, carry, n_steps: int, steps_per_kernel: int):
    """Run ``block(carry, call_i, k) -> carry`` over the full k-step
    blocks, then once more for the remainder."""
    n_blocks, rem = divmod(n_steps, steps_per_kernel)
    for i in range(n_blocks):
        carry = block(carry, i, steps_per_kernel)
    if rem:
        carry = block(carry, n_blocks, rem)
    return carry


def merge_best(cand_fit, cand_pos, gfit, gpos):
    """The running best after a candidate, selected on the device."""
    better = cand_fit < gfit
    return torch.where(better, cand_fit, gfit), torch.where(better, cand_pos,
                                                            gpos)


def rebuild_state(
    state: PSOState, pos_t, vel_t, bpos_t, bfit_t, gpos, gfit, n_steps: int
) -> PSOState:
    """Transposed padded arrays -> PSOState with the original n and
    dtypes."""
    n = state.pos.shape[0]
    dt = state.pos.dtype
    back = lambda x_t: x_t.T[:n].to(dt).contiguous()  # noqa: E731
    return PSOState(
        pos=back(pos_t),
        vel=back(vel_t),
        pbest_pos=back(bpos_t),
        pbest_fit=bfit_t[0, :n].to(state.pbest_fit.dtype),
        gbest_pos=gpos.to(state.gbest_pos.dtype),
        gbest_fit=gfit.to(state.gbest_fit.dtype),
        gen=state.gen,
        iteration=state.iteration + n_steps,
    )


def require_supported(objective_name: str, dtype, dim: int) -> None:
    """Raise unless the fused kernels cover this configuration: the fused
    runs do not fall back to the portable path."""
    if not pallas_supported(objective_name, dtype, dim):
        raise ValueError(
            f"the fused kernel does not cover objective {objective_name!r} "
            f"with {dtype} state at D = {dim}: it takes a named objective "
            f"of {sorted(OBJECTIVES_T)}, float32 state, D <= 605 "
            f"(michalewicz: D <= {MICHALEWICZ_DIM_MAX})"
        )


# --------------------------------------------------------------------------
# The run: PSOState in, PSOState out, the fast path beside ops/pso.pso_run
# --------------------------------------------------------------------------


def fused_pso_run(
    state: PSOState,
    objective_name: str,
    n_steps: int,
    w: float = W,
    c1: float = C1,
    c2: float = C2,
    half_width: float = 5.12,
    vmax_frac: float = 0.5,
    tile_n: Optional[int] = None,
    rng: str = "device",
    steps_per_kernel: int = 8,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> PSOState:
    """``n_steps`` fused iterations, with no read from the device.

    Transposes to the kernel's ``[D, N]`` layout once, runs blocks of
    ``steps_per_kernel`` iterations (memory traffic drops by that factor;
    gbest refreshes between blocks), transposes back: the same PSOState
    contract as ``ops.pso.pso_run`` (trajectories differ only in the
    random stream and the gbest refresh cadence).

    ``tile_n=None`` runs at the swarm's own width: the kernel masks its
    ragged edge.  An explicit ``tile_n`` pads the swarm to a multiple of it
    by duplicating leading particles, as the JAX package does for its lane
    tile; a duplicate draws other numbers and can supply gbest, so a test
    that compares with the JAX package's run passes the same ``tile_n``.

    ``rng="host"`` runs one step per launch with ``uniforms = (r1, r2)``,
    each ``[n_steps, D, n_pad]``, or with draws from ``state.gen``.
    """
    n, d = state.pos.shape
    require_supported(objective_name, state.pos.dtype, d)
    if rng == "host":
        steps_per_kernel = 1       # host mode feeds one r1/r2 pair per call
    elif uniforms is not None:
        raise ValueError('uniforms are operands of rng="host"')
    n_pad = padded_width(n, tile_n)
    dev = state.device
    pos_t, vel_t, bpos_t, bfit_t = prep_padded_t(state, n_pad)
    seed = seed_base(state.gen, dev)

    def block(carry, call_i, k):
        pos_t, vel_t, bpos_t, bfit_t, gpos, gfit = carry
        r1 = r2 = None
        if rng == "host":
            r1, r2 = ((uniforms[0][call_i], uniforms[1][call_i])
                      if uniforms is not None
                      else host_uniforms(state.gen, pos_t.shape, dev))
        pos_t, vel_t, bpos_t, bfit_t = fused_pso_step_t(
            seed, gpos[:, None], pos_t, vel_t, bpos_t, bfit_t, r1, r2,
            objective_name=objective_name, w=w, c1=c1, c2=c2,
            half_width=half_width, vmax_frac=vmax_frac, rng=rng, k_steps=k,
            track_best=False, step0=call_i * steps_per_kernel,
        )
        gfit, gpos = merge_best(*best_of_block(bfit_t, bpos_t), gfit, gpos)
        return (pos_t, vel_t, bpos_t, bfit_t, gpos, gfit)

    carry = run_blocks(
        block,
        (pos_t, vel_t, bpos_t, bfit_t,
         state.gbest_pos.to(torch.float32), state.gbest_fit.to(torch.float32)),
        n_steps, steps_per_kernel,
    )
    return rebuild_state(state, *carry, n_steps)
