"""The CUDA separation kernel against its plain PyTorch version.

Tests marked ``cuda`` need an NVIDIA GPU, nvcc and the toolkit; they skip
without one.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it also runs where only PyTorch is installed.

Tolerance of the kernel against the plain version: both compute each
pair's squared distance identically (no fused multiply-add, axis order),
so the cut at the personal space falls the same way; the force terms may
differ by a few ulps (the kernel fuses the accumulate) and are summed in
another order.  Both differences are bounded by a small multiple of
``sum_j |term_ij|``, so the band is ``|kernel - plain| <= 1e-5 * that sum
+ 1e-6``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    separation as port_sep,
)

REPO = Path(__file__).resolve().parent.parent
K_SEP, R, EPS = 20.0, 2.0, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _swarm(n, d, seed, box, dead=0.2, co_locate=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-box, box, (n, d)).astype(np.float32)
    if co_locate:
        pos[1] = pos[0]
        pos[2] = pos[0]
    alive = rng.random(n) >= dead
    alive[:3] = True
    return torch.from_numpy(pos), torch.from_numpy(alive)


def test_import_builds_nothing():
    # The module imports on a machine without nvcc or a GPU; the kernel is
    # built at its first launch only.
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda."
            "separation as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_wrapper_rejects_cpu_tensors():
    pos, alive = _swarm(16, 2, 0, 3.0)
    before = port_sep.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_sep.separation_cuda(pos, alive, K_SEP, R, EPS)
    assert port_sep.LAUNCHES == before


def test_abs_sum_bounds_the_force():
    pos, alive = _swarm(200, 2, 1, 4.0)
    f = port_sep.separation_plain(pos, alive, K_SEP, R, EPS)
    s = port_sep.separation_abs_sum(pos, alive, K_SEP, R, EPS)
    assert (f.abs() <= s * (1 + 1e-6)).all() and (s > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,box,co_locate",
    [(300, 2, 5.0, True), (4096, 3, 20.0, False), (1000, 2, 10.0, False),
     (129, 2, 2.0, False)],
    ids=["300-2d-colocated", "4096-3d", "1000-2d", "129-2d-crowded"],
)
def test_kernel_matches_plain(cuda, n, d, box, co_locate):
    pos, alive = _swarm(n, d, n, box, co_locate=co_locate)
    pos, alive = pos.to(cuda), alive.to(cuda)
    before = port_sep.LAUNCHES
    got = port_sep.separation_cuda(pos, alive, K_SEP, R, EPS)
    torch.cuda.synchronize()
    assert port_sep.LAUNCHES == before + 1
    want = port_sep.separation_plain(pos, alive, K_SEP, R, EPS)
    scale = port_sep.separation_abs_sum(pos, alive, K_SEP, R, EPS)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
    assert (got[~alive] == 0).all()
    if co_locate:
        assert torch.equal(got[1], got[0]) and torch.equal(got[2], got[0])


@pytest.mark.cuda
def test_kernel_input_checks(cuda):
    pos, alive = _swarm(64, 2, 2, 3.0)
    pos, alive = pos.to(cuda), alive.to(cuda)
    with pytest.raises(TypeError):
        port_sep.separation_cuda(pos.double(), alive, K_SEP, R, EPS)
    with pytest.raises(ValueError):
        port_sep.separation_cuda(torch.zeros(64, 4, device=cuda), alive,
                                 K_SEP, R, EPS)
    with pytest.raises(ValueError):
        port_sep.separation_cuda(pos, alive[:10], K_SEP, R, EPS)
    with pytest.raises(ValueError):
        port_sep.separation_cuda(pos.t().contiguous().t(), alive, K_SEP, R,
                                 EPS)
    u8 = port_sep.separation_cuda(pos, alive.to(torch.uint8), K_SEP, R, EPS)
    b = port_sep.separation(pos, alive, K_SEP, R, EPS)
    assert torch.equal(u8, b)
    before = port_sep.LAUNCHES
    empty = port_sep.separation_cuda(pos[:0], alive[:0], K_SEP, R, EPS)
    assert empty.shape == (0, 2) and port_sep.LAUNCHES == before


@pytest.mark.cuda
def test_tick_on_the_card_matches_the_cpu(cuda):
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="pallas")
    cpu = tdsa.make_swarm(256, n_tasks=0, device="cpu", spread=12.0, seed=4)
    cpu = tdsa.with_tasks(cpu, [[1.0, 1.0], [-2.0, 3.0]])
    cpu = cpu.replace(target=torch.full_like(cpu.pos, 30.0),
                      has_target=torch.ones_like(cpu.has_target))
    gpu = tdsa.state_from_numpy(tdsa.state_to_numpy(cpu), device=cuda)
    jitter = torch.from_numpy(
        np.random.default_rng(0).integers(0, 3, (50, 256)).astype(np.int32)
    )
    before = port_sep.LAUNCHES
    cpu = tdsa.swarm_rollout(cpu, None, cfg, 50, jitter=jitter)
    gpu = tdsa.swarm_rollout(gpu, None, cfg, 50, jitter=jitter.to(cuda))
    assert port_sep.LAUNCHES == before + 50
    a, b = tdsa.state_to_numpy(cpu), tdsa.state_to_numpy(gpu)
    for f in a:
        if a[f].dtype.kind in "biu":
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    assert np.isfinite(b["pos"]).all()
