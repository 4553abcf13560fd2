"""The CUDA separation kernels against their plain PyTorch versions.

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

The window kernel repeats its plain version (``ops/neighbors.py:
separation_window``) op for op with IEEE intrinsics and in the same order,
so its band is tighter: ``|kernel - plain| <= 1e-6 * sum|terms| + 1e-7``.
So does the candidate-sweep kernel (its plain version sums in row order).

The hashgrid slot kernel computes each term as its plain version does
(``rsqrtf`` is what ``torch.rsqrt`` runs on the card) but sums in another
order: ``1e-5 * sum|terms| + 1e-6``.  The whole slots path on the card (the
kernel, the rescue's scatter-add, whose order changes from run to run, and
the gather) against the same path on the CPU: ``1e-5 * sum|terms| + 1e-5``
over the dense torus pass's terms (the CPU's ``rsqrt`` rounds differently).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu_torch.state import AGENT_AXIS_FIELDS
from distributed_swarm_algorithm_tpu_torch.ops import neighbors as port_nb
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    separation as port_sep,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    window_separation as port_win,
)
from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as port_hp
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    candidate_sweep as port_cand,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    grid_separation as port_grid,
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


def _sorted_swarm(n, seed, box, dead=0.2, co_locate=False):
    pos, alive = _swarm(n, 2, seed, box, dead, co_locate)
    order = torch.sort(port_nb.morton_keys(pos, 2.0), stable=True).indices
    return pos[order].contiguous(), alive[order].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,window,box,presorted",
    [(300, 8, 5.0, True), (5000, 16, 40.0, False), (1000, 1, 10.0, True),
     (4096, 600, 20.0, True), (4096, 3000, 20.0, True)],
    ids=["300-w8", "5000-w16-unsorted", "1000-w1", "4096-w600-staged",
         "4096-w3000-global"],
)
def test_window_kernel_matches_plain(cuda, n, window, box, presorted):
    pos, alive = _sorted_swarm(n, n, box, co_locate=True)
    pos, alive = pos.to(cuda), alive.to(cuda)
    before = port_win.LAUNCHES
    got = port_win.separation_window(pos, alive, K_SEP, R, EPS, 2.0, window,
                                     presorted=presorted)
    torch.cuda.synchronize()
    assert port_win.LAUNCHES == before + 1
    want = port_nb.separation_window(pos, alive, K_SEP, R, EPS, 2.0, window,
                                     presorted=presorted)
    scale = port_nb.separation_window(pos, alive, K_SEP, R, EPS, 2.0, window,
                                      presorted=presorted, absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-6 * scale + 1e-7).all()
    assert (got[~alive] == 0).all()


@pytest.mark.cuda
def test_window_kernel_input_checks(cuda):
    pos, alive = _sorted_swarm(64, 2, 3.0)
    pos, alive = pos.to(cuda), alive.to(cuda)
    with pytest.raises(TypeError):
        port_win.separation_window_cuda(pos.double(), alive, K_SEP, R, EPS, 4)
    with pytest.raises(ValueError):
        port_win.separation_window_cuda(torch.zeros(64, 3, device=cuda),
                                        alive, K_SEP, R, EPS, 4)
    with pytest.raises(ValueError):
        port_win.separation_window_cuda(pos, alive[:10], K_SEP, R, EPS, 4)
    with pytest.raises(ValueError):
        port_win.separation_window_cuda(pos, alive, K_SEP, R, EPS, 0)
    with pytest.raises(ValueError):
        port_win.separation_window_cuda(pos.t().contiguous().t(), alive,
                                        K_SEP, R, EPS, 4)
    u8 = port_win.separation_window_cuda(pos, alive.to(torch.uint8), K_SEP,
                                         R, EPS, 4)
    b = port_win.separation_window_cuda(pos, alive, K_SEP, R, EPS, 4)
    assert torch.equal(u8, b)
    before = port_win.LAUNCHES
    empty = port_win.separation_window_cuda(pos[:0], alive[:0], K_SEP, R,
                                            EPS, 4)
    assert empty.shape == (0, 2) and port_win.LAUNCHES == before


@pytest.mark.cuda
def test_window_tick_on_the_card_matches_the_cpu(cuda):
    # Per-tick jitter equal for every agent: slot-order drift between the
    # two devices cannot change the election.
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="window", sort_every=8)
    cpu = tdsa.make_swarm(256, device="cpu", spread=12.0, seed=4)
    cpu = tdsa.with_tasks(cpu, [[1.0, 1.0], [-2.0, 3.0]])
    cpu = cpu.replace(target=torch.full_like(cpu.pos, 30.0),
                      has_target=torch.ones_like(cpu.has_target))
    gpu = tdsa.state_from_numpy(tdsa.state_to_numpy(cpu), device=cuda)
    jitter = torch.from_numpy(np.repeat(
        np.random.default_rng(0).integers(0, 3, (50, 1)), 256, 1
    ).astype(np.int32))
    before = port_win.LAUNCHES
    cpu = tdsa.swarm_rollout(cpu, None, cfg, 50, jitter=jitter)
    gpu = tdsa.swarm_rollout(gpu, None, cfg, 50, jitter=jitter.to(cuda))
    assert port_win.LAUNCHES == before + 50
    a, b = tdsa.state_to_numpy(cpu), tdsa.state_to_numpy(gpu)
    ia, ib = np.argsort(a["agent_id"]), np.argsort(b["agent_id"])
    for f in a:
        if a[f].dtype.kind in "biu" and f in AGENT_AXIS_FIELDS:
            np.testing.assert_array_equal(b[f][ib], a[f][ia], err_msg=f)
        elif a[f].dtype.kind in "biu":
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    assert np.isfinite(b["pos"]).all()


# --- the hashgrid kernels ----------------------------------------------------

HW = 16.0


def _hash_swarm(n, seed, crowd=0, dead=0.1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-HW, HW, (n, 2)).astype(np.float32)
    pos[:crowd] = (1.0 + 0.5 * rng.normal(size=(crowd, 2))).astype(np.float32)
    alive = rng.random(n) >= dead
    alive[:crowd] = True
    return torch.from_numpy(pos), torch.from_numpy(alive)


def _torus_abs_sum(pos, alive):
    """sum_j |term_ij| of the dense torus pass, [N, 2] (f64)."""
    d = pos.double()[:, None, :] - pos.double()[None, :, :]
    d = torch.remainder(d + HW, 2 * HW) - HW
    r = d.norm(dim=-1)
    near = ((r < R) & alive[:, None] & alive[None, :]
            & ~torch.eye(len(pos), dtype=torch.bool, device=pos.device))
    mag = K_SEP / r.clamp(min=EPS) ** 3
    return torch.where(near[..., None], mag[..., None] * d.abs(), 0.0).sum(1)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cell,cap,crowd,skin",
    [(2.0, 8, 0, 0.0), (1.0, 8, 0, 0.0), (2.0, 8, 40, 0.0),
     (1.5, 16, 0, 0.5)],
    ids=["R1", "R2", "R1-overflow", "stale-skinned"],
)
def test_grid_sweep_kernel_matches_plain(cuda, cell, cap, crowd, skin):
    pos, alive = _hash_swarm(600, 3, crowd)
    pos, alive = pos.to(cuda), alive.to(cuda)
    g = (int(2 * HW / (cell + skin)) // 16) * 16
    plan = port_hp.build_hashgrid_plan(pos, alive, HW, cell, cap, g=g,
                                       skin=skin)
    if skin:
        gen = torch.Generator(device=cuda).manual_seed(0)
        pos = pos + 0.34 * (torch.rand(pos.shape, generator=gen,
                                       device=cuda) - 0.5)
    r = port_grid._stencil_radius(plan.cell_eff, R + skin)
    x, y, slot = port_grid.slot_planes(pos, plan)
    args = (x, y, slot, g, cap, r, K_SEP, R, EPS, HW)
    before = port_grid.LAUNCHES
    fx, fy = port_grid.grid_sweep_cuda(*args)
    torch.cuda.synchronize()
    assert port_grid.LAUNCHES == before + 1
    px, py = port_grid.grid_sweep_plain(*args)
    sx, sy = port_grid.grid_sweep_plain(*args, absolute=True)
    for got, want, scale in ((fx, px, sx), (fy, py, sy)):
        assert torch.isfinite(got).all()
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
    assert (fx[x == port_grid.SENTINEL] == 0).all()
    assert (int(plan.cap_overflow) > 0) == bool(crowd)
    # The whole slots path, rescue included, against the CPU's.
    kw = dict(cell=cell + skin, max_per_cell=cap, torus_hw=HW,
              overflow_budget=64)
    got = port_grid.separation_hashgrid(pos, alive, K_SEP, R, EPS, plan=plan,
                                        **kw)
    cplan = port_hp.plan_from_numpy(port_hp.plan_to_numpy(plan), "cpu")
    want = port_grid.separation_hashgrid(pos.cpu(), alive.cpu(), K_SEP, R,
                                         EPS, plan=cplan, **kw)
    scale = _torus_abs_sum(pos, alive).cpu()
    assert ((got.cpu().double() - want.double()).abs()
            <= 1e-5 * scale + 1e-5).all()


@pytest.mark.cuda
def test_grid_sweep_kernel_input_checks(cuda):
    x = torch.zeros(16 * 16 * 8, device=cuda)
    slot = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        port_grid.grid_sweep_cuda(x.double(), x, slot, 16, 8, 1, K_SEP, R,
                                  EPS, HW)
    with pytest.raises(ValueError):
        port_grid.grid_sweep_cuda(x[:-1], x[:-1], slot, 16, 8, 1, K_SEP, R,
                                  EPS, HW)
    with pytest.raises(ValueError):
        port_grid.grid_sweep_cuda(x, x, slot.long(), 16, 8, 1, K_SEP, R, EPS,
                                  HW)
    with pytest.raises(ValueError):
        port_grid.grid_sweep_cuda(x, x, slot, 16, 8, 3, K_SEP, R, EPS, HW)


def _cand_plan(pos, alive, cap=24, skin=0.5, w=128, rk=48):
    g = int(2 * HW / (max(2.0, R) + skin))
    return port_hp.build_hashgrid_plan(pos, alive, HW, 2.0, cap, g=g,
                                       skin=skin, need_csr=True,
                                       neighbor_cap=w, recv_cap=rk)


def _check_candidates(pos, plan):
    before = port_cand.LAUNCHES
    got = port_cand.candidate_sweep_cuda(pos, plan.cand, plan.recv, K_SEP, R,
                                         EPS, HW)
    torch.cuda.synchronize()
    assert port_cand.LAUNCHES == before + 1
    want = port_cand.candidate_sweep_plain(pos, plan.cand, plan.recv, K_SEP,
                                           R, EPS, HW)
    scale = port_cand.candidate_sweep_plain(pos, plan.cand, plan.recv, K_SEP,
                                            R, EPS, HW, absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-6 * scale + 1e-7).all()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skin0", "stale", "partial-chain",
                                  "truncated"])
def test_candidate_kernel_matches_plain(cuda, case):
    pos, alive = _hash_swarm(800, 5, crowd=60 if case == "truncated" else 0)
    pos, alive = pos.to(cuda), alive.to(cuda)
    if case == "truncated":    # cand rows past W and receivers past RK
        plan = _cand_plan(pos, alive, cap=8, skin=0.0, w=32, rk=8)
        assert int(plan.cand_overflow) > 0 and int(plan.recv_overflow) > 0
    else:
        plan = _cand_plan(pos, alive, skin=0.0 if case == "skin0" else 0.5)
    gen = torch.Generator(device=cuda).manual_seed(1)
    if case == "stale":
        pos = pos + 0.4 * (torch.rand(pos.shape, generator=gen,
                                      device=cuda) - 0.5)
    got = _check_candidates(pos, plan)
    if case == "partial-chain":
        for _ in range(3):
            pos = pos + 0.45 * torch.randn(pos.shape, generator=gen,
                                           device=cuda)
            plan = port_hp.refresh_plan_partial(pos, alive, plan)
            got = _check_candidates(pos, plan)
        assert int(plan.cells_rebuilt) > 0
    assert (got[~alive] == 0).all()


@pytest.mark.cuda
def test_hashgrid_ticks_on_the_card_match_the_cpu(cuda):
    base = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", world_hw=24.0, formation_shape="none",
        max_speed=5.0, hashgrid_overflow_budget=64)
    cfgs = {
        "slots": base.replace(grid_max_per_cell=8),
        "candidates": base.replace(
            hashgrid_kernel="candidates", grid_max_per_cell=24,
            hashgrid_skin=1.5, hashgrid_neighbor_cap=48,
            hashgrid_partial_refresh=True),
    }
    for name, cfg in cfgs.items():
        cpu = tdsa.make_swarm(256, device="cpu", spread=18.0, seed=4)
        cpu = cpu.replace(target=torch.full_like(cpu.pos, 3.0),
                          has_target=torch.ones_like(cpu.has_target))
        gpu = tdsa.state_from_numpy(tdsa.state_to_numpy(cpu), device=cuda)
        jitter = torch.from_numpy(np.random.default_rng(0).integers(
            0, 3, (40, 256)).astype(np.int32))
        mod = port_grid if name == "slots" else port_cand
        before = mod.LAUNCHES
        cpu = tdsa.swarm_rollout(cpu, None, cfg, 40, jitter=jitter)
        gpu = tdsa.swarm_rollout(gpu, None, cfg, 40, jitter=jitter.to(cuda))
        assert mod.LAUNCHES == before + 40, name
        a, b = tdsa.state_to_numpy(cpu), tdsa.state_to_numpy(gpu)
        for f in a:
            if a[f].dtype.kind in "biu":
                np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        assert np.isfinite(b["pos"]).all()


@pytest.mark.cuda
def test_hashgrid_rollouts_wait_for_the_device_only_to_refresh_a_plan(cuda):
    # A per-tick plan (skin 0) never reads from the device; a carried
    # Verlet plan reads its refresh decision once per tick.
    import warnings

    from distributed_swarm_algorithm_tpu_torch.models.swarm import (
        _swarm_tick_plan,
    )

    base = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", world_hw=24.0, formation_shape="none",
        max_speed=5.0, hashgrid_overflow_budget=64, grid_max_per_cell=8)
    s = tdsa.make_swarm(512, device=cuda, spread=18.0, seed=4)
    s = s.replace(target=torch.full_like(s.pos, 3.0),
                  has_target=torch.ones_like(s.has_target))
    jitter = torch.zeros((6, 512), dtype=torch.int32, device=cuda)
    carried = base.replace(hashgrid_kernel="candidates", hashgrid_skin=1.5,
                           grid_max_per_cell=24, hashgrid_neighbor_cap=48,
                           hashgrid_partial_refresh=True)
    for cfg, ticks, syncs in ((base, 6, 0), (carried, 6, 6)):
        tdsa.swarm_rollout(s, None, cfg, 2, jitter=jitter[:2])   # warm up
        plan = tdsa.build_tick_plan(s, cfg) if syncs else None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                st = s
                for k in range(ticks):
                    if plan is None:
                        st = tdsa.swarm_tick(st, None, cfg, jitter[k])
                    else:
                        st, plan = _swarm_tick_plan(st, None, cfg, plan,
                                                    jitter[k])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert len(waits) == syncs, [str(w.message)[:120] for w in waits]
