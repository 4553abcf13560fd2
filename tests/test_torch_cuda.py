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
from distributed_swarm_algorithm_tpu_torch.ops import objectives as port_obj
from distributed_swarm_algorithm_tpu_torch.ops import pso as port_pso
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    islands_fused as port_isl,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    pso_fused as port_pf,
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


# --------------------------------------------------------------------------
# The fused PSO kernels (csrc/pso_fused.cu) against their plain versions.
#
# Kernel and plain version run the same arithmetic in the same order (IEEE
# intrinsics, sums over d in order, the same Philox draws), so for nine
# objectives every output is equal bit for bit, over a whole k-step launch.
# Ackley calls expf: its fitness is held to 1e-6 relative, and the
# `fit < bfit` decisions may differ only where |fit - bfit| is inside that.
# --------------------------------------------------------------------------

PSO_NAMES = list(port_pf.OBJECTIVES_T)


def _pso_inputs(name, n, d, seed, device, islands=0):
    _, hw = port_obj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    vel = (0.1 * rng.uniform(-hw, hw, (d, n))).astype(np.float32)
    bpos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    r1 = rng.uniform(size=(d, n)).astype(np.float32)
    r2 = rng.uniform(size=(d, n)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    pos, vel, bpos, r1, r2 = map(to, (pos, vel, bpos, r1, r2))
    bfit = port_pf.OBJECTIVES_T[name](bpos)
    if islands:
        per = bfit.reshape(islands, n // islands)
        flat = (torch.arange(islands, device=device) * (n // islands)
                + per.argmin(1))
        gbest = bpos[:, flat].contiguous()
    else:
        gbest = bpos[:, int(bfit.argmin())][:, None].contiguous()
    seed_t = torch.tensor([seed + 99], dtype=torch.int32, device=device)
    return float(hw), seed_t, gbest, pos, vel, bpos, bfit, r1, r2


def _assert_kernel_equals_plain(name, got, want, bfit_before, k_steps):
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in got)
    if name != "ackley":
        for label, a, b in zip(("pos", "vel", "bpos", "bfit"), got, want):
            assert torch.equal(a, b), (
                name, label, float((a - b).abs().max()))
        return
    band = 1e-6 * want[3].abs() + 1e-6
    if k_steps == 1:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        fit = port_pf.OBJECTIVES_T[name](want[0])
        flipped = (got[3] != bfit_before) != (want[3] != bfit_before)
        assert bool((~flipped | ((fit - bfit_before).abs() <= band)).all())
        assert bool((flipped | ((got[3] - want[3]).abs() <= band)).all())
    else:
        same = (got[0] == want[0]).all(0)
        assert float(same.float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize(
    "n,d,k_steps,rng,track_best",
    [(300, 8, 1, "host", True), (1000, 30, 8, "device", False),
     (77, 1, 8, "device", True), (130, 100, 1, "device", True),
     (4099, 30, 1, "host", False)],
    ids=["300x8-host", "1000x30-k8", "77x1-k8", "130x100", "4099x30-host"],
)
def test_pso_kernel_equals_plain(cuda, name, n, d, k_steps, rng, track_best):
    hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = _pso_inputs(
        name, n, d, n + d, cuda)
    kw = dict(objective_name=name, half_width=hw, rng=rng, k_steps=k_steps,
              track_best=track_best, step0=5)
    rr = (r1, r2) if rng == "host" else (None, None)
    before = port_pf.LAUNCHES
    got = port_pf.fused_pso_step_t(seed, gbest, pos, vel, bpos, bfit, *rr,
                                   **kw)
    assert port_pf.LAUNCHES == before + 1
    want = port_pf.fused_pso_step_plain(seed, gbest, pos, vel, bpos, bfit,
                                        *rr, **kw)
    _assert_kernel_equals_plain(name, got, want, bfit, k_steps)
    assert float(got[0].abs().max()) <= np.float32(hw)
    if track_best and name != "ackley":
        assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
        assert float(got[4]) == float(got[3].min())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rastrigin", "griewank", "michalewicz"])
@pytest.mark.parametrize("k_steps,rng", [(1, "host"), (8, "device")])
def test_islands_kernel_equals_plain(cuda, name, k_steps, rng):
    n_i, n_l, d = 3, 157, 12
    hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = _pso_inputs(
        name, n_i * n_l, d, 7, cuda, islands=n_i)
    assert gbest.shape == (d, n_i)
    kw = dict(objective_name=name, half_width=hw, lanes_per_island=n_l,
              rng=rng, k_steps=k_steps, step0=3)
    rr = (r1, r2) if rng == "host" else (None, None)
    before = port_isl.LAUNCHES, port_pf.LAUNCHES
    got = port_isl._islands_step_t(seed, gbest, pos, vel, bpos, bfit, *rr,
                                   **kw)
    assert (port_isl.LAUNCHES, port_pf.LAUNCHES) == (before[0] + 1,
                                                     before[1])
    want = port_isl.islands_step_plain(seed, gbest, pos, vel, bpos, bfit,
                                       *rr, **kw)
    _assert_kernel_equals_plain(name, got, want, bfit, k_steps)
    # Each island follows its own best: with one shared column the result
    # differs.
    shared = port_isl.islands_step_plain(
        seed, gbest[:, :1].expand(-1, n_i).contiguous(), pos, vel, bpos,
        bfit, *rr, **kw)
    assert not torch.equal(shared[0], want[0])


@pytest.mark.cuda
def test_pso_kernel_draws_the_plain_versions_uniforms(cuda):
    # With w = 0, c2 = 0, pbest = pos + 1 and no clamp in reach, one step
    # leaves vel = c1 * r1 exactly, so the kernel's draws can be read back.
    n, d = 1000, 30
    pos = torch.zeros(d, n, device=cuda)
    seed = torch.tensor([4242], dtype=torch.int32, device=cuda)
    out = port_pf.fused_pso_step_cuda(
        seed, torch.zeros(d, 1, device=cuda), pos, torch.zeros_like(pos),
        pos + 1.0, torch.zeros(1, n, device=cuda), objective_name="sphere",
        w=0.0, c1=1.0, c2=0.0, half_width=100.0, k_steps=1, step0=9,
        track_best=False)
    assert torch.equal(out[1], port_pf.philox_uniforms(seed, n, d, 9, 0))
    assert abs(float(out[1].mean()) - 0.5) < 1e-2
    assert abs(float(out[1].var()) - 1 / 12) < 5e-3


@pytest.mark.cuda
def test_pso_wrappers_reject_what_the_kernel_does_not_take(cuda):
    hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = _pso_inputs(
        "sphere", 64, 4, 1, cuda)
    kw = dict(objective_name="sphere")
    before = port_pf.LAUNCHES
    with pytest.raises(TypeError, match="float32"):
        port_pf.fused_pso_step_cuda(seed, gbest, pos.double(), vel, bpos,
                                    bfit, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        port_pf.fused_pso_step_cuda(seed, gbest, pos.T.contiguous().T, vel,
                                    bpos, bfit, **kw)
    with pytest.raises(ValueError, match="bfit must be"):
        port_pf.fused_pso_step_cuda(seed, gbest, pos, vel, bpos, bfit[0],
                                    **kw)
    with pytest.raises(ValueError, match="seed"):
        port_pf.fused_pso_step_cuda(seed.cpu(), gbest, pos, vel, bpos, bfit,
                                    **kw)
    with pytest.raises(ValueError, match="do not divide"):
        port_isl.islands_step_cuda(seed, gbest, pos, vel, bpos, bfit,
                                   lanes_per_island=5, **kw)
    # The wrapper sizes the candidate arrays by the block the entry picks.
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    pick = _build.load("pso_fused").dsa_pso_fused_block
    pick.argtypes, pick.restype = [ctypes.c_int], ctypes.c_int
    for d in (1, 30, 100, 151, 152, 302, 303, 605, 606, 5000):
        assert pick(d) == port_pf.kernel_block(d), d
    big = torch.zeros(606, 8, device=cuda)
    with pytest.raises(ValueError, match="envelope"):
        port_pf.fused_pso_step_cuda(seed, big[:, :1].contiguous(), big, big,
                                    big, torch.zeros(1, 8, device=cuda), **kw)
    assert port_pf.LAUNCHES == before


@pytest.mark.cuda
def test_fused_runs_never_wait_for_the_device(cuda):
    import warnings

    from distributed_swarm_algorithm_tpu_torch.ops import memetic
    from distributed_swarm_algorithm_tpu_torch.parallel import islands

    fn, hw = port_obj.get_objective("rastrigin")
    st = port_pso.pso_init(fn, 3000, 30, hw, seed=0, device=cuda)
    ist = islands.island_init(fn, 4, 500, 30, hw, seed=0, device=cuda)
    runs = {
        "pso": lambda: port_pf.fused_pso_run(
            st, "rastrigin", 20, half_width=hw, steps_per_kernel=8),
        "islands": lambda: port_isl.fused_island_run(
            ist, "rastrigin", 20, migrate_every=8, migrate_k=2,
            half_width=hw, steps_per_kernel=8),
        "memetic": lambda: memetic.fused_memetic_run(
            st, "rastrigin", fn, 20, refine_every=5, half_width=hw),
    }
    for name, run in runs.items():
        run()                                   # builds and warms up
        torch.cuda.synchronize()
        before = port_pf.LAUNCHES + port_isl.LAUNCHES
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert not waits, (name, [str(w.message)[:120] for w in waits])
        assert port_pf.LAUNCHES + port_isl.LAUNCHES > before
        best = out.pso.gbest_fit.min() if name == "islands" else out.gbest_fit
        assert bool(torch.isfinite(best))


@pytest.mark.cuda
def test_pso_models_take_the_kernel_on_the_card(cuda):
    opt = tdsa.PSO("rastrigin", n=5000, dim=30, seed=0)
    assert opt.use_pallas and opt.device.type == "cuda"
    first, before = opt.best, port_pf.LAUNCHES
    opt.run(64)
    assert port_pf.LAUNCHES == before + 8 and opt.best < first
    assert int(opt.state.iteration) == 64
    mem = tdsa.MemeticPSO("sphere", n=2000, dim=10, seed=1, refine_every=4)
    before = port_pf.LAUNCHES
    mem.run(10)
    assert port_pf.LAUNCHES == before + 3 and mem.best < 1.0
    # One block on the card and on the CPU from the same state with the same
    # injected uniforms: rastrigin is held bit for bit.
    state = tdsa.PSO("rastrigin", n=700, dim=30, seed=2).state
    cpu = port_pso.pso_state_from_numpy(port_pso.pso_state_to_numpy(state),
                                        device="cpu")
    u = torch.rand(2, 1, 30, 700)
    on_card = port_pf.fused_pso_run(state, "rastrigin", 1, rng="host",
                                    uniforms=(u[0].to(cuda), u[1].to(cuda)))
    on_cpu = port_pf.fused_pso_run(cpu, "rastrigin", 1, rng="host",
                                   uniforms=(u[0], u[1]))
    for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_fit"):
        assert torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)), f


# --------------------------------------------------------------------------
# The fused bat, grey-wolf, salp and whale kernels (csrc/bat_fused.cu,
# gwo_fused.cu, salp_fused.cu, woa_fused.cu) against their plain versions.
#
# Each kernel repeats its plain version op for op (IEEE intrinsics, sums
# over d in order, the same Philox draws; the bat pulse and the whale
# spiral call expf, as torch.exp does on the card), so every output is
# equal bit for bit over a whole k-step launch, except with ackley (the
# objective's expf, as for B5): there at least 99% of the lanes are equal.
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (  # noqa: E402
    bat_fused as port_bat,
    gwo_fused as port_gwo,
    salp_fused as port_salp,
    woa_fused as port_woa,
)

FAMILIES = {"bat": port_bat, "gwo": port_gwo, "salp": port_salp,
            "woa": port_woa}


def _family_case(fam, name, n, d, k, rng, device, tile_n=None, seed=0):
    """(kernel step, plain step, positional args, keywords) of one launch of
    family ``fam`` on numpy-drawn inputs on ``device``."""
    _, hw = port_obj.get_objective(name)
    g = np.random.default_rng(seed + n + d + k)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(device)
    pos = to(g.uniform(-hw, hw, (d, n)))
    fit = port_pf.OBJECTIVES_T[name](pos)
    best = pos[:, int(fit.argmin())][:, None].contiguous()
    it0 = int(g.integers(0, 50))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa
    kw = dict(objective_name=name, half_width=hw, rng=rng, k_steps=k,
              step0=int(g.integers(0, 1000)))
    mod = FAMILIES[fam]
    if fam == "bat":
        vel = to(g.uniform(-1, 1, (d, n)))
        loud = to(g.uniform(0.4, 1.0, (1, n)))
        pulse = to(g.uniform(0.0, 0.6, (1, n)))
        draws = [to(g.uniform(size=s)) for s in ((1, n), (1, n), (d, n),
                                                 (1, n))]
        args = [i32(seed + 7, it0), best, loud.mean().reshape(1), pos, vel,
                fit, loud, pulse]
        plain, kernel = mod.fused_bat_step_plain, mod.fused_bat_step_cuda
    elif fam == "gwo":
        order = torch.sort(fit[0], stable=True).indices[:3]
        draws = [to(g.uniform(size=(3 * d, n))) for _ in range(2)]
        args = [i32(seed + 7, it0), pos[:, order].T.contiguous(), pos]
        kw.update(t_max=60)
        plain, kernel = mod.fused_gwo_step_plain, mod.fused_gwo_step_cuda
    elif fam == "salp":
        draws = [to(g.uniform(size=(d, 1))) for _ in range(2)]
        args = [i32(seed + 7, it0), best, pos, fit]
        kw.update(t_max=60, tile_n=tile_n or n)
        plain, kernel = mod.fused_salp_step_plain, mod.fused_salp_step_cuda
    else:
        draws = [to(g.uniform(size=s)) for s in ((d, n), (d, n), (1, n),
                                                 (1, n))]
        tile = tile_n or n
        args = [i32(seed + 7, int(g.integers(0, n // tile)), it0,
                    int(g.integers(0, tile))), best, pos]
        kw.update(t_max=60, tile_n=tile)
        plain, kernel = mod.fused_woa_step_plain, mod.fused_woa_step_cuda
    if rng == "host":
        args += draws
    return kernel, plain, args, kw


def _assert_family_equal(name, got, want):
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    if name != "ackley":
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (name, i, float((a - b).abs().max()))
    else:
        assert float((got[0] == want[0]).all(0).float().mean()) >= 0.99


FAMILY_CASES = [
    # fam, objective, n, d, k, rng, tile_n
    ("bat", "rastrigin", 300, 8, 1, "host", None),
    ("bat", "sphere", 1000, 30, 8, "device", None),
    ("bat", "michalewicz", 77, 1, 8, "device", None),
    ("bat", "ackley", 515, 30, 8, "device", None),
    ("gwo", "rastrigin", 300, 8, 1, "host", None),
    ("gwo", "griewank", 1000, 30, 8, "device", None),
    ("gwo", "levy", 77, 1, 8, "device", None),
    ("gwo", "schwefel", 130, 100, 3, "device", None),
    ("salp", "rastrigin", 512, 8, 1, "host", 128),
    ("salp", "zakharov", 1024, 30, 16, "device", 128),
    ("salp", "styblinski_tang", 4096, 30, 16, "device", 4096),
    ("salp", "rosenbrock", 384, 3, 9, "device", 128),
    ("woa", "rastrigin", 512, 8, 1, "host", 128),
    ("woa", "sphere", 1024, 30, 8, "device", 128),
    ("woa", "michalewicz", 256, 1, 8, "device", 256),
    ("woa", "ackley", 640, 30, 8, "device", 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fam,name,n,d,k,rng,tile_n", FAMILY_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[3]}-k{c[4]}-{c[5]}" for c in
         FAMILY_CASES])
def test_family_kernel_equals_plain(cuda, fam, name, n, d, k, rng, tile_n):
    _, plain, args, kw = _family_case(fam, name, n, d, k, rng, cuda, tile_n)
    mod = FAMILIES[fam]
    before = mod.LAUNCHES
    # The entry sends CUDA tensors to the kernel, never to the plain version.
    got = getattr(mod, f"fused_{fam}_step_t")(*args, **kw)
    assert mod.LAUNCHES == before + 1
    want = plain(*args, **kw)
    assert mod.LAUNCHES == before + 1
    _assert_family_equal(name, got, want)
    hw = kw["half_width"]
    assert float(got[0].abs().max()) <= np.float32(hw)


@pytest.mark.cuda
def test_family_kernels_read_their_draws_and_reject_bad_operands(cuda):
    for fam in FAMILIES:
        kernel, plain, args, kw = _family_case(fam, "sphere", 256, 4, 1,
                                               "device", cuda, 128)
        mod = FAMILIES[fam]
        before = mod.LAUNCHES
        with pytest.raises(TypeError, match="float32"):
            kernel(*args[:-1], args[-1].double(), **kw)
        strided = torch.stack([args[-1], args[-1]], -1)[..., 0]
        with pytest.raises(ValueError, match="contiguous"):
            kernel(*args[:-1], strided, **kw)
        with pytest.raises(ValueError, match="scalars"):
            kernel(args[0].cpu(), *args[1:], **kw)
        assert mod.LAUNCHES == before
        # Another seed draws other numbers.
        a = kernel(*args, **kw)
        b = kernel(args[0] + 1, *args[1:], **kw)
        assert not torch.equal(a[0], b[0]), fam
    with pytest.raises(ValueError, match="k_steps"):
        _, _, args, kw = _family_case("salp", "sphere", 256, 4, 17,
                                      "device", cuda, 128)
        port_salp.fused_salp_step_cuda(*args, **kw)
    # The wrappers' envelopes are the entries' block picks.
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    for fam, mod in FAMILIES.items():
        pick = getattr(_build.load(f"{fam}_fused"), f"dsa_{fam}_fused_block")
        pick.argtypes, pick.restype = [ctypes.c_int], ctypes.c_int
        for d in (1, 30, 100, 152, 228, 229, 452, 453, 605, 606, 908, 909,
                  1816, 1817):
            assert pick(d) == mod.kernel_block(d), (fam, d)


@pytest.mark.cuda
def test_family_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build([f"{fam}_fused" for fam in FAMILIES])
    for fam in FAMILIES:
        log = _build.build_log(f"{fam}_fused")
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert spills, (fam, log[:400])
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (fam, spills)


@pytest.mark.cuda
def test_family_runs_never_wait_for_the_device(cuda):
    import warnings

    from distributed_swarm_algorithm_tpu_torch.ops import bat, gwo, salp, woa
    fn, hw = port_obj.get_objective("rastrigin")
    states = {
        "bat": bat.bat_init(fn, 3000, 30, hw, seed=0, device=cuda),
        "gwo": gwo.gwo_init(fn, 3000, 30, hw, seed=0, device=cuda),
        "salp": salp.salp_init(fn, 3000, 30, hw, seed=0, device=cuda),
        "woa": woa.woa_init(fn, 3000, 30, hw, seed=0, device=cuda),
    }
    runs = {
        "bat": lambda: port_bat.fused_bat_run(states["bat"], "rastrigin", 20,
                                              half_width=hw),
        "gwo": lambda: port_gwo.fused_gwo_run(states["gwo"], "rastrigin", 20,
                                              half_width=hw),
        "salp": lambda: port_salp.fused_salp_run(states["salp"], "rastrigin",
                                                 40, half_width=hw),
        "woa": lambda: port_woa.fused_woa_run(states["woa"], "rastrigin", 20,
                                              half_width=hw),
    }
    for fam, run in runs.items():
        run()                                   # builds and warms up
        torch.cuda.synchronize()
        before = FAMILIES[fam].LAUNCHES
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert not waits, (fam, [str(w.message)[:120] for w in waits])
        assert FAMILIES[fam].LAUNCHES == before + 3, fam
        best = out.leader_fit[0] if fam == "gwo" else out.best_fit
        assert bool(torch.isfinite(best))


@pytest.mark.cuda
def test_family_models_take_the_kernel_and_match_the_cpu(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops import bat, gwo, salp, woa
    models = {"bat": tdsa.Bat("rastrigin", n=5000, dim=30, seed=0),
              "gwo": tdsa.GWO("rastrigin", n=5000, dim=30, seed=0),
              "salp": tdsa.Salp("rastrigin", n=5000, dim=30, seed=0),
              "woa": tdsa.WOA("rastrigin", n=5000, dim=30, seed=0)}
    for fam, opt in models.items():
        assert opt.use_pallas and opt.device.type == "cuda", fam
        first, before = opt.best, FAMILIES[fam].LAUNCHES
        opt.run(32)
        launches = {"salp": 2}.get(fam, 4)
        assert FAMILIES[fam].LAUNCHES == before + launches, fam
        assert opt.best <= first and int(opt.state.iteration) == 32, fam
    # Three launches on the card and on the CPU from one state with the same
    # draws handed in: gwo and salp are held bit for bit.  The bat's mean
    # loudness is a sum each device adds in its own order, and the bat's
    # pulse and the whale's spiral call exp, which each device's library
    # rounds its own way: their floats within rtol = atol = 1e-5 (fitness
    # 2e-5), the bat's loudness (every acceptance) exact.
    n, d = 768, 30
    g = torch.Generator().manual_seed(3)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    cases = {
        "bat": (bat, port_bat.fused_bat_run,
                dict(uniforms=[(u(1, n), u(1, n), u(d, n), u(1, n))
                               for _ in range(3)], tile_n=n)),
        "gwo": (gwo, port_gwo.fused_gwo_run,
                dict(uniforms=[(u(3 * d, n), u(3 * d, n))
                               for _ in range(3)], tile_n=n)),
        "salp": (salp, port_salp.fused_salp_run,
                 dict(uniforms=[(u(d, 1), u(d, 1)) for _ in range(3)],
                      tile_n=n)),
        "woa": (woa, port_woa.fused_woa_run,
                dict(uniforms=[(u(d, n), u(d, n), u(1, n), u(1, n))
                               for _ in range(3)], tile_n=n,
                     shifts=torch.tensor([[0, 5], [0, 600], [0, 1]],
                                         dtype=torch.int32))),
    }
    fn, hw = port_obj.get_objective("rastrigin")
    for fam, (ops, run, kw) in cases.items():
        init = getattr(ops, f"{fam}_init")
        to_np = getattr(ops, f"{fam}_state_to_numpy")
        from_np = getattr(ops, f"{fam}_state_from_numpy")
        cpu = init(fn, n, d, hw, seed=2, device="cpu")
        gpu = from_np(to_np(cpu), device=cuda)
        on_cpu = run(cpu, "rastrigin", 3, rng="host", **kw)
        kw_gpu = {k: ([tuple(t.to(cuda) for t in c) for c in v]
                      if k == "uniforms" else
                      v.to(cuda) if torch.is_tensor(v) else v)
                  for k, v in kw.items()}
        on_card = to_np(run(gpu, "rastrigin", 3, rng="host", **kw_gpu))
        for f, a in to_np(on_cpu).items():
            if fam in ("gwo", "salp") or f in ("loudness", "iteration"):
                np.testing.assert_array_equal(on_card[f], a,
                                              err_msg=f"{fam} {f}")
            else:
                tol = 2e-5 if "fit" in f else 1e-5
                np.testing.assert_allclose(on_card[f], a, rtol=tol,
                                           atol=tol, err_msg=f"{fam} {f}")


# --------------------------------------------------------------------------
# The fused DE, SHADE, GA and moth-flame kernels (csrc/de_fused.cu,
# shade_fused.cu, ga_fused.cu, mfo_fused.cu) against their plain versions.
#
# Each kernel repeats its plain version op for op (IEEE intrinsics, sums
# over d in order, the same Philox draws, the bit-field log2 and 2^x
# polynomials and the cosine polynomial), so every output is equal bit for
# bit over a whole launch, except with ackley (the objective's expf): there
# at least 99% of the lanes are equal.
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (  # noqa: E402
    de_fused as port_de,
    ga_fused as port_ga,
    mfo_fused as port_mfo,
    shade_fused as port_shade,
)

ROTATIONAL = {"de": port_de, "shade": port_shade, "ga": port_ga,
              "mfo": port_mfo}


def _rot_case(fam, name, n, d, k, rng, device, tile_n, seed=0):
    """(kernel step, plain step, positional args, keywords) of one launch of
    family ``fam`` on numpy-drawn inputs on ``device``."""
    _, hw = port_obj.get_objective(name)
    g = np.random.default_rng(seed + n + d + k)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(device)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa
    pos = to(g.uniform(-hw, hw, (d, n)))
    fit = port_pf.OBJECTIVES_T[name](pos)
    n_tiles = n // tile_n
    lanes = lambda m: [int(v) for v in g.integers(0, 3 * tile_n, m)]  # noqa
    tiles = lambda m: [int(v) for v in g.integers(1, n_tiles, m)]  # noqa
    kw = dict(objective_name=name, half_width=hw, rng=rng, tile_n=tile_n)
    if fam == "de":
        args = [i32(seed + 7, 1, 2, 3, *lanes(3)), pos, fit]
        draws = [to(g.uniform(size=(d, n)))]
        kw.update(k_steps=k, step0=int(g.integers(0, 1000)))
    elif fam == "shade":
        args = [i32(seed + 7, *tiles(3), *lanes(3),
                    int(g.integers(0, 128)), int(g.integers(0, 65537))),
                pos, fit, to(g.uniform(0.01, 1.0, (1, n))),
                to(g.uniform(size=(1, n))), to(g.uniform(-hw, hw, (d, n))),
                to(g.uniform(-hw, hw, (d, 128)))]
        draws = [to(g.uniform(size=(d, n))), to(g.uniform(size=(1, n)))]
        kw.update(step=int(g.integers(0, 1000)))
    elif fam == "ga":
        args = [i32(seed + 7, *tiles(2), *lanes(3)), pos, fit]
        draws = [to(g.uniform(size=s)) for s in ((d, n), (1, n), (d, n),
                                                 (d, n))]
        kw.update(k_steps=k, step0=int(g.integers(0, 1000)),
                  p_mut=max(1.0 / d, 0.1))
    else:
        flames = to(g.uniform(-hw, hw, (d, n)))
        ffit = port_pf.OBJECTIVES_T[name](flames)
        ffit[0, ::9] = float("inf")
        n_flames = int(g.integers(1, n + 1))
        args = [i32(seed + 7, n_flames, int(g.integers(-131072, -65535))),
                flames[:, n_flames - 1:n_flames].contiguous(), pos, flames,
                ffit]
        draws = [to(g.uniform(size=(d, n)))]
        kw.update(k_steps=k, step0=int(g.integers(0, 1000)))
    if rng == "host":
        args += draws
    mod = ROTATIONAL[fam]
    return (getattr(mod, f"fused_{fam}_step_cuda"),
            getattr(mod, f"fused_{fam}_step_plain"), args, kw)


ROT_CASES = [
    # fam, objective, n, d, k, rng, tile_n
    ("de", "rastrigin", 512, 8, 1, "host", 128),
    ("de", "sphere", 480, 30, 32, "device", 96),
    ("de", "michalewicz", 640, 1, 8, "device", 160),
    ("de", "ackley", 4096, 30, 32, "device", 1024),
    ("shade", "rastrigin", 512, 8, 1, "host", 128),
    ("shade", "griewank", 1280, 30, 1, "device", 256),
    ("shade", "levy", 512, 1, 1, "device", 128),
    ("shade", "schwefel", 768, 100, 1, "device", 128),
    ("ga", "rastrigin", 512, 8, 1, "host", 128),
    ("ga", "sphere", 4096, 30, 8, "device", 1024),
    ("ga", "zakharov", 500, 3, 8, "device", 100),
    ("ga", "ackley", 16384, 30, 8, "device", 4096),
    ("mfo", "rastrigin", 512, 8, 1, "host", 128),
    ("mfo", "styblinski_tang", 1000, 30, 8, "device", 200),
    ("mfo", "rosenbrock", 77, 1, 32, "device", 77),
    ("mfo", "ackley", 640, 30, 8, "device", 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fam,name,n,d,k,rng,tile_n", ROT_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[3]}-k{c[4]}-{c[5]}" for c in ROT_CASES])
def test_rotational_kernel_equals_plain(cuda, fam, name, n, d, k, rng,
                                        tile_n):
    _, plain, args, kw = _rot_case(fam, name, n, d, k, rng, cuda, tile_n)
    mod = ROTATIONAL[fam]
    before = mod.LAUNCHES
    # The entry sends CUDA tensors to the kernel, never to the plain version.
    got = getattr(mod, f"fused_{fam}_step_t")(*args, **kw)
    assert mod.LAUNCHES == before + 1
    want = plain(*args, **kw)
    assert mod.LAUNCHES == before + 1
    _assert_family_equal(name, got, want)
    assert float(got[0].abs().max()) <= np.float32(kw["half_width"])


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
def test_ga_kernel_keeps_each_tile_in_step(cuda, k):
    # Parent A reads the tile's current generation and the elitism its
    # argmin and argmax at every step: k generations in one launch equal
    # the plain version's k, at 4 tiles of 4,096 lanes (512 threads of 8
    # lanes each) and at a tile of 1,000 lanes.
    for n, tile_n in ((16384, 4096), (4000, 1000)):
        kernel, plain, args, kw = _rot_case("ga", "rastrigin", n, 30, k,
                                            "device", cuda, tile_n)
        _assert_family_equal("rastrigin", kernel(*args, **kw),
                             plain(*args, **kw))


@pytest.mark.cuda
def test_rotational_kernels_read_their_draws_and_reject_bad_operands(cuda):
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    for fam, mod in ROTATIONAL.items():
        kernel, plain, args, kw = _rot_case(fam, "sphere", 512, 4, 1,
                                            "device", cuda, 128)
        before = mod.LAUNCHES
        with pytest.raises(TypeError, match="float32"):
            kernel(*args[:-1], args[-1].double(), **kw)
        strided = torch.stack([args[-1], args[-1]], -1)[..., 0]
        with pytest.raises(ValueError, match="contiguous"):
            kernel(*args[:-1], strided, **kw)
        with pytest.raises(ValueError, match="scalars"):
            kernel(args[0].cpu(), *args[1:], **kw)
        assert mod.LAUNCHES == before
        # Another seed draws other numbers.
        a = kernel(*args, **kw)
        b = kernel(args[0] + 1, *args[1:], **kw)
        assert not torch.equal(a[0], b[0]), fam
        if fam != "ga":
            pick = getattr(_build.load(f"{fam}_fused"),
                           f"dsa_{fam}_fused_block")
            pick.argtypes, pick.restype = [ctypes.c_int], ctypes.c_int
            for d in (1, 30, 100, 129, 180, 181, 300, 363, 364, 908, 909):
                assert pick(d) == mod.kernel_block(d), (fam, d)
    threads = _build.load("ga_fused").dsa_ga_fused_threads
    threads.argtypes, threads.restype = [ctypes.c_int], ctypes.c_int
    for tile_n in (77, 128, 1000, 4096, 8192):
        assert threads(tile_n) == port_ga.tile_threads(tile_n)
    with pytest.raises(ValueError, match="multiple"):
        _, _, args, kw = _rot_case("shade", "sphere", 480, 4, 1, "device",
                                   cuda, 96)
        port_shade.fused_shade_step_cuda(*args, **kw)


@pytest.mark.cuda
def test_rotational_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build([f"{fam}_fused" for fam in ROTATIONAL])
    for fam in ROTATIONAL:
        log = _build.build_log(f"{fam}_fused")
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert spills, (fam, log[:400])
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (fam, spills)


@pytest.mark.cuda
def test_rotational_runs_never_wait_for_the_device(cuda):
    # SHADE's included: its per-generation draws, elite pool, success
    # memory, archive window and best tracking all stay on the device.
    import warnings

    from distributed_swarm_algorithm_tpu_torch.ops import de, ga, mfo, shade
    fn, hw = port_obj.get_objective("rastrigin")
    states = {
        "de": de.de_init(fn, 3000, 30, hw, seed=0, device=cuda),
        "shade": shade.shade_init(fn, 3000, 30, hw, seed=0, device=cuda),
        "ga": ga.ga_init(fn, 3000, 30, hw, seed=0, device=cuda),
        "mfo": mfo.mfo_init(fn, 3000, 30, hw, seed=0, device=cuda),
    }
    runs = {
        "de": lambda: port_de.fused_de_run(states["de"], "rastrigin", 48,
                                           half_width=hw,
                                           steps_per_kernel=16),
        "shade": lambda: port_shade.fused_shade_run(
            states["shade"], "rastrigin", 3, half_width=hw),
        "ga": lambda: port_ga.fused_ga_run(states["ga"], "rastrigin", 24,
                                           half_width=hw),
        "mfo": lambda: port_mfo.fused_mfo_run(states["mfo"], "rastrigin",
                                              24, half_width=hw,
                                              sort_blocks=2),
    }
    for fam, run in runs.items():
        run()                                   # builds and warms up
        torch.cuda.synchronize()
        before = ROTATIONAL[fam].LAUNCHES
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert not waits, (fam, [str(w.message)[:120] for w in waits])
        assert ROTATIONAL[fam].LAUNCHES == before + 3, fam
        best = out.flame_fit[0] if fam == "mfo" else out.best_fit
        assert bool(torch.isfinite(best))


@pytest.mark.cuda
def test_rotational_models_take_the_kernel_and_match_the_cpu(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops import de, ga, mfo, shade
    models = {"de": tdsa.DE("rastrigin", n=5000, dim=30, seed=0),
              "shade": tdsa.SHADE("rastrigin", n=5000, dim=30, seed=0),
              "ga": tdsa.GA("rastrigin", n=5000, dim=30, seed=0),
              "mfo": tdsa.MFO("rastrigin", n=5000, dim=30, seed=0)}
    for fam, opt in models.items():
        assert opt.use_pallas and opt.device.type == "cuda", fam
        first, before = opt.best, ROTATIONAL[fam].LAUNCHES
        opt.run(32)
        launches = {"shade": 32}.get(fam, 4)
        assert ROTATIONAL[fam].LAUNCHES == before + launches, fam
        assert opt.best <= first and int(opt.state.iteration) == 32, fam
    # Three launches on the card and on the CPU from one state with the same
    # draws handed in.  DE, GA and MFO are held bit for bit.  SHADE's
    # success memory sums over N in another order on each device, so its
    # floats carry rtol = atol = 1e-5 (fitness 2e-5); its counters exact.
    n, d = 768, 30
    g = torch.Generator().manual_seed(3)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    shade_draws = [port_shade.generation_draws(g, n, d, 6, 128, True, "cpu")
                   for _ in range(3)]
    cases = {
        "de": (de, port_de.fused_de_run,
               dict(uniforms=[u(d, n) for _ in range(3)], tile_n=128,
                    shifts=torch.tensor([[1, 2, 3, 5, 600, 7],
                                         [5, 4, 3, 0, 1, 2],
                                         [2, 1, 5, 9, 9, 127]],
                                        dtype=torch.int32))),
        "shade": (shade, port_shade.fused_shade_run,
                  dict(draws=shade_draws, tile_n=128)),
        "ga": (ga, port_ga.fused_ga_run,
               dict(uniforms=[(u(d, n), u(1, n), u(d, n), u(d, n))
                              for _ in range(3)], tile_n=128,
                    shifts=torch.tensor([[1, 2, 5, 600, 7],
                                         [5, 5, 0, 1, 2],
                                         [2, 1, 9, 9, 127]],
                                        dtype=torch.int32))),
        "mfo": (mfo, port_mfo.fused_mfo_run,
                dict(uniforms=[u(d, n) for _ in range(3)], tile_n=128,
                     t_max=5, sort_blocks=2)),
    }
    fn, hw = port_obj.get_objective("rastrigin")
    for fam, (ops, run, kw) in cases.items():
        init = getattr(ops, f"{fam}_init")
        to_np = getattr(ops, f"{fam}_state_to_numpy")
        from_np = getattr(ops, f"{fam}_state_from_numpy")
        cpu = init(fn, n, d, hw, seed=2, device="cpu")
        gpu = from_np(to_np(cpu), device=cuda)
        on_cpu = run(cpu, "rastrigin", 3, rng="host", **kw)
        to_dev = lambda v: (v.to(cuda) if torch.is_tensor(v)  # noqa: E731
                            else v)
        kw_gpu = {k: ([tuple(to_dev(t) for t in c) if isinstance(c, tuple)
                       else to_dev(c) for c in v]
                      if isinstance(v, list) else to_dev(v))
                  for k, v in kw.items()}
        on_card = to_np(run(gpu, "rastrigin", 3, rng="host", **kw_gpu))
        for f, a in to_np(on_cpu).items():
            if fam != "shade" or f in ("mem_k", "archive_n", "iteration"):
                np.testing.assert_array_equal(on_card[f], a,
                                              err_msg=f"{fam} {f}")
            else:
                tol = 2e-5 if "fit" in f else 1e-5
                np.testing.assert_allclose(on_card[f], a, rtol=tol,
                                           atol=tol, err_msg=f"{fam} {f}")


# --------------------------------------------------------------------------
# The fused cuckoo, Harris-hawks, ABC and parallel-tempering kernels
# (csrc/cuckoo_fused.cu, hho_fused.cu, abc_fused.cu, tempering_fused.cu)
# against their plain versions.
#
# Each kernel repeats its plain version op for op (IEEE intrinsics, sums
# over d in order, the same Philox draws, the Box-Muller pair, the bit-field
# log2 and 2^x polynomials), so every output is equal bit for bit over a
# whole launch, except with ackley (the objective's expf): there at least
# 99% of the lanes are equal.
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (  # noqa: E402
    abc_fused as port_abc,
    cuckoo_fused as port_cuckoo,
    fast_math as port_fm,
    hho_fused as port_hho,
    tempering_fused as port_pt,
)

LEVY_FAMILIES = {"cuckoo": port_cuckoo, "hho": port_hho, "abc": port_abc,
                 "pt": port_pt}


def _levy_case(fam, name, n, d, k, rng, device, tile_n, seed=0, limit=20,
               swap_every=5, n_real=None):
    """(kernel step, plain step, positional args, keywords) of one launch of
    family ``fam`` on numpy-drawn inputs on ``device``."""
    _, hw = port_obj.get_objective(name)
    g = np.random.default_rng(seed + n + d + k)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(device)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa
    pos = to(g.uniform(-hw, hw, (d, n)))
    fit = port_pf.OBJECTIVES_T[name](pos)
    best = pos[:, int(fit.argmin())][:, None].contiguous()
    n_tiles = n // tile_n
    lanes = lambda m: [int(v) for v in g.integers(0, 3 * tile_n, m)]  # noqa
    tiles = lambda m: [int(v) for v in g.integers(1, n_tiles, m)]  # noqa
    kw = dict(objective_name=name, half_width=hw, rng=rng, tile_n=tile_n,
              k_steps=k, step0=int(g.integers(0, 1000)))
    u = lambda *s: to(g.uniform(size=s))  # noqa: E731
    normal = lambda *s: to(g.standard_normal(s))  # noqa: E731
    if fam == "cuckoo":
        args = [i32(seed + 7, *tiles(2), *lanes(3)), best, pos, fit]
        draws = [normal(d, n), normal(d, n), u(1, n), u(d, n)]
    elif fam == "hho":
        mean = pos.mean(dim=1, keepdim=True)
        args = [i32(seed + 7, *tiles(1), int(g.integers(0, 60)), *lanes(1)),
                best, mean, pos, fit]
        draws = [tuple([u(1, n) for _ in range(4)] + [u(d, n)
                                                      for _ in range(5)]
                       + [normal(d, n), normal(d, n)])]
        kw.update(t_max=60)
    elif fam == "abc":
        trials = torch.from_numpy(
            g.integers(0, limit + 2, (1, n)).astype(np.int32)).to(device)
        args = [i32(seed + 7, *tiles(1), *lanes(2)), pos, fit, trials]
        draws = [tuple([u(1, n) for _ in range(5)] + [u(d, n)])]
        kw.update(limit=limit)
    else:
        temps = to(0.01 * 1000.0 ** (np.arange(n) / (n - 1)))[None, :]
        args = [i32(seed + 7, int(g.integers(0, 40)), n_real or n), pos, fit,
                0.512 * torch.sqrt(temps), 1.0 / temps]
        draws = [normal(d, n), u(1, n), u(1, n)]
        kw.update(swap_every=swap_every)
    if rng == "host":
        args += draws
    mod = LEVY_FAMILIES[fam]
    return (getattr(mod, f"fused_{fam}_step_cuda"),
            getattr(mod, f"fused_{fam}_step_plain"), args, kw)


LEVY_CASES = [
    # fam, objective, n, d, k, rng, tile_n, extra
    ("cuckoo", "rastrigin", 512, 8, 1, "host", 128, {}),
    ("cuckoo", "sphere", 480, 30, 8, "device", 96, {}),
    ("cuckoo", "michalewicz", 640, 1, 8, "device", 160, {}),
    ("cuckoo", "ackley", 4096, 30, 8, "device", 1024, {}),
    ("hho", "rastrigin", 512, 8, 1, "host", 128, {}),
    ("hho", "griewank", 1000, 30, 8, "device", 200, {}),
    ("hho", "levy", 640, 1, 8, "device", 160, {}),
    ("hho", "schwefel", 768, 100, 3, "device", 128, {}),
    ("abc", "rastrigin", 512, 8, 1, "host", 128, {}),
    ("abc", "zakharov", 500, 3, 8, "device", 100, dict(limit=2)),
    ("abc", "sphere", 4096, 30, 8, "device", 1024, dict(limit=2)),
    ("abc", "ackley", 16384, 30, 8, "device", 4096, dict(limit=491520)),
    ("pt", "rastrigin", 512, 8, 1, "host", 128, dict(n_real=500)),
    ("pt", "styblinski_tang", 1000, 30, 16, "device", 200,
     dict(n_real=987)),
    ("pt", "rosenbrock", 640, 3, 16, "device", 320, dict(swap_every=1)),
    ("pt", "ackley", 4096, 30, 16, "device", 4096, {}),
    ("pt", "sphere", 768, 100, 7, "device", 256, dict(swap_every=3)),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fam,name,n,d,k,rng,tile_n,extra", LEVY_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[3]}-k{c[4]}-{c[5]}" for c in LEVY_CASES])
def test_levy_family_kernel_equals_plain(cuda, fam, name, n, d, k, rng,
                                         tile_n, extra):
    _, plain, args, kw = _levy_case(fam, name, n, d, k, rng, cuda, tile_n,
                                    **extra)
    mod = LEVY_FAMILIES[fam]
    before = mod.LAUNCHES
    # The entry sends CUDA tensors to the kernel, never to the plain version.
    got = getattr(mod, f"fused_{fam}_step_t")(*args, **kw)
    assert mod.LAUNCHES == before + 1
    want = plain(*args, **kw)
    assert mod.LAUNCHES == before + 1
    _assert_family_equal(name, got, want)
    assert float(got[0].abs().max()) <= np.float32(kw["half_width"])


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
def test_tile_in_step_kernels_keep_each_tile_in_step(cuda, k):
    # Cuckoo's egg rolls the current generation's candidates and ABC's
    # employed partner the current tile, its gate the tile's maximum: k
    # steps in one launch equal the plain version's k at 4 tiles of 4,096
    # lanes (512 threads of 8 lanes each) and at tiles of 1,000 lanes; ABC
    # at a small limit, so scouts fire, and PT over two rounds.
    for n, tile_n in ((16384, 4096), (4000, 1000)):
        for fam, extra in (("cuckoo", {}), ("abc", dict(limit=2)),
                           ("pt", dict(n_real=n - 3, swap_every=3))):
            kernel, plain, args, kw = _levy_case(fam, "rastrigin", n, 30, k,
                                                 "device", cuda, tile_n,
                                                 **extra)
            _assert_family_equal("rastrigin", kernel(*args, **kw),
                                 plain(*args, **kw))


@pytest.mark.cuda
def test_levy_kernels_scouts_and_exchanges_fire(cuda):
    # The small-limit ABC launch re-randomizes sources, and the PT launch
    # swaps chains, padded ones never: the paths the full-width runs seldom
    # take are held bit for bit above, and here shown taken.
    _, plain, args, kw = _levy_case("abc", "sphere", 4096, 30, 8, "device",
                                    cuda, 1024, limit=2)
    counts = {}
    plain(*args, **kw, counts=counts)
    assert int(sum(counts["exhausted"])) > 0
    _, plain, args, kw = _levy_case("pt", "sphere", 1000, 30, 16, "device",
                                    cuda, 200, n_real=987)
    counts = {}
    plain(*args, **kw, counts=counts)
    assert int(sum(counts["swapped"])) > 0


@pytest.mark.cuda
def test_normal_pair_on_the_card_equals_its_plain_version(cuda):
    # normal_pair's plain version on the card agrees with the CPU's within
    # a few ulps (the card's elementwise operations round their own way)
    # and gives standard normals; its device twin (csrc/fast_math.cuh) is
    # held bit for bit against the plain version on the card through a
    # cuckoo launch with no abandonment, whose candidates carry both halves
    # of each pair.
    g = torch.Generator(device=cuda).manual_seed(0)
    # (u1 = 0 gives NaN in both, which torch.equal does not match.)
    u1 = torch.rand((64, 4096), generator=g, device=cuda).clamp_min(1e-7)
    u2 = torch.rand((64, 4096), generator=g, device=cuda)
    n1, n2 = port_fm.normal_pair(u1, u2)
    c1, c2 = port_fm.normal_pair(u1.cpu(), u2.cpu())
    for a, b in ((n1, c1), (n2, c2)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    kernel, plain, args, kw = _levy_case("cuckoo", "sphere", 512, 8, 1,
                                         "device", cuda, 128)
    kw.update(pa=0.0, step_scale=1.0)
    _assert_family_equal("sphere", kernel(*args, **kw), plain(*args, **kw))
    stats = torch.cat([n1.flatten(), n2.flatten()])
    assert abs(float(stats.mean())) < 0.01
    assert abs(float(stats.var()) - 1.0) < 0.01


@pytest.mark.cuda
def test_levy_kernels_read_their_draws_and_reject_bad_operands(cuda):
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    for fam, mod in LEVY_FAMILIES.items():
        kernel, plain, args, kw = _levy_case(fam, "sphere", 512, 4, 1,
                                             "device", cuda, 128)
        before = mod.LAUNCHES
        with pytest.raises((TypeError, ValueError)):
            kernel(*args[:-1], args[-1].double(), **kw)
        strided = torch.stack([args[-1], args[-1]], -1)[..., 0]
        with pytest.raises(ValueError):
            kernel(*args[:-1], strided, **kw)
        with pytest.raises(ValueError, match="scalars"):
            kernel(args[0].cpu(), *args[1:], **kw)
        assert mod.LAUNCHES == before
        # Another seed draws other numbers.
        a = kernel(*args, **kw)
        b = kernel(args[0] + 1, *args[1:], **kw)
        assert not torch.equal(a[0], b[0]), fam
    for fam in ("cuckoo", "abc"):
        threads = getattr(_build.load(f"{fam}_fused"),
                          f"dsa_{fam}_fused_threads")
        threads.argtypes, threads.restype = [ctypes.c_int], ctypes.c_int
        for tile_n in (77, 128, 1000, 4096, 8192):
            assert threads(tile_n) == port_ga.tile_threads(tile_n)
    pick = _build.load("hho_fused").dsa_hho_fused_block
    pick.argtypes, pick.restype = [ctypes.c_int], ctypes.c_int
    for d in (1, 30, 151, 152, 302, 303, 605, 606):
        assert pick(d) == port_hho.kernel_block(d), d
    pick = _build.load("tempering_fused").dsa_pt_fused_block
    pick.argtypes, pick.restype = [ctypes.c_int] * 2, ctypes.c_int
    for d in (1, 30, 100, 120, 200, 360, 361):
        for h in (1, 4, 16):
            assert pick(d, h) == port_pt.kernel_block(d, h), (d, h)
    with pytest.raises(ValueError, match="even"):
        _, _, args, kw = _levy_case("pt", "sphere", 515, 4, 1, "device",
                                    cuda, 103)
        port_pt.fused_pt_step_cuda(*args, **kw)


@pytest.mark.cuda
def test_levy_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    names = ["cuckoo_fused", "hho_fused", "abc_fused", "tempering_fused"]
    _build.build(names)
    for name in names:
        log = _build.build_log(name)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert spills, (name, log[:400])
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


def _levy_states(device, n=3000, d=30):
    from distributed_swarm_algorithm_tpu_torch.ops import (
        abc, cuckoo, hho, tempering,
    )
    fn, hw = port_obj.get_objective("rastrigin")
    return fn, hw, {
        "cuckoo": cuckoo.cuckoo_init(fn, n, d, hw, seed=0, device=device),
        "hho": hho.hho_init(fn, n, d, hw, seed=0, device=device),
        "abc": abc.abc_init(fn, n, d, hw, seed=0, device=device),
        "pt": tempering.pt_init(fn, n, d, hw, seed=0, device=device),
    }


@pytest.mark.cuda
def test_levy_runs_never_wait_for_the_device(cuda):
    import warnings

    _, hw, states = _levy_states(cuda)
    runs = {
        "cuckoo": lambda: port_cuckoo.fused_cuckoo_run(
            states["cuckoo"], "rastrigin", 24, half_width=hw),
        "hho": lambda: port_hho.fused_hho_run(states["hho"], "rastrigin", 24,
                                              half_width=hw, t_max=24),
        "abc": lambda: port_abc.fused_abc_run(states["abc"], "rastrigin", 24,
                                              half_width=hw, limit=5),
        "pt": lambda: port_pt.fused_pt_run(states["pt"], "rastrigin", 48,
                                           half_width=hw),
    }
    for fam, run in runs.items():
        run()                                   # builds and warms up
        torch.cuda.synchronize()
        before = LEVY_FAMILIES[fam].LAUNCHES
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert not waits, (fam, [str(w.message)[:120] for w in waits])
        assert LEVY_FAMILIES[fam].LAUNCHES == before + 3, fam
        assert bool(torch.isfinite(out.best_fit))


@pytest.mark.cuda
def test_levy_models_take_the_kernel_and_match_the_cpu(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops import (
        abc, cuckoo, hho, tempering,
    )
    models = {"cuckoo": tdsa.Cuckoo("rastrigin", n=5000, dim=30, seed=0),
              "hho": tdsa.HarrisHawks("rastrigin", n=5000, dim=30, seed=0),
              "abc": tdsa.ABC("rastrigin", n=5000, dim=30, seed=0),
              "pt": tdsa.ParallelTempering("rastrigin", n=5000, dim=30,
                                           seed=0)}
    for fam, opt in models.items():
        assert opt.use_pallas and opt.device.type == "cuda", fam
        first, before = opt.best, LEVY_FAMILIES[fam].LAUNCHES
        opt.run(32)
        launches = {"pt": 2}.get(fam, 4)
        assert LEVY_FAMILIES[fam].LAUNCHES == before + launches, fam
        assert opt.best <= first and int(opt.state.iteration) == 32, fam
    # Three launches on the card and on the CPU from one state with the
    # same draws handed in: cuckoo and ABC held bit for bit.  HHO's mean
    # over the hawks is a sum each device adds in its own order, and PT's
    # proposal scales take torch.sqrt, which the card rounds its own way:
    # their floats carry rtol = atol = 1e-5 (fitness 2e-5), the ladder and
    # the iteration exact.
    n, d, tile = 768, 30, 128
    g = torch.Generator().manual_seed(3)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    nz = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    i32 = lambda rows: torch.tensor(rows, dtype=torch.int32)  # noqa: E731
    cases = {
        "cuckoo": (cuckoo, port_cuckoo.fused_cuckoo_run, dict(
            uniforms=[(nz(d, n), nz(d, n), u(1, n), u(d, n))
                      for _ in range(3)],
            shifts=i32([[1, 1, 5, 600, 7], [5, 2, 0, 1, 2],
                        [2, 4, 9, 9, 127]]))),
        "hho": (hho, port_hho.fused_hho_run, dict(
            uniforms=[tuple([u(1, n) for _ in range(4)]
                            + [u(d, n) for _ in range(5)]
                            + [nz(d, n), nz(d, n)]) for _ in range(3)],
            shifts=i32([[1, 5], [3, 600], [5, 127]]), t_max=4)),
        "abc": (abc, port_abc.fused_abc_run, dict(
            uniforms=[tuple([u(1, n) for _ in range(5)] + [u(d, n)])
                      for _ in range(3)],
            shifts=i32([[1, 5, 600], [3, 0, 1], [5, 9, 127]]), limit=1)),
        "pt": (tempering, port_pt.fused_pt_run, dict(
            uniforms=[(nz(d, n), u(1, n), u(1, n)) for _ in range(3)],
            swap_every=1)),
    }
    fn, hw = port_obj.get_objective("rastrigin")
    for fam, (ops, run, kw) in cases.items():
        init = getattr(ops, f"{fam}_init")
        to_np = getattr(ops, f"{fam}_state_to_numpy")
        from_np = getattr(ops, f"{fam}_state_from_numpy")
        cpu = init(fn, n, d, hw, seed=2, device="cpu")
        gpu = from_np(to_np(cpu), device=cuda)
        on_cpu = run(cpu, "rastrigin", 3, rng="host", tile_n=tile, **kw)
        to_dev = lambda v: (v.to(cuda) if torch.is_tensor(v)  # noqa: E731
                            else v)
        kw_gpu = {k: ([tuple(to_dev(t) for t in c) for c in v]
                      if k == "uniforms" else to_dev(v))
                  for k, v in kw.items()}
        on_card = to_np(run(gpu, "rastrigin", 3, rng="host", tile_n=tile,
                            **kw_gpu))
        for f, a in to_np(on_cpu).items():
            if fam not in ("hho", "pt") or f in ("temps", "iteration"):
                np.testing.assert_array_equal(on_card[f], a,
                                              err_msg=f"{fam} {f}")
            else:
                tol = 2e-5 if "fit" in f else 1e-5
                np.testing.assert_allclose(on_card[f], a, rtol=tol,
                                           atol=tol, err_msg=f"{fam} {f}")


# --------------------------------------------------------------------------
# Firefly (B19) and ACO (B20, B21)
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.ops import aco as port_aco  # noqa
from distributed_swarm_algorithm_tpu_torch.ops import (  # noqa: E402
    firefly as port_firefly,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (  # noqa: E402
    aco_fused as port_af,
    firefly_fused as port_ff,
)

# The firefly kernel against its plain version: |kernel - plain| <=
# attraction_band(N_j) * (sum_j |W_ij x_j| + (sum_j W_ij) |x_i|) + 1e-6.
# The weights agree bit for bit; the kernel sums over j in f32 tiles of 64,
# the plain version in float64 (ops/cuda/firefly_fused.attraction_band).
FF_ABS_BAND = 1e-6


def _ff_inputs(n, d, seed, device, scale=0.05, ties=False):
    g = np.random.default_rng(seed)
    pos = torch.from_numpy((g.uniform(-5.12, 5.12, (n, d)) * scale)
                           .astype(np.float32)).to(device)
    fit = port_obj.rastrigin(pos)
    if ties:
        fit = torch.round(fit)
    return pos, fit.contiguous()


def _assert_ff_within_band(got, pos, fit, pos_j=None, fit_j=None):
    want = port_ff.firefly_attraction_plain(pos, fit, pos_j=pos_j,
                                            fit_j=fit_j)
    absum = port_ff.attraction_abs_sum(pos, fit, pos_j=pos_j, fit_j=fit_j)
    nj = pos.shape[0] if pos_j is None else pos_j.shape[0]
    err = (got.double() - want.double()).abs()
    bound = port_ff.attraction_band(nj) * absum + FF_ABS_BAND
    assert bool((err <= bound).all()), float((err - bound).max())


def test_firefly_and_aco_wrappers_reject_cpu_tensors():
    pos, fit = _ff_inputs(8, 3, 0, "cpu")
    before = port_ff.LAUNCHES, port_af.DEPOSIT_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        port_ff.firefly_attraction_cuda(pos, fit)
    with pytest.raises(ValueError, match="CUDA"):
        port_af.deposit_matrix_cuda(torch.zeros((2, 4), dtype=torch.int32),
                                    torch.ones(2))
    assert (port_ff.LAUNCHES, port_af.DEPOSIT_LAUNCHES) == before


FF_CASES = [(n, d) for n in (1, 127, 300, 1000) for d in (1, 5, 30, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", FF_CASES,
                         ids=[f"{n}x{d}" for n, d in FF_CASES])
def test_firefly_kernel_matches_plain(cuda, n, d):
    pos, fit = _ff_inputs(n, d, n + d, cuda, scale=0.2 / max(1, d) ** 0.5)
    before = port_ff.LAUNCHES
    got = port_ff.firefly_attraction(pos, fit)
    assert port_ff.LAUNCHES == before + 1
    _assert_ff_within_band(got, pos, fit)
    if n == 1:
        assert not bool(got.abs().any())


@pytest.mark.cuda
def test_firefly_kernel_rectangular_ties_and_checks(cuda):
    pos, fit = _ff_inputs(300, 30, 1, cuda, ties=True)
    pos_j, fit_j = _ff_inputs(1000, 30, 2, cuda, ties=True)
    got = port_ff.firefly_attraction_cuda(pos, fit, pos_j=pos_j, fit_j=fit_j)
    _assert_ff_within_band(got, pos, fit, pos_j, fit_j)
    flat = torch.full_like(fit, 2.0)
    assert not bool(port_ff.firefly_attraction_cuda(pos, flat).abs().any())
    # The whole domain (few pairs attract) and D = 128, the envelope's edge.
    for n, d, scale in ((2000, 30, 1.0), (257, 128, 0.01)):
        pos, fit = _ff_inputs(n, d, 3, cuda, scale=scale)
        _assert_ff_within_band(port_ff.firefly_attraction_cuda(pos, fit),
                               pos, fit)
    before = port_ff.LAUNCHES
    with pytest.raises(ValueError, match="D <= 128"):
        port_ff.firefly_attraction_cuda(*_ff_inputs(8, 129, 0, cuda))
    with pytest.raises(TypeError):
        port_ff.firefly_attraction_cuda(pos.double(), fit)
    with pytest.raises(ValueError, match="contiguous"):
        port_ff.firefly_attraction_cuda(pos.T.contiguous().T, fit)
    assert port_ff.LAUNCHES == before
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    lanes = _build.load("firefly_fused").dsa_firefly_lanes
    lanes.argtypes, lanes.restype = [ctypes.c_int], ctypes.c_int
    for d in (0, 1, 32, 33, 64, 65, 128, 129):
        assert lanes(d) == port_ff.lanes_per_row(d), d


ACO_CASES = [(c, a, q0, rng) for c, a in ((2, 1), (3, 64), (16, 1000),
                                          (129, 64), (256, 1000), (1024, 64))
             for q0 in (0.0, 0.5, 1.0) for rng in ("host", "device")
             if not (rng == "host" and c * c * a > 2**26)]


def _aco_inputs(c, a, seed, device):
    g = np.random.default_rng(seed)
    coords = torch.from_numpy(g.uniform(0, 100, (c, 2)).astype(np.float32))
    dist = port_aco.coords_to_dist(coords).to(device)
    tau = torch.from_numpy(g.uniform(0.5, 2.0, (c, c)).astype(np.float32))
    logits = port_aco.aco_logits(tau.to(device), dist, 1.0, 2.0)
    start = torch.from_numpy(g.integers(0, c, a).astype(np.int32)).to(device)
    u = torch.from_numpy(g.uniform(size=(c - 1, c, a)).astype(np.float32))
    uq = torch.from_numpy(g.uniform(size=(c - 1, a)).astype(np.float32))
    seed_t = torch.tensor([seed + 11], dtype=torch.int32, device=device)
    return logits, dist, start, seed_t, u.to(device), uq.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("c,a,q0,rng", ACO_CASES,
                         ids=[f"C{c}-A{a}-q{q0}-{r}"
                              for c, a, q0, r in ACO_CASES])
def test_aco_kernels_equal_plain(cuda, c, a, q0, rng):
    logits, dist, start, seed, u, uq = _aco_inputs(c, a, c + a, cuda)
    draws = (u, uq) if rng == "host" else (None, None)
    before = port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES
    tours, lengths = port_af.construct_tours_t(logits, dist, start, seed,
                                               q0, *draws)
    want = port_af.construct_tours_plain(logits, dist, start, seed, q0,
                                         *draws)
    assert torch.equal(tours, want[0]) and torch.equal(lengths, want[1])
    assert (torch.sort(tours, 1).values
            == torch.arange(c, device=cuda)).all()
    assert torch.equal(lengths, port_af.tour_lengths_in_order(dist, tours))
    amount = port_aco.rdiv(1.0, lengths)
    d = port_af.deposit_matrix_t(tours, amount)
    assert torch.equal(d, port_af.deposit_matrix_plain(tours, amount))
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_aco_kernels_ties_odd_tours_and_checks(cuda):
    c, a = 129, 64
    _, dist, start, seed, _, _ = _aco_inputs(c, a, 5, cuda)
    flat = torch.zeros((c, c), device=cuda)
    tours, _ = port_af.construct_tours_cuda(flat, dist, start, seed, 1.0)
    assert torch.equal(tours, port_af.construct_tours_plain(
        flat, dist, start, seed, 1.0)[0])
    # Every greedy step is a tie: the lowest unvisited city wins.
    for k in range(a):
        rest = [x for x in range(c) if x != int(start[k])]
        assert tours[k, 1:].tolist() == rest
    # Any tours, in range or not, every ant on the same tour, many ants.
    g = np.random.default_rng(1)
    for tours in (torch.from_numpy(g.integers(-2, 40, (300, 37))
                                   .astype(np.int32)),
                  torch.arange(256, dtype=torch.int32).repeat(1024, 1),
                  torch.from_numpy(g.integers(0, 3, (3000, 3))
                                   .astype(np.int32))):
        tours = tours.to(cuda)
        amount = torch.from_numpy(
            g.uniform(0.1, 2.0, tours.shape[0]).astype(np.float32)).to(cuda)
        assert torch.equal(port_af.deposit_matrix_cuda(tours, amount),
                           port_af.deposit_matrix_plain(tours, amount))
    before = port_af.TOURS_LAUNCHES
    with pytest.raises(ValueError, match="2048"):
        port_af.construct_tours_cuda(torch.zeros((2049, 2049), device=cuda),
                                     torch.zeros((2049, 2049), device=cuda),
                                     start, seed)
    with pytest.raises(TypeError):
        port_af.construct_tours_cuda(flat, dist, start.long(), seed)
    assert port_af.TOURS_LAUNCHES == before


@pytest.mark.cuda
def test_firefly_aco_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    names = ["firefly_fused", "aco_fused"]
    _build.build(names)
    for name in names:
        log = _build.build_log(name)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert spills, (name, log[:400])
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


@pytest.mark.cuda
def test_firefly_aco_runs_never_wait_for_the_device(cuda):
    import warnings

    fn, hw = port_obj.get_objective("rastrigin")
    ff = port_firefly.firefly_init(fn, 3000, 30, hw, seed=0, device=cuda)
    coords = torch.rand((128, 2), generator=torch.Generator().manual_seed(0))
    st = port_aco.aco_init(port_aco.coords_to_dist(coords).to(cuda))
    runs = {
        "firefly": lambda: port_ff.fused_firefly_run(ff, fn, 3,
                                                     half_width=hw),
        "aco": lambda: port_af.fused_aco_run(st, 3, 256, q0=0.2, elite=2.0),
    }
    for name, run in runs.items():
        run()                                   # builds and warms up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert not waits, (name, [str(w.message)[:120] for w in waits])
        best = out.best_fit if name == "firefly" else out.best_len
        assert bool(torch.isfinite(best))


@pytest.mark.cuda
def test_firefly_aco_models_take_the_kernel_and_match_the_cpu(cuda):
    opt = tdsa.Firefly("rastrigin", n=4096, dim=30, seed=0)
    assert opt.use_pallas and opt.device.type == "cuda"
    first, before = opt.best, port_ff.LAUNCHES
    opt.run(4)
    assert port_ff.LAUNCHES == before + 4 and opt.best <= first
    pts = np.random.default_rng(0).uniform(0, 100, (64, 2))
    colony = tdsa.ACO(coords=pts, n_ants=256, seed=0, elite=2.0)
    assert colony.use_pallas
    before = port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES
    colony.run(5)
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == (
        before[0] + 5, before[1] + 5)
    assert sorted(colony.best_tour.tolist()) == list(range(64))
    # Three steps on the card and on the CPU from one state with the same
    # draws handed in.  Firefly: the attraction's sums over j differ (f32
    # tiles against float64), rtol = atol = 1e-5; ACO: tours, best and
    # pheromone equal bit for bit.
    fn, hw = port_obj.get_objective("sphere")
    cpu = port_firefly.firefly_init(fn, 512, 8, hw, seed=1, device="cpu")
    cpu = cpu.replace(pos=cpu.pos * 0.05, fit=fn(cpu.pos * 0.05))
    gpu = port_firefly.firefly_state_from_numpy(
        port_firefly.firefly_state_to_numpy(cpu), device=cuda)
    noises = [torch.rand((512, 8)) for _ in range(3)]
    a = port_ff.fused_firefly_run(cpu, fn, 3, hw, noises=noises)
    b = port_ff.fused_firefly_run(gpu, fn, 3, hw,
                                  noises=[x.to(cuda) for x in noises])
    np.testing.assert_allclose(b.pos.cpu().numpy(), a.pos.numpy(),
                               rtol=1e-5, atol=1e-5)
    dist = port_aco.coords_to_dist(torch.from_numpy(pts.astype(np.float32)))
    cpu = port_aco.aco_init(dist, seed=0)
    gpu = port_aco.aco_state_from_numpy(port_aco.aco_state_to_numpy(cpu),
                                        device=cuda)
    draws = [port_af.host_draws(torch.Generator().manual_seed(k), 64, 128,
                                "cpu") for k in range(3)]
    a = port_af.fused_aco_run(cpu, 3, 128, q0=0.3, elite=2.0, rng="host",
                              draws=draws)
    b = port_af.fused_aco_run(gpu, 3, 128, q0=0.3, elite=2.0, rng="host",
                              draws=[tuple(x.to(cuda) for x in dr)
                                     for dr in draws])
    for f, x in port_aco.aco_state_to_numpy(a).items():
        np.testing.assert_array_equal(
            port_aco.aco_state_to_numpy(b)[f], x, err_msg=f)


# The redesigned separation kernel (one vote a warp per group of senders,
# the force only in the rare branch) and deposit (a stable bucketing of the
# edges by row, then an ordered sum a row) at the edges of their designs.
# A block of the separation kernel holds 256 receivers; a bucketing chunk
# holds max(1024, 4 C) edges, and the fold stages 2,048 edges a pass.
SEP_EDGE_CASES = {
    "below-a-warp-colocated": (5, 2, 1.0, 0.0, True, False),
    "block-and-one-one-dead-receiver": (257, 2, 4.0, 0.0, False, True),
    "all-dead": (1000, 2, 3.0, 1.01, False, False),
    "3d-colocated-20pct-dead": (1000, 3, 5.0, 0.2, True, False),
    "crowded-8192": (8192, 2, 5.0, 0.0, False, False),
    "3d-crowded": (2000, 3, 2.0, 0.0, False, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEP_EDGE_CASES))
def test_separation_kernel_edge_cases(cuda, case):
    n, d, box, dead, co_locate, one_dead = SEP_EDGE_CASES[case]
    rng = np.random.default_rng(n)
    pos = rng.uniform(-box, box, (n, d)).astype(np.float32)
    alive = rng.random(n) >= dead
    if co_locate:
        pos[1] = pos[0]
        pos[2] = pos[0]
        alive[:3] = True
    if one_dead:
        alive[n // 2] = False
    pos, alive = torch.from_numpy(pos).to(cuda), torch.from_numpy(alive).to(
        cuda)
    before = port_sep.LAUNCHES
    got = port_sep.separation_cuda(pos, alive, K_SEP, R, EPS)
    again = port_sep.separation_cuda(pos, alive, K_SEP, R, EPS)
    torch.cuda.synchronize()
    assert port_sep.LAUNCHES == before + 2
    want = port_sep.separation_plain(pos, alive, K_SEP, R, EPS)
    scale = port_sep.separation_abs_sum(pos, alive, K_SEP, R, EPS)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
    assert (got[~alive] == 0).all()
    if co_locate:
        assert torch.equal(got[1], got[0]) and torch.equal(got[2], got[0])


def _perm_tours(c, a, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.argsort(g.random((a, c)), 1).astype(np.int32))


DEPOSIT_EDGE_CASES = {
    "C1": lambda: torch.zeros((7, 1), dtype=torch.int32),
    "C2": lambda: _perm_tours(2, 5, 0),
    "C129-A1": lambda: _perm_tours(129, 1, 1),
    "C2048-A1": lambda: _perm_tours(2048, 1, 2),
    "C2048-A1000": lambda: _perm_tours(2048, 1000, 3),
    "repeated-and-outside": lambda: torch.from_numpy(
        np.random.default_rng(4).integers(-2, 40, (300, 37))
        .astype(np.int32)),
    "one-tour-for-all": lambda: torch.arange(256, dtype=torch.int32)
    .repeat(1024, 1),
    "rows-longer-than-2048": lambda: torch.from_numpy(
        np.random.default_rng(5).integers(0, 2, (4000, 5)).astype(np.int32)),
    "313-chunks": lambda: _perm_tours(16, 20_000, 6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DEPOSIT_EDGE_CASES))
def test_deposit_kernel_edge_cases(cuda, case):
    tours = DEPOSIT_EDGE_CASES[case]().to(cuda)
    amount = torch.from_numpy(np.random.default_rng(7).uniform(
        0.1, 2.0, tours.shape[0]).astype(np.float32)).to(cuda)
    before = port_af.DEPOSIT_LAUNCHES
    got = port_af.deposit_matrix_cuda(tours, amount)
    again = port_af.deposit_matrix_cuda(tours, amount)
    assert port_af.DEPOSIT_LAUNCHES == before + 2
    assert torch.equal(got, port_af.deposit_matrix_plain(tours, amount))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_deposit_reads_the_tours_where_they_lie(cuda):
    tours = _perm_tours(256, 1024, 8).to(cuda)
    amount = torch.rand(1024, device=cuda)
    port_af.deposit_matrix_cuda(tours, amount)       # builds and warms up
    torch.cuda.synchronize()
    before = port_af.DEPOSIT_LAUNCHES
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        d = port_af.deposit_matrix_cuda(tours, amount)
    ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
    # D and the scratch, and no copy of the tours (no transpose).
    assert ops <= {"aten::empty"}, ops
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 2
    assert port_af.DEPOSIT_LAUNCHES == before + 1
    assert torch.equal(d, port_af.deposit_matrix_plain(tours, amount))


@pytest.mark.parametrize("c,a", [(1, 7), (2, 1), (129, 1000), (256, 1024),
                                 (2048, 1000), (16, 20_000)])
def test_deposit_scratch_holds_every_chunk_and_edge(c, a):
    # The kernel's scratch: each chunk's C + 1 row starts, then every edge
    # as two int32 at an 8-byte boundary.
    chunk = max(1024, -(-4 * c // 32) * 32)
    n_chunks = -(-a * c // chunk)
    ints = port_af.deposit_scratch_ints(c, a)
    starts = n_chunks * (c + 1)
    assert ints - 2 * a * c in (starts, starts + 1)
    assert (ints - 2 * a * c) % 2 == 0


@pytest.mark.cuda
def test_separation_build_spills_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["separation"])
    log = _build.build_log("separation")
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert spills, log[:400]
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


@pytest.mark.cuda
def test_separation_and_deposit_never_wait_for_the_device(cuda):
    import warnings

    pos = torch.rand((4096, 2), device=cuda) * 50.0
    alive = torch.ones(4096, dtype=torch.bool, device=cuda)
    tours = _perm_tours(256, 1024, 9).to(cuda)
    amount = torch.rand(1024, device=cuda)
    calls = {
        "separation": lambda: port_sep.separation_cuda(pos, alive, K_SEP, R,
                                                       EPS),
        "deposit": lambda: port_af.deposit_matrix_cuda(tours, amount),
    }
    for name, call in calls.items():
        call()                                  # builds and warms up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert not waits, (name, [str(w.message)[:120] for w in waits])
