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


def _grid_operands(pos, alive, cell, cap, skin, cuda):
    g = (int(2 * HW / (cell + skin)) // 16) * 16
    plan = port_hp.build_hashgrid_plan(pos, alive, HW, cell, cap, g=g,
                                       skin=skin)
    if skin:
        gen = torch.Generator(device=cuda).manual_seed(0)
        pos = pos + 0.34 * (torch.rand(pos.shape, generator=gen,
                                       device=cuda) - 0.5)
    r = port_grid._stencil_radius(plan.cell_eff, R + skin)
    return pos, plan, port_grid.sweep_operands(pos, plan), g, r


def _check_grid_sweep(ops, g, cap, r, budget):
    """The kernel against its plain version, which repeats its operations
    in its order: equal, and so within the band.  Returns (kernel,
    bitwise equal)."""
    args = (ops, g, cap, r, budget, K_SEP, R, EPS, HW)
    before = port_grid.LAUNCHES
    got = port_grid.grid_sweep_cuda(*args)
    torch.cuda.synchronize()
    assert port_grid.LAUNCHES == before + 1
    want = port_grid.grid_sweep_plain(*args)
    scale = port_grid.grid_sweep_plain(*args, absolute=True)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
    assert torch.equal(got, want)
    return got, True


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cell,cap,crowd,skin,budget",
    [(2.0, 8, 0, 0.0, 64), (1.0, 8, 0, 0.0, 64), (2.0, 8, 40, 0.0, 64),
     (1.5, 16, 0, 0.5, 64), (2.0, 8, 120, 0.0, 8), (1.0, 8, 120, 0.0, 16),
     (2.0, 8, 120, 0.0, 0)],
    ids=["R1", "R2", "R1-overflow", "stale-skinned", "R1-past-budget",
         "R2-past-budget", "budget-0"],
)
def test_grid_sweep_kernel_matches_plain(cuda, cell, cap, crowd, skin,
                                         budget):
    pos, alive = _hash_swarm(600, 3, crowd)
    pos, alive = pos.to(cuda), alive.to(cuda)
    pos, plan, ops, g, r = _grid_operands(pos, alive, cell, cap, skin, cuda)
    got, _ = _check_grid_sweep(ops, g, cap, r, budget)
    assert (got[~alive] == 0).all()
    assert (int(plan.cap_overflow) > 0) == bool(crowd)
    if crowd > 100:
        assert int(plan.cap_overflow) > budget
    # The whole slots path against the CPU's.
    kw = dict(cell=cell + skin, max_per_cell=cap, torus_hw=HW,
              overflow_budget=budget)
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
    pos, alive = _hash_swarm(64, 1)
    pos, alive = pos.to(cuda), alive.to(cuda)
    plan = port_hp.build_hashgrid_plan(pos, alive, HW, 2.0, 8, g=16)
    ops = port_grid.sweep_operands(pos, plan)
    args = (16, 8, 1, 64, K_SEP, R, EPS, HW)
    with pytest.raises(TypeError):
        port_grid.grid_sweep_cuda(ops._replace(spos=ops.spos.double()),
                                  *args)
    with pytest.raises(ValueError):
        port_grid.grid_sweep_cuda(ops._replace(bounds=ops.bounds[:-1]),
                                  *args)
    with pytest.raises(ValueError):
        port_grid.grid_sweep_cuda(ops._replace(order=ops.order.long()),
                                  *args)
    with pytest.raises(ValueError):
        port_grid.grid_sweep_cuda(ops, 16, 8, 3, 64, K_SEP, R, EPS, HW)


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
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skin0", "stale", "partial-chain",
                                  "truncated", "crowded-receivers", "wide",
                                  "widest", "narrow"])
def test_candidate_kernel_matches_plain(cuda, case):
    crowd = {"truncated": 60, "crowded-receivers": 150}.get(case, 0)
    pos, alive = _hash_swarm(800, 5, crowd=crowd)
    pos, alive = pos.to(cuda), alive.to(cuda)
    if case == "truncated":    # cand rows past W and receivers past RK
        plan = _cand_plan(pos, alive, cap=8, skin=0.0, w=32, rk=8)
        assert int(plan.cand_overflow) > 0 and int(plan.recv_overflow) > 0
    elif case == "crowded-receivers":   # cells of more than 32 receivers
        plan = _cand_plan(pos, alive, cap=64, skin=0.0, w=384, rk=96)
        assert int(plan.counts.max()) > 32
    elif case in ("wide", "widest"):    # 4 cells a warp, and 1
        plan = _cand_plan(pos, alive, skin=0.5,
                          w=256 if case == "wide" else 1024)
        assert port_cand.cells_per_warp(plan.cand.shape[1]) in (4, 1)
    elif case == "narrow":              # 6 cells a warp, rows of 32
        plan = _cand_plan(pos, alive, skin=0.5, w=32, rk=8)
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
    # A per-tick plan (skin 0) never reads from the device, ticked by hand
    # or replayed; a carried Verlet plan reads its refresh decision once a
    # tick when ticked by hand (eagerly), and once a chunk of
    # HASHGRID_CHUNK ticks when its rollout is replayed: 2 reads in 20
    # ticks, where the eager rollout read 20.  A chunk in which a tick
    # needed a full rebuild (forced by a crosser cap of 2) reads its flag
    # and then once a tick of its eager rerun: 1 + HASHGRID_CHUNK reads.
    import warnings

    from distributed_swarm_algorithm_tpu_torch.models import swarm as swm
    from distributed_swarm_algorithm_tpu_torch.models.swarm import (
        HASHGRID_CHUNK,
        _swarm_tick_plan,
    )

    base = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", world_hw=24.0, formation_shape="none",
        max_speed=5.0, hashgrid_overflow_budget=64, grid_max_per_cell=8)
    s = tdsa.make_swarm(512, device=cuda, spread=18.0, seed=4)
    s = s.replace(target=torch.full_like(s.pos, 3.0),
                  has_target=torch.ones_like(s.has_target))
    ticks = 2 * HASHGRID_CHUNK
    jitter = torch.zeros((ticks, 512), dtype=torch.int32, device=cuda)
    # The carried plan on a world wide enough that its partial refresh
    # never needs a full rebuild in these ticks (as the fast movers' 1,000
    # ticks need none): a rerun chunk would read once a tick.
    carried = base.replace(hashgrid_kernel="candidates", hashgrid_skin=1.5,
                           grid_max_per_cell=24, hashgrid_neighbor_cap=48,
                           hashgrid_partial_refresh=True, world_hw=64.0)
    forced = carried.replace(hashgrid_partial_crosser_cap=2)
    for cfg, by_hand, syncs in ((base, True, 0), (base, False, 0),
                                (carried, True, 6), (carried, False, 2),
                                (forced, False, 1 + HASHGRID_CHUNK)):
        n_ticks = 6 if by_hand else (
            HASHGRID_CHUNK if cfg is forced else ticks)
        # Warm up: the rollout captures its chunk here, and runs the ticks
        # measured below.
        _, plan = tdsa.swarm_rollout(s, None, cfg, ticks, jitter=jitter,
                                     return_plan=True)
        assert plan is None or (int(plan.rebuilds) > 0) == (cfg is forced)
        plan = tdsa.build_tick_plan(s, cfg) if cfg is carried else None
        reruns = swm.CHUNKS_RERUN
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                st = s
                if not by_hand:
                    st = tdsa.swarm_rollout(st, None, cfg, n_ticks,
                                            jitter=jitter[:n_ticks])
                for k in range(n_ticks if by_hand else 0):
                    if plan is None:
                        st = tdsa.swarm_tick(st, None, cfg, jitter[k])
                    else:
                        st, plan = _swarm_tick_plan(st, None, cfg, plan,
                                                    jitter[k])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in seen if "synchroniz" in str(w.message)]
        assert len(waits) == syncs, [str(w.message)[:120] for w in waits]
        assert swm.CHUNKS_RERUN - reruns == (cfg is forced)


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
        _mfo_fixed_moths(g, pos, flames, hw)
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


def _mfo_fixed_moths(g, pos, flames, hw):
    """About half the moths set equal to their flames (those below
    n_flames start at the fixed point, B16's stopped moths): one with a
    flame component of -0 beside its +0, one at a flame outside the
    domain, which must move."""
    d, n = pos.shape
    same = torch.from_numpy(np.nonzero(g.uniform(size=n) < 0.5)[0]).to(
        pos.device)
    pos[:, same] = flames[:, same]
    flames[0, same[0]], pos[0, same[0]] = -0.0, 0.0
    flames[min(1, d - 1), same[1]] = pos[min(1, d - 1), same[1]] = 2 * hw


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
    # B16's redesign: D mod 4 of 0, 1, 3 beside 2; the main path's shape
    # at 4 tiles; D = 908, the first version.
    ("mfo", "rastrigin", 4096, 30, 8, "device", 1024),
    ("mfo", "sphere", 1024, 28, 8, "device", 256),
    ("mfo", "schwefel", 1000, 29, 5, "device", 200),
    ("mfo", "griewank", 512, 31, 3, "device", 128),
    ("mfo", "rastrigin", 256, 908, 2, "device", 128),
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
def test_ga_kernel_keeps_each_tile_in_step(cuda, monkeypatch, k):
    # Parent A reads the tile's current generation and the elitism its
    # argmin and argmax at every step: k generations in one launch equal
    # the plain version's k, at 4 tiles of 4,096 lanes (clusters of 16
    # blocks of 256 lanes) and at tiles of 1,000 lanes (4 blocks of 250),
    # rastrigin and griewank, in both variants.
    for second in (False, True):
        for n, tile_n, name in ((16384, 4096, "rastrigin"),
                                (4000, 1000, "rastrigin"),
                                (4000, 1000, "griewank")):
            with monkeypatch.context() as m:
                _ga_equal(m, second, name, n, 30, k, "device", cuda, tile_n)


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
    # The GA entry's geometry check takes what ga_geometry picks, and the
    # first version at any shape.
    ok = _build.load("ga_fused").dsa_ga_fused_geometry_ok
    ok.argtypes, ok.restype = [ctypes.c_int] * 7, ctypes.c_int
    for d in (1, 4, 30, 31, 55, 56, 226, 227, 1000, 3618, 3619):
        for tile_n in (77, 96, 100, 128, 1000, 4096, 8192, 16384):
            assert ok(*port_ga.ga_geometry(d, tile_n), tile_n, d) == 1
            assert ok(*port_ga.global_geometry(d, tile_n), tile_n, d) == 1
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


# --------------------------------------------------------------------------
# The redesigned firefly kernel (B19): the fitness-sorted triangle schedule
# and its edges, each call twice and the same bits; and the redesigned
# grey-wolf kernel (B8): equal to its plain version bit for bit across the
# width and group boundaries, and its hoisted Philox helper equal to
# philox4x32_10.
# --------------------------------------------------------------------------


def _ff_ordered(n, d, seed, device, order, scale=0.05):
    """(pos, fit) with the rows placed in sorted, reverse-sorted or shuffled
    order of fitness."""
    pos, fit = _ff_inputs(n, d, seed, device, scale=scale)
    idx = torch.sort(fit, stable=True).indices
    if order == "reverse":
        idx = idx.flip(0)
    elif order == "shuffled":
        idx = torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(
            device)
    return pos[idx].contiguous(), fit[idx].contiguous()


def _ff_twice(pos, fit, pos_j=None, fit_j=None):
    before = port_ff.LAUNCHES
    got = port_ff.firefly_attraction_cuda(pos, fit, pos_j=pos_j, fit_j=fit_j)
    again = port_ff.firefly_attraction_cuda(pos, fit, pos_j=pos_j,
                                            fit_j=fit_j)
    torch.cuda.synchronize()
    assert port_ff.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    _assert_ff_within_band(got, pos, fit, pos_j, fit_j)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "reverse", "shuffled"])
@pytest.mark.parametrize("n,d", [(3000, 30), (1000, 40), (700, 100)])
def test_firefly_redesign_within_band_on_any_order(cuda, order, n, d):
    _ff_twice(*_ff_ordered(n, d, n + d, cuda, order,
                           scale=0.2 / d ** 0.5))


FF_EDGE_FITS = {
    # all equal: no pair is brighter, every move is 0
    "all-equal": lambda g, n: np.full(n, 3.0),
    # runs of 50 equal values that straddle the tiles of 64
    "ties-across-tiles": lambda g, n: np.floor(g.permutation(n) / 50.0),
    "nan-and-inf": lambda g, n: np.where(
        g.random(n) < 0.1, np.nan, np.where(
            g.random(n) < 0.1, np.inf, np.where(g.random(n) < 0.1, -np.inf,
                                                g.standard_normal(n)))),
    "signed-zeros": lambda g, n: g.choice([-0.0, 0.0, -1.0, 1.0], n),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FF_EDGE_FITS))
def test_firefly_redesign_edge_fitness(cuda, case):
    g = np.random.default_rng(len(case))
    n = 1000
    pos, _ = _ff_inputs(n, 30, 5, cuda)
    fit = torch.from_numpy(FF_EDGE_FITS[case](g, n).astype(np.float32)).to(
        cuda)
    got = _ff_twice(pos, fit)
    if case == "all-equal":
        assert not bool(got.abs().any())
    finite = torch.isfinite(fit)
    if case == "nan-and-inf":
        # A NaN row is never attracted; a -inf row has nothing brighter.
        assert not bool(got[torch.isnan(fit)].abs().any())
        assert not bool(got[fit == -np.inf].abs().any())
        assert bool(got[finite].abs().any())
    if case == "signed-zeros":
        # -0 and +0 are equal: the zero rows move only toward the -1s.
        want = port_ff.firefly_attraction_plain(
            pos, torch.where(fit == 0, torch.zeros_like(fit), fit))
        assert bool(((got - want).abs()
                     <= port_ff.attraction_band(n)
                     * port_ff.attraction_abs_sum(pos, fit) + 1e-6).all())


@pytest.mark.cuda
def test_firefly_redesign_rectangular_sorted_apart(cuda):
    # Rows and sources sorted separately, the sources' fitness on another
    # scale and reversed, with ties on both sides.
    pos, fit = _ff_ordered(700, 30, 11, cuda, "shuffled")
    pos_j, fit_j = _ff_ordered(2500, 30, 12, cuda, "reverse")
    fit = torch.round(fit * 4.0) / 4.0
    fit_j = torch.round(fit_j * 2.0) / 2.0
    _ff_twice(pos, fit, pos_j, fit_j)
    # A source swarm of one: at most one tile per block.
    _ff_twice(pos, fit, pos_j[:1].contiguous(), fit_j[:1].contiguous())


@pytest.mark.cuda
def test_firefly_redesign_16384_narrow(cuda):
    # bench_firefly_64k.py's second row, drawn 50 times narrower than its
    # domain so that the accumulation runs; the grid splits the sources.
    pos, fit = _ff_inputs(16_384, 30, 7, cuda, scale=0.02)
    splits, _ = port_ff.split_plan(16_384, 16_384, 30,
                                   port_ff._sm_count(cuda.index or 0))
    assert splits > 1
    _ff_twice(pos, fit)


@pytest.mark.cuda
def test_firefly_redesign_exports_and_never_waits(cuda):
    import ctypes
    import warnings

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    lib = _build.load("firefly_fused")
    rows = lib.dsa_firefly_rows_per_block
    rows.argtypes, rows.restype = [ctypes.c_int], ctypes.c_int
    work = lib.dsa_firefly_workspace_floats
    work.argtypes = [ctypes.c_int] * 5
    work.restype = ctypes.c_longlong
    for d in (0, 1, 30, 32, 33, 64, 65, 128, 129):
        assert rows(d) == port_ff.rows_per_block(d), d
        if port_ff.rows_per_block(d):
            for n, nj, s, sq in ((1, 1, 1, 1), (1000, 1000, 16, 1),
                                 (300, 1000, 3, 0), (65_536, 65_536, 2, 1)):
                assert work(n, nj, d, s, sq) == port_ff.workspace_floats(
                    n, nj, d, s, bool(sq)), (d, n, nj, s, sq)
    # Neither the sort nor the schedule nor the launch reads the device.
    pos, fit = _ff_inputs(5000, 30, 3, cuda)
    pos_j, fit_j = _ff_inputs(2000, 30, 4, cuda)
    calls = [lambda: port_ff.firefly_attraction_cuda(pos, fit),
             lambda: port_ff.firefly_attraction_cuda(pos, fit, pos_j=pos_j,
                                                     fit_j=fit_j)]
    for call in calls:
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
        assert not waits, [str(w.message)[:120] for w in waits]


GWO_WIDTHS = [1, 3, 4, 5, 30, 31, 32, 33, 100, 908]


@pytest.mark.cuda
@pytest.mark.parametrize("k,rng", [(1, "host"), (1, "device"), (8, "device")])
@pytest.mark.parametrize("d", GWO_WIDTHS)
def test_gwo_redesign_equals_plain_across_widths(cuda, d, k, rng):
    n = 300 if d < 900 else 97
    _, plain, args, kw = _family_case("gwo", "rastrigin", n, d, k, rng,
                                      cuda, seed=d)
    kw["step0"] += 12345            # a nonzero global step
    before = port_gwo.LAUNCHES
    got = port_gwo.fused_gwo_step_cuda(*args, **kw)
    again = port_gwo.fused_gwo_step_cuda(*args, **kw)
    assert port_gwo.LAUNCHES == before + 2
    want = plain(*args, **kw)
    _assert_family_equal("rastrigin", got, want)
    _assert_family_equal("rastrigin", again, want)


@pytest.mark.cuda
def test_gwo_hoisted_philox_equals_philox4x32_10(cuda):
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    fn = _build.load("gwo_fused").dsa_gwo_philox_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = np.random.default_rng(0)
    edges = [0, 1, 2, 3, 2**31 - 1, 2**31, 2**32 - 1]
    grid = np.array(np.meshgrid(edges, [0, 1, 7, 2**32 - 1], [0, 1, 2**32 - 1],
                                [0, 1, 2025, 2**32 - 1]),
                    dtype=np.int64).reshape(4, -1)
    grid = np.concatenate([grid, g.integers(0, 2**32, (4, 4096))], 1)
    cols = [torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(cuda)
            for c in grid]
    m = grid.shape[1]
    out = torch.empty((m, 16), dtype=torch.int32, device=cuda)
    err = fn(*(c.data_ptr() for c in cols), m, out.data_ptr(), cuda.index or 0,
             torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    words = out.cpu().numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(words[:, :8], words[:, 8:])
    # ...and both equal the plain version's words (ops/cuda/pso_fused.py).
    lane, grp, ctr, seed = (torch.from_numpy(c) for c in grid)
    for s in (0, 1):
        want = torch.stack(port_pf.philox4x32_10(lane, grp, ctr, s, seed, 0),
                           1).numpy()
        assert np.array_equal(words[:, 4 * s:4 * s + 4], want), s


@pytest.mark.cuda
def test_redesigned_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    names = ["firefly_fused", "gwo_fused"]
    _build.build(names)
    for name, kernels in (("firefly_fused", ("attract_kernel", "prep_kernel",
                                             "combine_kernel")),
                          ("gwo_fused", ("gwo_fused_kernel",
                                         "philox_check_kernel"))):
        log = _build.build_log(name)
        for kernel in kernels:
            assert kernel in log, (name, kernel)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert len(spills) >= len(kernels), (name, spills)
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


# --------------------------------------------------------------------------
# The redesigned tour kernel (B20: a team of lanes an ant, the next step's
# draws ahead, redux reductions and a named barrier a step), the colony run
# replayed from one CUDA graph, and the redesigned PSO kernel (B5 and B6:
# hoisted Philox pairs, a template on D mod 4 and on the objective, the
# gbest column staged) at the edges of their designs.  Tours, lengths and
# the PSO state equal the plain versions' under torch.equal (ackley within
# its expf band, as above).
# --------------------------------------------------------------------------

def _team_edges():
    """C at every edge of the tour team: 4 lanes +- 1 for each team size
    and blocks a lane, C not a multiple of 4, the smallest and the
    largest."""
    cs = {2, 3, 5, 2047, 2048}
    for cities in (128, 256, 512, 1024):
        cs.update((cities - 1, cities, cities + 1))
    return sorted(cs)


# A is odd, so never a multiple of the 2, 4 or 8 ants of a block.
TEAM_CASES = [(c, a, q0, rng) for i, c in enumerate(_team_edges())
              for a, q0, rng in (((3, 37, 129)[i % 3], 0.0, "device"),
                                 ((5, 3)[i % 2], (0.5, 1.0)[i % 2], "host"),
                                 (9, 0.3, "device"))]


def _team_inputs(c, a, seed, device, host):
    """Scores, dist, starts and seed of C cities for A ants, and host draws
    (u [C - 1, C, A], uq [C - 1, A]) made on the card where asked."""
    g = np.random.default_rng(seed)
    coords = torch.from_numpy(g.uniform(0, 100, (c, 2)).astype(np.float32))
    dist = port_aco.coords_to_dist(coords).to(device)
    tau = torch.from_numpy(g.uniform(0.5, 2.0, (c, c)).astype(np.float32))
    logits = port_aco.aco_logits(tau.to(device), dist, 1.0, 2.0)
    start = torch.from_numpy(g.integers(0, c, a).astype(np.int32)).to(device)
    seed_t = torch.tensor([seed + 11], dtype=torch.int32, device=device)
    draws = (None, None)
    if host:
        gen = torch.Generator(device=device).manual_seed(seed)
        draws = (torch.rand((c - 1, c, a), generator=gen, device=device),
                 torch.rand((c - 1, a), generator=gen, device=device))
    return logits, dist, start, seed_t, draws


@pytest.mark.cuda
@pytest.mark.parametrize("c,a,q0,rng", TEAM_CASES,
                         ids=[f"C{c}-A{a}-q{q0}-{r}"
                              for c, a, q0, r in TEAM_CASES])
def test_tours_redesign_equals_plain_at_team_edges(cuda, c, a, q0, rng):
    assert a % port_af.tour_geometry(c).ants_per_block
    logits, dist, start, seed, draws = _team_inputs(c, a, c + 7 * a, cuda,
                                                    rng == "host")
    before = port_af.TOURS_LAUNCHES
    tours, lengths = port_af.construct_tours_cuda(logits, dist, start, seed,
                                                  q0, *draws)
    again = port_af.construct_tours_cuda(logits, dist, start, seed, q0,
                                         *draws)
    assert port_af.TOURS_LAUNCHES == before + 2
    want = port_af.construct_tours_plain(logits, dist, start, seed, q0,
                                         *draws)
    assert torch.equal(tours, want[0]) and torch.equal(lengths, want[1])
    assert torch.equal(again[0], tours) and torch.equal(again[1], lengths)
    assert (torch.sort(tours, 1).values
            == torch.arange(c, device=cuda)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [129, 256, 1000])
@pytest.mark.parametrize("q0", [0.0, 0.5, 1.0])
def test_tours_redesign_ties_go_to_the_lowest_city(cuda, c, q0):
    # Constant scores and one uniform for every city: every step of either
    # rule is a tie among the open cities, across the lanes and warps of a
    # team, and the lowest open city wins.
    a = 11
    _, dist, start, seed, _ = _team_inputs(c, a, 3, cuda, False)
    flat = torch.zeros((c, c), device=cuda)
    u = torch.full((c - 1, c, a), 0.25, device=cuda)
    uq = torch.full((c - 1, a), 0.4, device=cuda)
    tours, lengths = port_af.construct_tours_cuda(flat, dist, start, seed,
                                                  q0, u, uq)
    want = port_af.construct_tours_plain(flat, dist, start, seed, q0, u, uq)
    assert torch.equal(tours, want[0]) and torch.equal(lengths, want[1])
    for k in range(a):
        rest = [x for x in range(c) if x != int(start[k])]
        assert tours[k, 1:].tolist() == rest


@pytest.mark.cuda
@pytest.mark.parametrize("c", [7, 256, 700])
def test_tours_redesign_invalid_starts(cuda, c):
    # An ant starting outside [0, C) gets tour -1 and length NaN; the
    # others are the plain version's, whatever their neighbours in the
    # team's block do.
    a = 13
    logits, dist, start, seed, _ = _team_inputs(c, a, c, cuda, False)
    bad = torch.tensor([0, 4, 5, 12])
    start = start.clone()
    start[bad.to(cuda)] = torch.tensor([-1, c, -7, 2**30], dtype=torch.int32,
                                       device=cuda)
    tours, lengths = port_af.construct_tours_cuda(logits, dist, start, seed)
    assert (tours[bad] == -1).all() and torch.isnan(lengths[bad]).all()
    ok = torch.ones(a, dtype=torch.bool)
    ok[bad] = False
    fixed = torch.where(ok.to(cuda), start, torch.zeros_like(start))
    want = port_af.construct_tours_plain(logits, dist, fixed, seed)
    assert torch.equal(tours[ok], want[0][ok])
    assert torch.equal(lengths[ok], want[1][ok])


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [
    (96, 2, 1, 256),        # a team that is not 1, 2 or 4 warps
    (64, 2, 1, 256),        # teams that do not fill a block
    (64, 4, 3, 256),        # three blocks of four a lane
    (32, 8, 1, 0),          # 128 slots for 200 cities
    (64, 4, 1, 0),          # no room for the warps' exchange
], ids=["lanes96", "ants2", "per_lane3", "short", "no_shared"])
def test_tours_entry_rejects_a_geometry_it_cannot_run(cuda, monkeypatch,
                                                       geo):
    # The wrapper hands tour_geometry's team to the entry, which checks it:
    # a geometry its kernels cannot run launches nothing and counts nothing.
    logits, dist, start, seed, _ = _team_inputs(200, 9, 4, cuda, False)
    monkeypatch.setattr(port_af, "tour_geometry",
                        lambda c: port_af.TourGeometry(*geo))
    before = port_af.TOURS_LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        port_af.construct_tours_cuda(logits, dist, start, seed)
    assert port_af.TOURS_LAUNCHES == before


def _eager_aco(state, n_steps, n_ants, out, **kw):
    for _ in range(n_steps):
        state = port_af.fused_aco_step(state, n_ants, out=out, **kw)
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("c,a,q0,elite", [(256, 1024, 0.0, 3.0),
                                          (131, 77, 0.1, 4.0)],
                         ids=["C256-A1024", "C131-A77-q0.1"])
def test_graph_replayed_aco_run_equals_the_eager_loop(cuda, c, a, q0, elite):
    coords = torch.rand((c, 2), generator=torch.Generator().manual_seed(c))
    dist = port_aco.coords_to_dist(coords * 100.0).to(cuda)
    kw = dict(q0=q0, elite=elite)
    eager_out, graph_out = {}, {}
    eager = _eager_aco(port_aco.aco_init(dist, seed=5), 21, a, eager_out,
                       **kw)
    st = port_aco.aco_init(dist, seed=5)
    before = port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES
    graph = port_af.fused_aco_run(st, 21, a, out=graph_out, **kw)
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == (
        before[0] + 21, before[1] + 21)
    captured = port_af._replay.graph
    for f in ("tau", "best_tour", "best_len", "iteration"):
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    for f in ("tours", "lengths"):
        assert torch.equal(graph_out[f], eager_out[f]), f
    assert int(graph.iteration) == 21
    # The graph advanced the generator as the eager loop did; a second run
    # from there replays the same capture and goes on equal, and neither
    # run wrote the state it was given.
    assert torch.equal(graph.gen.get_state(), eager.gen.get_state())
    tau = graph.tau.clone()
    again = port_af.fused_aco_run(graph, 3, a, **kw)
    assert port_af._replay.graph is captured
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == (
        before[0] + 24, before[1] + 24)
    eager = _eager_aco(eager, 3, a, None, **kw)
    assert torch.equal(again.tau, eager.tau)
    assert torch.equal(again.best_tour, eager.best_tour)
    assert int(st.iteration) == 0 and torch.equal(graph.tau, tau)


@pytest.mark.cuda
def test_graph_replayed_aco_run_counts_and_raises(cuda):
    coords = torch.rand((64, 2), generator=torch.Generator().manual_seed(1))
    st = port_aco.aco_init(port_aco.coords_to_dist(coords).to(cuda))
    before = port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES
    out = port_af.fused_aco_run(st, 0, 32)
    assert out is st
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == before
    with pytest.raises(ValueError, match="host"):
        port_af.fused_aco_run(st, 2, 32, draws=[None, None])
    # A step the kernels do not take raises during the capture; nothing
    # runs eagerly in its place.
    with pytest.raises(ValueError, match="2048"):
        port_af.fused_aco_run(port_aco.aco_init(torch.zeros(
            (2049, 2049), device=cuda)), 2, 4)
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == before
    # A run of other parameters captures anew; the next run of the same
    # colony replays that capture.
    one = port_af.fused_aco_run(st, 2, 32)
    first = port_af._replay.graph
    two = port_af.fused_aco_run(one, 1, 32, elite=1.0)
    assert port_af._replay.graph is not first
    second = port_af._replay.graph
    port_af.fused_aco_run(two, 1, 32, elite=1.0)
    assert port_af._replay.graph is second
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == (
        before[0] + 4, before[1] + 4)


@pytest.mark.cuda
def test_graph_replayed_aco_run_counts_what_its_capture_launched(
        cuda, monkeypatch):
    # Each replay adds the launches its capture recorded; a capture that
    # recorded other than one launch of each kernel raises and is not
    # kept, and a graph the caller captures counts nothing.
    coords = torch.rand((40, 2), generator=torch.Generator().manual_seed(4))
    st = port_aco.aco_init(port_aco.coords_to_dist(coords).to(cuda))
    step = port_af.fused_aco_step

    def two_deposits(state, *args, **kw):
        nxt = step(state, *args, **kw)
        port_af.fused_deposit_matrix(kw["out"]["tours"], kw["out"]["lengths"])
        return nxt

    monkeypatch.setattr(port_af, "fused_aco_step", two_deposits)
    before = port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES
    with pytest.raises(RuntimeError, match="once each"):
        port_af.fused_aco_run(st, 3, 16, rho=0.3)
    assert port_af._replay is None
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == before
    logits = port_aco.aco_logits(st.tau, st.dist, 1.0, 2.0)
    start = torch.zeros(16, dtype=torch.int32, device=cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tours, lengths = port_af.construct_tours_cuda(logits, st.dist, start,
                                                      seed)
        port_af.deposit_matrix_cuda(tours, 1.0 / lengths)
    graph.replay()
    assert (port_af.TOURS_LAUNCHES, port_af.DEPOSIT_LAUNCHES) == before


PSO_REDESIGN_DIMS = [1, 2, 3, 4, 5, 31, 64, 129]


@pytest.mark.cuda
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize("k_steps,rng", [(1, "host"), (8, "device")])
@pytest.mark.parametrize("d", PSO_REDESIGN_DIMS)
def test_pso_redesign_equals_plain_across_widths(cuda, name, k_steps, rng, d):
    n = 333
    hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = _pso_inputs(
        name, n, d, d + 3, cuda)
    kw = dict(objective_name=name, half_width=hw, rng=rng, k_steps=k_steps,
              track_best=True, step0=2**32 - 3)
    rr = (r1, r2) if rng == "host" else (None, None)
    got = port_pf.fused_pso_step_cuda(seed, gbest, pos, vel, bpos, bfit,
                                      *rr, **kw)
    want = port_pf.fused_pso_step_plain(seed, gbest, pos, vel, bpos, bfit,
                                        *rr, **kw)
    _assert_kernel_equals_plain(name, got, want, bfit, k_steps)
    if name != "ackley":
        assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rastrigin", "schwefel", "levy"])
@pytest.mark.parametrize("k_steps,rng", [(1, "host"), (8, "device")])
@pytest.mark.parametrize("d,n_l", [(3, 157), (30, 256), (13, 64), (65, 300)])
def test_islands_redesign_equals_plain(cuda, name, k_steps, rng, d, n_l):
    # n_l = 256 puts every 128-thread block inside one island (the column
    # staged in shared memory); 157, 64 and 300 give blocks that span
    # islands (read from global memory).
    n_i = 3
    hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = _pso_inputs(
        name, n_i * n_l, d, d + n_l, cuda, islands=n_i)
    kw = dict(objective_name=name, half_width=hw, lanes_per_island=n_l,
              rng=rng, k_steps=k_steps, step0=11)
    rr = (r1, r2) if rng == "host" else (None, None)
    got = port_isl.islands_step_cuda(seed, gbest, pos, vel, bpos, bfit, *rr,
                                     **kw)
    want = port_isl.islands_step_plain(seed, gbest, pos, vel, bpos, bfit,
                                       *rr, **kw)
    _assert_kernel_equals_plain(name, got, want, bfit, k_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 6, 30])
@pytest.mark.parametrize("step0", [0, 12345, 2**32 - 1])
def test_pso_redesign_draws_both_streams(cuda, d, step0):
    # The hoisted Philox pair at PSO's counters (lane, d // 4, step, stream):
    # with w = 0 and one of c1, c2 zero, one step leaves vel equal to the
    # other stream's uniforms, which must be philox4x32_10's.
    n = 1000
    seed = torch.tensor([987 + d], dtype=torch.int32, device=cuda)
    zeros = torch.zeros((d, n), device=cuda)
    ones = zeros + 1.0
    common = dict(objective_name="sphere", w=0.0, half_width=100.0,
                  k_steps=1, step0=step0, track_best=False)
    r1 = port_pf.fused_pso_step_cuda(
        seed, torch.zeros((d, 1), device=cuda), zeros, zeros, ones,
        torch.zeros((1, n), device=cuda), c1=1.0, c2=0.0, **common)[1]
    r2 = port_pf.fused_pso_step_cuda(
        seed, torch.ones((d, 1), device=cuda), zeros, zeros, zeros,
        torch.zeros((1, n), device=cuda), c1=0.0, c2=1.0, **common)[1]
    assert torch.equal(r1, port_pf.philox_uniforms(seed, n, d, step0, 0))
    assert torch.equal(r2, port_pf.philox_uniforms(seed, n, d, step0, 1))


@pytest.mark.cuda
def test_pso_aco_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["aco_fused", "pso_fused"])
    # Tours: 3 team widths of blocks x 3 rules x 2 sources of the draws;
    # PSO: 4 classes of D mod 4 x 10 objectives x 2 sources.
    for name, kernel, variants in (("aco_fused", "tours_kernel", 18),
                                   ("pso_fused", "pso_fused_kernel", 80)):
        log = _build.build_log(name)
        entries = [ln for ln in log.splitlines()
                   if "Compiling entry" in ln and kernel in ln]
        assert len(entries) == variants, (name, len(entries))
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


# --------------------------------------------------------------------------
# The redesigned cuckoo kernel (B12: a tile on chip across a thread-block
# cluster, the eggs read through distributed shared memory) and DE kernel
# (B10: each block's donor windows staged once a launch, no trial tile),
# each in both its variants, against their plain versions under
# torch.equal (ackley within its expf band, as above), and the one-stream
# hoisted Philox of the DE kernel.
# --------------------------------------------------------------------------

REDESIGN_WIDTHS = [4, 5, 30, 31]          # D mod 4 = 0, 1, 2, 3
REDESIGN_STEPS = [(1, "host"), (8, "device"), (32, "device")]
CUCKOO_DE = {"cuckoo": (_levy_case, port_cuckoo, "cuckoo_geometry"),
             "de": (_rot_case, port_de, "de_geometry")}


def _cuckoo_de_equal(fam, name, n, d, k, rng, device, tile_n, seed=0,
                     lanes=None, **kw_extra):
    make, mod, _ = CUCKOO_DE[fam]
    kernel, plain, args, kw = make(fam, name, n, d, k, rng, device, tile_n,
                                   seed=seed)
    if lanes is not None:      # the lane shifts, in place of the drawn ones
        args[0][-3:] = torch.tensor(lanes, dtype=torch.int32)
    kw.update(kw_extra)
    before = mod.LAUNCHES
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    assert mod.LAUNCHES == before + 2
    want = plain(*args, **kw)
    _assert_family_equal(name, got, want)
    _assert_family_equal(name, again, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(CUCKOO_DE))
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize("k,rng", REDESIGN_STEPS)
@pytest.mark.parametrize("d", REDESIGN_WIDTHS)
def test_cuckoo_de_redesign_equals_plain_across_widths(cuda, fam, name, k,
                                                      rng, d):
    # Four tiles of 4,096 lanes: cuckoo's tile across a cluster of 16
    # blocks of 256 lanes, DE's blocks of 512 (D = 4, 5), 192 (30) or 160
    # (31) lanes, ragged at the tile's end where they do not divide it.
    _cuckoo_de_equal(fam, name, 16384, d, k, rng, cuda, 4096, seed=d,
                     step0=2**32 - 5)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(CUCKOO_DE))
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("n,d,tile_n", [(16384, 30, 4096), (4000, 33, 1000),
                                        (512, 8, 128), (480, 30, 96)])
def test_cuckoo_de_redesign_lane_shifts_at_the_tile_edge(
        cuda, monkeypatch, fam, second, n, d, tile_n):
    # Every lane shift at tile_n - 1 (and 2 tile_n - 1), so each roll wraps
    # at the tile's edge; DE's windows at a tile of 96 lanes are longer
    # than the tile and wrap more than once.
    _, mod, geometry = CUCKOO_DE[fam]
    if second:
        monkeypatch.setattr(mod, geometry, mod.global_geometry)
    for lanes in ([tile_n - 1] * 3, [2 * tile_n - 1, tile_n - 1, 0]):
        _cuckoo_de_equal(fam, "rastrigin", n, d, 8, "device", cuda, tile_n,
                         lanes=lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("knob", [0.0, 1.0])
def test_cuckoo_de_redesign_at_the_knobs_edges(cuda, monkeypatch, second,
                                               knob):
    # CR 0 (no gene crosses: every trial is x) and 1 (every gene does); pa
    # 0 (no lane walks) and 1 (every lane does).
    for fam in CUCKOO_DE:
        _, mod, geometry = CUCKOO_DE[fam]
        if second:
            monkeypatch.setattr(mod, geometry, mod.global_geometry)
        extra = {"cr": knob} if fam == "de" else {"pa": knob}
        _cuckoo_de_equal(fam, "sphere", 16384, 30, 8, "device", cuda, 4096,
                         **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("fam,name,n,d,k,rng,tile_n", [
    ("cuckoo", "rastrigin", 32768, 8, 8, "device", 8192),   # 16 x 512 lanes
    ("cuckoo", "levy", 8192, 100, 4, "device", 1024),       # 4 x 256 lanes
    ("cuckoo", "griewank", 65536, 30, 3, "device", 16384),  # second variant
    ("cuckoo", "sphere", 512, 2500, 2, "device", 128),      # 16 x 8 lanes
    ("cuckoo", "sphere", 512, 3600, 2, "device", 128),      # second variant
    ("cuckoo", "schwefel", 2048, 31, 1, "host", 512),
    ("de", "levy", 2048, 70, 4, "device", 512),             # a mask word
    ("de", "rosenbrock", 1024, 200, 2, "device", 256),      # second variant
    ("de", "zakharov", 640, 179, 3, "device", 160),         # 32 lanes a block
    ("de", "styblinski_tang", 1536, 64, 1, "host", 384),
], ids=lambda v: str(v))
def test_cuckoo_de_redesign_geometries(cuda, fam, name, n, d, k, rng,
                                       tile_n):
    _cuckoo_de_equal(fam, name, n, d, k, rng, cuda, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("fam,geo", [
    ("cuckoo", (0, 3, 1366, 1376, 0)),          # a cluster of 3
    ("cuckoo", (0, 16, 250, 256, 62592)),       # lanes short of the tile
    ("cuckoo", (0, 16, 256, 256, 62588)),       # bytes not its layout's
    ("cuckoo", (0, 4, 1024, 1024, 0)),          # 1,024 lanes a block
    ("cuckoo", (1, 1, 4096, 256, 0)),           # not the first version's
    ("de", (0, 100, 0)),                        # not whole warps
    ("de", (0, 192, 115436)),                   # bytes not its layout's
    ("de", (0, 1024, 0)),                       # past 512 lanes
    ("de", (1, 64, 15360)),                     # not the first version's
], ids=lambda v: str(v))
def test_cuckoo_de_entries_reject_a_geometry_they_cannot_run(
        cuda, monkeypatch, fam, geo):
    # The wrapper hands its geometry to the entry, which checks it: one the
    # kernels cannot run launches nothing and counts nothing.
    make, mod, geometry = CUCKOO_DE[fam]
    tup = port_de.DeGeometry if fam == "de" else port_cuckoo.CuckooGeometry
    monkeypatch.setattr(mod, geometry, lambda d, t: tup(*geo))
    kernel, _, args, kw = make(fam, "sphere", 16384, 30, 2, "device", cuda,
                               4096)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*args, **kw)
    assert mod.LAUNCHES == before


@pytest.mark.cuda
def test_de_hoisted_philox_equals_philox4x32_10(cuda):
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    fn = _build.load("de_fused").dsa_de_philox_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = np.random.default_rng(1)
    edges = [0, 1, 2, 2**31 - 1, 2**31, 2**32 - 1]
    grid = np.array(np.meshgrid(edges, [0, 1, 7, 2**32 - 1],
                                [0, 1, 2**32 - 1], [0, 1, 2, 3],
                                [0, 2025, 2**32 - 1]),
                    dtype=np.int64).reshape(5, -1)
    grid = np.concatenate([grid, g.integers(0, 2**32, (5, 4096))], 1)
    cols = [torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(cuda)
            for c in grid]
    m = grid.shape[1]
    out = torch.empty((m, 8), dtype=torch.int32, device=cuda)
    err = fn(*(c.data_ptr() for c in cols), m, out.data_ptr(),
             cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    words = out.cpu().numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(words[:, :4], words[:, 4:])
    # ...and both equal the plain version's words (ops/cuda/pso_fused.py).
    lane, grp, ctr, stream, seed = (torch.from_numpy(c) for c in grid)
    for s in range(4):
        pick = (stream == s).numpy()
        want = torch.stack(port_pf.philox4x32_10(
            lane[pick], grp[pick], ctr[pick], s, seed[pick], 0), 1).numpy()
        assert np.array_equal(words[pick, :4], want), s


@pytest.mark.cuda
def test_cuckoo_de_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["cuckoo_fused", "de_fused"])
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws, beside
    # the second variant (and DE's Philox check).
    for name, kernel, variants, others in (
            ("cuckoo_fused", "cuckoo_cluster_kernel", 80,
             ("cuckoo_global_kernel",)),
            ("de_fused", "de_staged_kernel", 80,
             ("de_global_kernel", "philox_check_kernel"))):
        log = _build.build_log(name)
        entries = [ln for ln in log.splitlines()
                   if "Compiling entry" in ln and kernel in ln]
        assert len(entries) == variants, (name, len(entries))
        for other in others:
            assert other in log, (name, other)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


# --------------------------------------------------------------------------
# The redesigned bat kernel (B7: no candidate tile, the eps stream's Philox
# hoisted) and ABC kernel (B17: a tile on chip across a thread-block
# cluster, one coordinate of a partner read a candidate), each in both its
# variants, against their plain versions under torch.equal (ackley within
# its expf band, as above), and the bat kernel's hoisted Philox.
# --------------------------------------------------------------------------

BAT_ABC_WIDTHS = [1, 4, 5, 30, 31]        # D mod 4 = 1, 0, 1, 2, 3
BAT_ABC_STEPS = [(1, "host"), (8, "device")]
# family -> (case maker, module, geometry function, the second variant's)
BAT_ABC = {"bat": (_family_case, port_bat, "bat_geometry",
                   "candidate_tile_geometry"),
           "abc": (_levy_case, port_abc, "abc_geometry", "global_geometry")}


def _bat_abc_case(fam, name, n, d, k, rng, device, tile_n=None, seed=0,
                  lanes=None, limit=20, **extra):
    make, mod, _, _ = BAT_ABC[fam]
    if fam == "bat":
        kernel, plain, args, kw = make(fam, name, n, d, k, rng, device,
                                       seed=seed)
    else:
        kernel, plain, args, kw = make(fam, name, n, d, k, rng, device,
                                       tile_n, seed=seed, limit=limit)
    if lanes is not None:      # ABC's lane shifts, in place of the drawn
        args[0][-2:] = torch.tensor(lanes, dtype=torch.int32)
    kw.update(extra)
    return kernel, plain, args, kw


def _bat_abc_equal(monkeypatch, fam, second, name, n, d, k, rng, device,
                   tile_n=None, **extra):
    _, mod, geometry, second_geometry = BAT_ABC[fam]
    if second:
        monkeypatch.setattr(mod, geometry, getattr(mod, second_geometry))
    kernel, plain, args, kw = _bat_abc_case(fam, name, n, d, k, rng, device,
                                            tile_n, **extra)
    before = mod.LAUNCHES
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    assert mod.LAUNCHES == before + 2
    want = plain(*args, **kw)
    _assert_family_equal(name, got, want)
    _assert_family_equal(name, again, want)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(BAT_ABC))
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize("k,rng", BAT_ABC_STEPS)
@pytest.mark.parametrize("d", BAT_ABC_WIDTHS)
def test_bat_abc_redesign_equals_plain_across_widths(cuda, monkeypatch, fam,
                                                    second, name, k, rng, d):
    # Bat: 3,000 bats, the last block ragged; ABC: four tiles of 4,096
    # lanes, each across a cluster of 16 blocks of 256 lanes (trials drawn
    # up to the limit, so scouts fire).  The global step wraps at 2^32.
    n, tile_n = (3000, None) if fam == "bat" else (16384, 4096)
    _bat_abc_equal(monkeypatch, fam, second, name, n, d, k, rng, cuda,
                   tile_n, seed=d, step0=2**32 - 5)


@pytest.mark.cuda
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("n,d,tile_n", [(16384, 30, 4096), (4000, 33, 1000),
                                        (512, 8, 128), (480, 30, 96)])
def test_abc_redesign_lane_shifts_at_the_tile_edge(cuda, monkeypatch, second,
                                                  n, d, tile_n):
    # Both lane shifts at tile_n - 1 (and 2 tile_n - 1 with 0), so each
    # partner roll wraps at the tile's edge: in a cluster's first and last
    # blocks, and where the tile is a block of its own.
    for lanes in ([tile_n - 1] * 2, [2 * tile_n - 1, 0]):
        _bat_abc_equal(monkeypatch, "abc", second, "rastrigin", n, d, 8,
                       "device", cuda, tile_n, lanes=lanes, limit=2)


@pytest.mark.cuda
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("pulse", [0.0, 1.0])
def test_bat_redesign_every_bat_walks_or_flies(cuda, monkeypatch, second,
                                               pulse):
    # Pulse 0: every bat walks (the model's first launch); pulse 1: none
    # does.  A walking bat that is accepted draws its eps groups again.
    _, mod, geometry, second_geometry = BAT_ABC["bat"]
    if second:
        monkeypatch.setattr(mod, geometry, getattr(mod, second_geometry))
    kernel, plain, args, kw = _bat_abc_case("bat", "rastrigin", 3000, 30, 8,
                                            "device", cuda)
    args[7] = torch.full_like(args[7], pulse)
    before = mod.LAUNCHES
    got = kernel(*args, **kw)
    assert mod.LAUNCHES == before + 1
    want = plain(*args, **kw)
    _assert_family_equal("rastrigin", got, want)
    # Some bats were accepted (their loudness fell), some were not.
    fell = got[3] < args[6]
    assert bool(fell.any()) and not bool(fell.all())


@pytest.mark.cuda
def test_abc_redesign_every_lane_probed(cuda, monkeypatch):
    # Every fitness at -1: no candidate beats it, every quality is 2, so
    # the gate passes every lane (the onlooker evaluates everywhere).
    for second in (False, True):
        _, mod, geometry, second_geometry = BAT_ABC["abc"]
        with monkeypatch.context() as m:
            if second:
                m.setattr(mod, geometry, getattr(mod, second_geometry))
            kernel, plain, args, kw = _bat_abc_case(
                "abc", "rastrigin", 16384, 30, 8, "device", cuda, 4096)
            args[2] = torch.full_like(args[2], -1.0)
            args[3] = torch.zeros_like(args[3])
            counts = {}
            want = plain(*args, **kw, counts=counts)
            assert all(int(p) == 16384 for p in counts["probed"])
            _assert_family_equal("rastrigin", kernel(*args, **kw), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fam,name,n,d,k,rng,tile_n,variant", [
    ("abc", "rastrigin", 32768, 8, 8, "device", 8192, 0),   # 16 x 512
    ("abc", "levy", 8192, 100, 4, "device", 1024, 0),       # 4 x 256 lanes
    ("abc", "sphere", 4000, 30, 8, "device", 1000, 0),      # 4 x 250 lanes
    ("abc", "griewank", 32768, 30, 3, "device", 16384, 1),  # no cluster
    ("abc", "rastrigin", 8192, 226, 2, "device", 4096, 0),  # 226 KB blocks
    ("abc", "schwefel", 8192, 227, 2, "device", 4096, 1),   # past them
    ("abc", "michalewicz", 500, 3, 8, "device", 100, 0),    # one block
    ("abc", "zakharov", 2048, 31, 1, "host", 512, 0),
    ("bat", "rastrigin", 700, 2, 8, "device", None, 0),     # no chunk of 4
    ("bat", "ackley", 700, 3, 8, "device", None, 0),
    ("bat", "styblinski_tang", 300, 226, 3, "device", None, 0),
    ("bat", "rastrigin", 300, 227, 3, "device", None, 1),   # first version
    ("bat", "rosenbrock", 100, 605, 2, "device", None, 1),  # 32 a block
    ("bat", "levy", 129, 64, 1, "host", None, 0),
], ids=lambda v: str(v))
def test_bat_abc_redesign_geometries(cuda, monkeypatch, fam, name, n, d, k,
                                     rng, tile_n, variant):
    _, mod, geometry, _ = BAT_ABC[fam]
    geo = (getattr(mod, geometry)(d) if fam == "bat"
           else getattr(mod, geometry)(d, tile_n))
    assert geo.variant == variant
    _bat_abc_equal(monkeypatch, fam, False, name, n, d, k, rng, cuda, tile_n,
                   **({"limit": 2} if fam == "abc" else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("fam,geo", [
    ("bat", (0, 64, 4 * (2 * 30 * 64 + 32))),   # not 128 bats a block
    ("bat", (0, 128, 30720)),                   # bytes not its layout's
    ("bat", (1, 64, 3 * 30 * 64 * 4)),          # not the first version's
    ("bat", (2, 128, 0)),                       # no such variant
    ("abc", (0, 3, 1366, 1376, 0)),             # a cluster of 3
    ("abc", (0, 16, 250, 256, 30000)),          # lanes short of the tile
    ("abc", (0, 16, 256, 256, 30720)),          # bytes not its layout's
    ("abc", (0, 4, 1024, 1024, 0)),             # 1,024 lanes a block
    ("abc", (1, 1, 4096, 256, 0)),              # not the first version's
], ids=lambda v: str(v))
def test_bat_abc_entries_reject_a_geometry_they_cannot_run(
        cuda, monkeypatch, fam, geo):
    # The wrapper hands its geometry to the entry, which checks it: one the
    # kernels cannot run launches nothing and counts nothing.
    _, mod, geometry, _ = BAT_ABC[fam]
    tup = port_bat.BatGeometry if fam == "bat" else port_abc.TileGeometry
    monkeypatch.setattr(mod, geometry, lambda *shape: tup(*geo))
    kernel, _, args, kw = _bat_abc_case(fam, "sphere", 16384, 30, 2,
                                        "device", cuda, 4096)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*args, **kw)
    assert mod.LAUNCHES == before


@pytest.mark.cuda
def test_bat_hoisted_philox_equals_philox4x32_10(cuda):
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    fn = _build.load("bat_fused").dsa_bat_philox_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = np.random.default_rng(2)
    edges = [0, 1, 2, 2**31 - 1, 2**31, 2**32 - 1]
    grid = np.array(np.meshgrid(edges, [0, 1, 7, 151, 2**32 - 1],
                                [0, 1, 2**32 - 1], [0, 2025, 2**32 - 1]),
                    dtype=np.int64).reshape(4, -1)
    grid = np.concatenate([grid, g.integers(0, 2**32, (4, 4096))], 1)
    grid[1, -2048:] = g.integers(0, 8, 2048)     # the groups a run draws
    cols = [torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(cuda)
            for c in grid]
    m = grid.shape[1]
    out = torch.empty((m, 16), dtype=torch.int32, device=cuda)
    err = fn(*(c.data_ptr() for c in cols), m, out.data_ptr(),
             cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    words = out.cpu().numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(words[:, :8], words[:, 8:])
    # ...and both equal the plain version's words (ops/cuda/pso_fused.py):
    # the eps stream's group, then the row.
    lane, grp, ctr, seed = (torch.from_numpy(c) for c in grid)
    eps = torch.stack(port_pf.philox4x32_10(lane, grp, ctr, 0, seed, 0), 1)
    row = torch.stack(port_pf.philox4x32_10(lane, torch.zeros_like(grp), ctr,
                                            1, seed, 0), 1)
    assert np.array_equal(words[:, :4], eps.numpy())
    assert np.array_equal(words[:, 4:8], row.numpy())


@pytest.mark.cuda
def test_bat_abc_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["bat_fused", "abc_fused"])
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws, beside
    # the second variant (and the bat kernel's Philox check).
    for name, kernel, variants, others in (
            ("bat_fused", "bat_step_kernel", 80,
             ("bat_cand_tile_kernel", "philox_check_kernel")),
            ("abc_fused", "abc_cluster_kernel", 80, ("abc_global_kernel",))):
        log = _build.build_log(name)
        entries = [ln for ln in log.splitlines()
                   if "Compiling entry" in ln and kernel in ln]
        assert len(entries) == variants, (name, len(entries))
        for other in others:
            assert other in log, (name, other)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


# --------------------------------------------------------------------------
# The redesigned parallel-tempering kernel (B18: windows of 256 threads
# owning 256 - 2h chains, the Philox pair hoisted, the candidate stored in a
# second plane, the running best kept per warp) and Harris-hawks
# kernel (B13: lanes regrouped by branch inside each block), in every
# variant, against their plain versions under torch.equal (ackley within
# its expf band, as above), and their hoisted Philox.
# --------------------------------------------------------------------------

PT_HHO_WIDTHS = [1, 4, 5, 30, 31]        # D mod 4 = 1, 0, 1, 2, 3
# fam -> (module, geometry function, {variant: its geometry function},
# the launch's steps with device draws).
PT_HHO = {"pt": (port_pt, "pt_geometry",
                 {"main": port_pt.pt_geometry,
                  "second": port_pt.candidate_tile_geometry}, 16),
          "hho": (port_hho, "hho_geometry",
                  {"main": port_hho.hho_geometry,
                   "second": port_hho.trial_tile_geometry}, 8)}
PT_HHO_VARIANTS = [(fam, v) for fam, spec in PT_HHO.items()
                   for v in spec[2]]


def _pt_hho_equal(monkeypatch, fam, variant, name, n, d, k, rng, device,
                  tile_n, step0=None, **extra):
    """Both launches of one case equal the plain version's; returns the
    case's arguments."""
    mod, geometry, variants, _ = PT_HHO[fam]
    monkeypatch.setattr(mod, geometry, variants[variant])
    kernel, plain, args, kw = _levy_case(fam, name, n, d, k, rng, device,
                                         tile_n, **extra)
    if step0 is not None:
        kw["step0"] = step0
    before = mod.LAUNCHES
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    assert mod.LAUNCHES == before + 2
    want = plain(*args, **kw)
    _assert_family_equal(name, got, want)
    _assert_family_equal(name, again, want)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("fam,variant", PT_HHO_VARIANTS,
                         ids=[f"{f}-{v}" for f, v in PT_HHO_VARIANTS])
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize("rng", ["host", "device"])
@pytest.mark.parametrize("d", PT_HHO_WIDTHS)
def test_pt_hho_redesign_equals_plain_across_widths(cuda, monkeypatch, fam,
                                                   variant, name, rng, d):
    # Four tiles of 1,000 lanes (PT: four blocks of 248 chains a tile and
    # a partial fifth, the last three chains padding; HHO: blocks of 256
    # hawks across the tiles, the last one ragged); k = 1 with the draws
    # handed in, else the family's cap with device draws, the global step
    # wrapping at 2^32.
    k = 1 if rng == "host" else PT_HHO[fam][3]
    extra = dict(n_real=3997) if fam == "pt" else {}
    _pt_hho_equal(monkeypatch, fam, variant, name, 4000, d, k, rng, cuda,
                  1000, seed=d, step0=2**32 - 5, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(PT_HHO["pt"][2]))
@pytest.mark.parametrize("swap_every", [1, 5])
@pytest.mark.parametrize("n,tile_n,n_real", [(16384, 4096, 16384),
                                             (16384, 4096, 16000),
                                             (2000, 1000, 1993),
                                             (512, 128, 500)])
def test_pt_redesign_rounds_and_padding(cuda, monkeypatch, variant,
                                        swap_every, n, tile_n, n_real):
    # The widest halo (swap_every = 1: 16 rounds, windows owning 224
    # chains) and the main path's (5: 248); a tile of 4,096 in 17 blocks,
    # one of 1,000, and one of 128 that a single window holds with room to
    # spare; padded chains (n_real < n) never exchange.
    args, kw = _pt_hho_equal(monkeypatch, "pt", variant, "rastrigin", n, 30,
                             16, "device", cuda, tile_n,
                             swap_every=swap_every, n_real=n_real)
    counts = {}
    port_pt.fused_pt_step_plain(*args, **kw, counts=counts)
    assert int(sum(counts["swapped"])) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(PT_HHO["hho"][2]))
@pytest.mark.parametrize("klass", ["perch", "below", "besiege", "dive"])
def test_hho_redesign_every_lane_in_one_class(cuda, monkeypatch, variant,
                                              klass):
    # Rows chosen so that every hawk takes one branch (|E| = 1.9 explores,
    # 0 exploits; u_q and u_r pick within): the sort puts every lane in one
    # class and no warp diverges.
    mod = port_hho
    monkeypatch.setattr(mod, "hho_geometry", PT_HHO["hho"][2][variant])
    kernel, plain, args, kw = _levy_case("hho", "rastrigin", 4000, 30, 1,
                                         "host", cuda, 1000)
    rows = {"perch": (0.99, 0.25, 0.75, 0.0), "below": (0.99, 0.25, 0.25, 0.0),
            "besiege": (0.5, 0.25, 0.0, 0.75),
            "dive": (0.5, 0.25, 0.0, 0.25)}[klass]
    draws = list(args[-1])
    draws[:4] = [torch.full_like(draws[0], v) for v in rows]
    args[-1] = tuple(draws)
    args[0][2] = 0                             # t0: frac = 1 / t_max
    counts = {}
    want = plain(*args, **kw, counts=counts)
    explore, dive = int(counts["explore"][0]), int(counts["dive"][0])
    assert (explore, dive) == {"perch": (4000, 0), "below": (4000, 0),
                               "besiege": (0, 0), "dive": (0, 4000)}[klass]
    frac = port_hho.step_fraction(args[0][2].cpu(), 0, kw["t_max"])
    cls = port_hho.lane_classes(*(torch.tensor([v]) for v in
                                  (rows[0], rows[2], rows[3])), frac)
    assert int(cls) == getattr(port_hho, klass.upper())
    _assert_family_equal("rastrigin", kernel(*args, **kw), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fam,name,n,d,k,rng,tile_n,extra,want", [
    ("pt", "rastrigin", 4096, 109, 16, "device", 4096,
     dict(swap_every=1), (0,)),                    # two planes, the widest
    ("pt", "sphere", 4096, 110, 16, "device", 4096,
     dict(swap_every=1), (1,)),                    # past them: the first
    ("pt", "schwefel", 2048, 215, 4, "device", 1024,
     dict(swap_every=1), (1,)),                    # version
    ("pt", "levy", 1024, 360, 16, "device", 512,
     dict(swap_every=1), (1,)),                    # 32 lanes a block
    ("pt", "zakharov", 512, 64, 1, "host", 128, {}, (0,)),
    ("hho", "rastrigin", 4096, 111, 8, "device", 1024, {}, (0,)),
    ("hho", "ackley", 2048, 112, 8, "device", 1024, {}, (1,)),
    ("hho", "styblinski_tang", 1024, 605, 2, "device", 512, {}, (1,)),
    ("hho", "michalewicz", 1000, 2, 8, "device", 200, {}, (0,)),
    ("hho", "levy", 512, 64, 1, "host", 256, {}, (0,)),
], ids=lambda v: str(v))
def test_pt_hho_redesign_geometries(cuda, monkeypatch, fam, name, n, d, k,
                                    rng, tile_n, extra, want):
    mod, geometry, _, _ = PT_HHO[fam]
    geo = (getattr(mod, geometry)(d, port_pt.halo(k, extra.get(
        "swap_every", 5))) if fam == "pt" else getattr(mod, geometry)(d))
    assert tuple(geo[:len(want)]) == want
    _pt_hho_equal(monkeypatch, fam, "main", name, n, d, k, rng, cuda,
                  tile_n, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("fam,geo", [
    # k = 2 steps, swap_every = 5: a halo of 1, windows owning 254 chains.
    ("pt", (0, 128, 126, 4 * (2 * 30 * 256 + 240 + 1024))),     # not 256
    ("pt", (0, 256, 248, 4 * (2 * 30 * 256 + 240 + 1024))),     # not 256-2h
    ("pt", (0, 256, 254, 4 * (30 * 256 + 240 + 1024))),         # bytes
    ("pt", (1, 96, 64, 4 * ((2 * 96 + 64) * 30 + 288))),        # not its
    ("pt", (2, 256, 254, 0)),                                   # no variant
    ("hho", (0, 128, 4 * (2 * 30 * 128 + 64 + 512 + 8))),       # not 256
    ("hho", (0, 256, 30720)),                                   # bytes
    ("hho", (1, 64, 3 * 30 * 64 * 4)),                          # not its
    ("hho", (2, 256, 0)),                                       # no variant
], ids=lambda v: str(v))
def test_pt_hho_entries_reject_a_geometry_they_cannot_run(
        cuda, monkeypatch, fam, geo):
    # The wrapper hands its geometry to the entry, which checks it: one the
    # kernels cannot run launches nothing and counts nothing.
    mod, geometry, _, _ = PT_HHO[fam]
    tup = port_pt.PtGeometry if fam == "pt" else port_hho.HhoGeometry
    monkeypatch.setattr(mod, geometry, lambda *shape: tup(*geo))
    kernel, _, args, kw = _levy_case(fam, "sphere", 16384, 30, 2, "device",
                                     cuda, 4096)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*args, **kw)
    assert mod.LAUNCHES == before


def _philox_check_words(cuda, source, entry, width):
    """The check entry's words [m, width] for counters (lane, group, step,
    seed) at the edges of 32 bits and drawn, and those counters."""
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    fn = getattr(_build.load(source), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = np.random.default_rng(3)
    edges = [0, 1, 2, 2**31 - 1, 2**31, 2**32 - 1]
    grid = np.array(np.meshgrid(edges, [0, 1, 7, 151, 2**32 - 1],
                                [0, 1, 2**32 - 1], [0, 2025, 2**32 - 1]),
                    dtype=np.int64).reshape(4, -1)
    grid = np.concatenate([grid, g.integers(0, 2**32, (4, 4096))], 1)
    grid[1, -2048:] = g.integers(0, 8, 2048)     # the groups a run draws
    cols = [torch.from_numpy(c.astype(np.uint32).view(np.int32)).to(cuda)
            for c in grid]
    m = grid.shape[1]
    out = torch.empty((m, width), dtype=torch.int32, device=cuda)
    err = fn(*(c.data_ptr() for c in cols), m, out.data_ptr(),
             cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    words = out.cpu().numpy().view(np.uint32).astype(np.int64)
    return words, [torch.from_numpy(c) for c in grid]


@pytest.mark.cuda
def test_pt_hho_hoisted_philox_equals_philox4x32_10(cuda):
    # PT: streams 0 and 1 from the pair call, the row (stream 2) from
    # philox_one.cuh.  HHO: the generalised pair for streams 0 and 1, 2 and
    # 3, 5 and 6, stream 4 and the row (stream 7) from philox_one.cuh.
    # Each beside philox4x32_10's words on the card, and those beside the
    # plain version's (ops/cuda/pso_fused.py).
    for source, entry, width, streams in (
            ("tempering_fused", "dsa_pt_philox_check", 24, (0, 1, 2)),
            ("hho_fused", "dsa_hho_philox_check", 64,
             (0, 1, 2, 3, 5, 6, 4, 7))):
        words, (lane, grp, ctr, seed) = _philox_check_words(
            cuda, source, entry, width)
        half = width // 2
        assert np.array_equal(words[:, :half], words[:, half:]), source
        for k, s in enumerate(streams):
            # The row, last, takes group 0.
            g = torch.zeros_like(grp) if k == len(streams) - 1 else grp
            want = torch.stack(port_pf.philox4x32_10(lane, g, ctr, s, seed,
                                                     0), 1)
            assert np.array_equal(words[:, 4 * k:4 * k + 4],
                                  want.numpy()), (source, s)


@pytest.mark.cuda
def test_pt_hho_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["tempering_fused", "hho_fused"])
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws, beside
    # the second variant and the Philox check.
    for name, kernel, variants, others in (
            ("tempering_fused", "pt_step_kernel", 80,
             ("pt_cand_tile_kernel", "philox_check_kernel")),
            ("hho_fused", "hho_sorted_kernel", 80,
             ("hho_trial_tile_kernel", "philox_check_kernel"))):
        log = _build.build_log(name)
        entries = [ln for ln in log.splitlines()
                   if "Compiling entry" in ln and kernel in ln]
        assert len(entries) == variants, (name, len(entries))
        for other in others:
            assert other in log, (name, other)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


# --------------------------------------------------------------------------
# The redesigned GA kernel (B15: a tile's two generations on chip across a
# thread-block cluster, the Philox streams hoisted, one power a draw) in
# both its variants against its plain version under torch.equal (ackley
# within its expf band, as above), the geometries its entry takes and
# refuses, its builds.
# --------------------------------------------------------------------------

GA_WIDTHS = [1, 4, 5, 30, 31]             # D mod 4 = 1, 0, 1, 2, 3
GA_STEPS = [(1, "host"), (8, "device")]


def _ga_equal(monkeypatch, second, name, n, d, k, rng, device, tile_n,
              seed=0, lanes=None, **extra):
    """Two launches of the GA kernel (the second variant where ``second``)
    equal to the plain version's one, each counted once."""
    if second:
        monkeypatch.setattr(port_ga, "ga_geometry", port_ga.global_geometry)
    kernel, plain, args, kw = _rot_case("ga", name, n, d, k, rng, device,
                                        tile_n, seed=seed)
    if lanes is not None:      # the three lane shifts, in place of the drawn
        args[0][-3:] = torch.tensor(lanes, dtype=torch.int32)
    kw.update(extra)
    before = port_ga.LAUNCHES
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    assert port_ga.LAUNCHES == before + 2
    want = plain(*args, **kw)
    _assert_family_equal(name, got, want)
    _assert_family_equal(name, again, want)
    assert float(got[0].abs().max()) <= np.float32(kw["half_width"])


@pytest.mark.cuda
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize("k,rng", GA_STEPS)
@pytest.mark.parametrize("d", GA_WIDTHS)
def test_ga_redesign_equals_plain_across_widths(cuda, monkeypatch, second,
                                                name, k, rng, d):
    # Four tiles of 4,096 lanes, each across a cluster of 16 blocks of 256
    # lanes; the global step wraps at 2^32.
    _ga_equal(monkeypatch, second, name, 16384, d, k, rng, cuda, 4096,
              seed=d, step0=2**32 - 5)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n,cluster,lanes", [
    (128, 1, 128), (512, 2, 256), (1000, 4, 250), (2048, 8, 256),
    (4096, 16, 256), (8192, 16, 512)])
@pytest.mark.parametrize("d", [30, 31])
def test_ga_redesign_every_cluster_size(cuda, monkeypatch, tile_n, cluster,
                                        lanes, d):
    # Variant 0 in clusters of 1 to 16 blocks; a tile of 1,000 leaves six
    # threads of each block of 250 lanes idle, a block not a whole number of
    # warps' lanes.
    assert port_ga.ga_geometry(d, tile_n)[:3] == (0, cluster, lanes)
    _ga_equal(monkeypatch, False, "rastrigin", 4 * tile_n, d, 8, "device",
              cuda, tile_n)
    _ga_equal(monkeypatch, False, "sphere", 4 * tile_n, d, 1, "host", cuda,
              tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("second", [False, True], ids=["main", "second"])
@pytest.mark.parametrize("n,d,tile_n", [(16384, 30, 4096), (4000, 33, 1000),
                                        (512, 8, 128), (32768, 30, 8192)])
def test_ga_redesign_lane_shifts_at_the_tile_edge(cuda, monkeypatch, second,
                                                 n, d, tile_n):
    # Every lane shift at tile_n - 1, then past the tile and below 0, so each
    # roll wraps at the tile's edge: in a cluster's first and last blocks,
    # and where the tile is a block of its own.
    for lanes in ([tile_n - 1] * 3, [2 * tile_n - 1, 0, -1]):
        with monkeypatch.context() as m:
            _ga_equal(m, second, "rastrigin", n, d, 8, "device", cuda,
                      tile_n, lanes=lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,d,k,rng,tile_n,variant", [
    ("rastrigin", 32768, 55, 2, "device", 8192, 0),   # 225 KB blocks
    ("levy", 32768, 56, 2, "device", 8192, 1),        # past them
    ("griewank", 65536, 30, 3, "device", 16384, 1),   # no cluster
    ("michalewicz", 500, 3, 8, "device", 100, 0),     # one block
    ("rosenbrock", 512, 226, 2, "device", 128, 0),    # 2 blocks of 64
    ("sphere", 512, 3618, 1, "device", 128, 0),       # 16 blocks of 8
    ("schwefel", 512, 3619, 1, "device", 128, 1),     # past them
    ("zakharov", 2048, 31, 1, "host", 512, 0),
], ids=lambda v: str(v))
def test_ga_redesign_geometries(cuda, monkeypatch, name, n, d, k, rng,
                                tile_n, variant):
    assert port_ga.ga_geometry(d, tile_n).variant == variant
    _ga_equal(monkeypatch, False, name, n, d, k, rng, cuda, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [
    (0, 3, 1366, 1376, 0),              # a cluster of 3
    (0, 16, 250, 256, 4 * (2 * 30 * 250 + 500 + 202)),  # short of the tile
    (0, 16, 256, 256, 61440),           # bytes not its layout's
    (0, 4, 1024, 1024, 0),              # 1,024 lanes a block
    (1, 1, 4096, 256, 0),               # not the first version's threads
    (2, 1, 4096, 512, 0),               # no such variant
], ids=lambda v: str(v))
def test_ga_entry_rejects_a_geometry_it_cannot_run(cuda, monkeypatch, geo):
    # The wrapper hands its geometry to the entry, which checks it: one the
    # kernels cannot run launches nothing and counts nothing.
    monkeypatch.setattr(port_ga, "ga_geometry",
                        lambda *shape: port_ga.TileGeometry(*geo))
    kernel, _, args, kw = _rot_case("ga", "sphere", 16384, 30, 2, "device",
                                    cuda, 4096)
    before = port_ga.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*args, **kw)
    assert port_ga.LAUNCHES == before


@pytest.mark.cuda
def test_ga_reciprocal_equals_the_ieee_division(cuda):
    # beta's second arm divides 1 by 2 (1 - u) + 1e-12 without the IEEE
    # division's slow-path branch (csrc/ga_fused.cu: recip_rn): bit for bit
    # the division's quotient on every float u in (1/2, 1), the kernel's
    # own and the plain version's on the CPU.
    import ctypes

    from distributed_swarm_algorithm_tpu_torch.ops._numerics import rdiv
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    fn = _build.load("ga_fused").dsa_ga_recip_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    u = torch.arange(0x3F000001, 0x3F800000, dtype=torch.int32).view(
        torch.float32)
    out = torch.empty((u.numel(), 2), dtype=torch.float32, device=cuda)
    err = fn(u.to(cuda).data_ptr(), out.data_ptr(), u.numel(),
             cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    got = out.cpu()
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    assert torch.equal(bits(got[:, 0]), bits(got[:, 1]))
    assert torch.equal(bits(got[:, 0]),
                       bits(rdiv(1.0, 2.0 * (1.0 - u) + 1e-12)))


@pytest.mark.cuda
def test_ga_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["ga_fused"])
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws, beside
    # the second variant and the reciprocal's check.
    log = _build.build_log("ga_fused")
    entries = [ln for ln in log.splitlines()
               if "Compiling entry" in ln and "ga_cluster_kernel" in ln]
    assert len(entries) == 80, len(entries)
    assert "ga_global_kernel" in log and "recip_check_kernel" in log
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert spills
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


# --------------------------------------------------------------------------
# The redesigned salp kernel (B9: blocks owning up to 512 lanes with their
# 16 halo columns on threads of their own, one staged buffer, one barrier a
# step, the winner rebuilt by a replay) and whale kernel (B11: lanes
# regrouped by branch inside each block, A and C drawn only where a whale
# contracts), against their plain versions under torch.equal (ackley within
# its expf band, as above).
# --------------------------------------------------------------------------

from test_torch_salp_woa_geometry import winner_case  # noqa: E402

SALP_WOA_WIDTHS = [1, 4, 5, 30, 31]        # D mod 4 = 1, 0, 1, 2, 3
# fam -> the launch's steps with device draws.
SALP_WOA_STEPS = {"salp": 16, "woa": 8}


def _salp_woa_equal(fam, name, n, d, k, rng, device, tile_n, seed=0,
                    step0=None, edit=None):
    """Both launches of one case equal the plain version's; returns the
    case's arguments.  ``edit(args, kw)`` changes the inputs first."""
    mod = FAMILIES[fam]
    kernel, plain, args, kw = _family_case(fam, name, n, d, k, rng, device,
                                           tile_n, seed)
    if step0 is not None:
        kw["step0"] = step0
    if edit is not None:
        edit(args, kw)
    before = mod.LAUNCHES
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    assert mod.LAUNCHES == before + 2
    want = plain(*args, **kw)
    _assert_family_equal(name, got, want)
    _assert_family_equal(name, again, want)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(SALP_WOA_STEPS))
@pytest.mark.parametrize("name", PSO_NAMES)
@pytest.mark.parametrize("rng", ["host", "device"])
@pytest.mark.parametrize("d", SALP_WOA_WIDTHS)
def test_salp_woa_redesign_equals_plain_across_widths(cuda, fam, name, rng,
                                                     d):
    # Four tiles of 1,024 lanes (salp: two blocks of 512 a tile; whale: 16
    # blocks of 256); k = 1 with the draws handed in, else the family's
    # main-path steps with device draws, the global step wrapping at 2^32.
    k = 1 if rng == "host" else SALP_WOA_STEPS[fam]
    _salp_woa_equal(fam, name, 4096, d, k, rng, cuda, 1024, seed=d,
                    step0=2**32 - 5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile_n,lanes", [
    (512, 128, 128), (1024, 256, 256), (2048, 512, 512), (4096, 1024, 512),
    (8192, 4096, 512), (384, 384, 128)])
@pytest.mark.parametrize("k,rng", [(1, "host"), (1, "device"),
                                   (16, "device")])
def test_salp_redesign_blocks_and_tiles(cuda, n, tile_n, lanes, k, rng):
    # Several tiles at every block size the main path's tiles give (the
    # first block of each tile holding the link in its halo, the first of
    # the launch the leader), and one tile of three blocks of 128.
    assert port_salp.salp_geometry(30, tile_n).lanes == lanes
    for name in ("rastrigin", "rosenbrock"):
        _salp_woa_equal("salp", name, n, 30, k, rng, cuda, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["step0", "step1", "stepk", "link",
                                  "leader"])
def test_salp_redesign_rebuilds_the_winner_at_its_step(cuda, kind):
    # The winner at a block's first lane (its window in the block before),
    # at a tile's lane 0 (through the link) and at the leader, its best at
    # steps 0, 1, 2 and 16 (tests/test_torch_salp_woa_geometry.py holds
    # where each case puts it): its position rebuilt bit for bit.
    args, kw, _, step = winner_case(kind, cuda)
    before = port_salp.LAUNCHES
    got = port_salp.fused_salp_step_cuda(*args, **kw)
    assert port_salp.LAUNCHES == before + 1
    want = port_salp.fused_salp_step_plain(*args, **kw)
    _assert_family_equal("sphere", got, want)
    if kind != "step0":
        assert float(got[2]) == 0.0
    if kind not in ("step0", "leader"):     # the leader's move is ~1e-27
        assert not bool(got[3].any())


@pytest.mark.cuda
@pytest.mark.parametrize("fam,name,n,d,k,rng,tile_n,want", [
    ("salp", "styblinski_tang", 2048, 452, 16, "device", 512, 64),
    ("salp", "rastrigin", 1024, 200, 16, "device", 256, 256),
    ("salp", "griewank", 1024, 201, 3, "device", 1024, 128),
    ("woa", "rastrigin", 1024, 224, 8, "device", 256, (0, 256)),
    ("woa", "ackley", 1024, 225, 8, "device", 256, (1, 128)),
    ("woa", "zakharov", 256, 1816, 2, "device", 128, (1, 32)),
    ("woa", "levy", 384, 3, 1, "host", 128, (0, 256)),
], ids=lambda v: str(v))
def test_salp_woa_redesign_geometries(cuda, fam, name, n, d, k, rng, tile_n,
                                      want):
    # The envelopes' edges: salp at D = 452 (64 lanes a block) and where
    # 256 lanes still fit; the whale's sorted variant at its last D (224)
    # and the first version past it (128 threads), to D = 1,816 (32); a
    # whale block half empty (384 lanes).
    if fam == "salp":
        assert port_salp.salp_geometry(d, tile_n).lanes == want
    else:
        assert tuple(port_woa.woa_geometry(d)[:2]) == want
    _salp_woa_equal(fam, name, n, d, k, rng, cuda, tile_n)


def _woa_rows(args, u_p, t0):
    """The whale case's host draws with u_p set (a float or a [1, N]
    tensor) and the launch's iteration t0."""
    r_a, r_c, r_p, r_l = args[-4:]
    args[-2] = (torch.full_like(r_p, u_p) if isinstance(u_p, float)
                else u_p.to(r_p.device))
    args[0][2] = t0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["main", "second"])
@pytest.mark.parametrize("klass", ["contract", "spiral", "mixed"])
@pytest.mark.parametrize("t0", [0, 400])
def test_woa_redesign_lane_classes(cuda, monkeypatch, variant, klass, t0):
    # Rows chosen so that every whale contracts, every whale spirals, or
    # the classes alternate in runs of 1 to 40 (every warp at a class
    # boundary); at t0 = 0, a = 2 and |A| >= 1 at about half of the
    # contracting elements, whose peers are read; at 400 none.
    if variant == "second":
        monkeypatch.setattr(port_woa, "woa_geometry", port_woa.lane_geometry)
    n, d = 4096, 30
    g = torch.Generator().manual_seed(t0)
    runs = torch.randint(1, 41, (n,), generator=g).cumsum(0)
    mixed = (torch.searchsorted(runs, torch.arange(n), right=True) % 2
             ).float().reshape(1, n) * 0.5 + 0.25
    u_p = {"contract": 0.25, "spiral": 0.75, "mixed": mixed}[klass]
    args, kw = _salp_woa_equal(
        "woa", "rastrigin", n, d, 1, "host", cuda, 1024,
        edit=lambda a, k: _woa_rows(a, u_p, t0))
    counts = {}
    port_woa.fused_woa_step_plain(*args, **kw, counts=counts)
    contracting = int(counts["contract"][0])
    assert contracting == {"contract": n * d, "spiral": 0}.get(
        klass, int((mixed < 0.5).sum()) * d)
    a = 2.0 * (1.0 - min(t0 / kw["t_max"], 1.0))
    explore = (torch.abs(2 * a * args[-4] - a) >= 1.0) & (args[-2] < 0.5)
    assert bool(explore.any()) == (t0 == 0 and klass != "spiral")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["main", "second"])
@pytest.mark.parametrize("name", ["rastrigin", "ackley", "michalewicz"])
def test_woa_redesign_early_in_the_schedule(cuda, monkeypatch, variant,
                                            name):
    # The first launches of a run (t0 = 0 .. 7): |A| >= 1 at about half the
    # contracting elements, so the peers are read, over 8 steps of device
    # draws with the tile and lane shifts at their edges.
    if variant == "second":
        monkeypatch.setattr(port_woa, "woa_geometry", port_woa.lane_geometry)

    def early(args, kw):
        args[0][1] = 3                    # the last of four tiles
        args[0][2] = 0
        args[0][3] = 1023                 # the lane shift at the tile's end
    _salp_woa_equal("woa", name, 4096, 30, 8, "device", cuda, 1024,
                    edit=early)


@pytest.mark.cuda
@pytest.mark.parametrize("fam,geo", [
    ("salp", (1024, 4 * (30 * 1040 + 2 * 33 * 32 + 96))),   # too many lanes
    ("salp", (96, 4 * (30 * 112 + 2 * 4 * 32 + 96))),      # not a power of 2
    ("salp", (512, 4 * (30 * 528 + 2 * 17 * 30 + 96))),    # bytes
    ("salp", (16, 4 * (30 * 32 + 2 * 1 * 32 + 96))),       # too few lanes
    ("woa", (0, 128, 4 * (30 * 128 + 32 + 256 + 4))),      # not 256
    ("woa", (0, 256, 30720)),                              # bytes
    ("woa", (1, 64, 30 * 64 * 4)),                         # not its block
    ("woa", (2, 256, 0)),                                  # no variant
], ids=lambda v: str(v))
def test_salp_woa_entries_reject_a_geometry_they_cannot_run(cuda,
                                                            monkeypatch,
                                                            fam, geo):
    # The wrapper hands its geometry to the entry, which checks it: one the
    # kernel cannot run launches nothing and counts nothing.
    mod = FAMILIES[fam]
    if fam == "salp":
        monkeypatch.setattr(mod, "salp_geometry",
                            lambda *shape: port_salp.SalpGeometry(*geo))
    else:
        monkeypatch.setattr(mod, "woa_geometry",
                            lambda *shape: port_woa.WoaGeometry(*geo))
    kernel, _, args, kw = _family_case(fam, "sphere", 16384, 30, 2,
                                       "device", cuda, 4096)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*args, **kw)
    assert mod.LAUNCHES == before
    # A tile that the block does not divide.
    if fam == "salp":
        monkeypatch.setattr(mod, "salp_geometry", lambda *shape: (
            port_salp.SalpGeometry(512, port_salp.chain_bytes(30, 512))))
        kernel, _, args, kw = _family_case(fam, "sphere", 1024, 30, 2,
                                           "device", cuda, 256)
        with pytest.raises(RuntimeError, match="launch failed"):
            kernel(*args, **kw)
        assert mod.LAUNCHES == before


@pytest.mark.cuda
def test_salp_woa_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["salp_fused", "woa_fused"])
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws; the
    # whale's beside its second variant.
    for name, kernel, others in (
            ("salp_fused", "salp_chain_kernel", ()),
            ("woa_fused", "woa_sorted_kernel", ("woa_lane_kernel",))):
        log = _build.build_log(name)
        entries = [ln for ln in log.splitlines()
                   if "Compiling entry" in ln and kernel in ln]
        assert len(entries) == 80, (name, len(entries))
        for other in others:
            assert other in log, (name, other)
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert len(spills) >= len(entries), (name, spills)
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), (name, spills)


# --------------------------------------------------------------------------
# Rule 2's redesigns of B14 (csrc/shade_fused.cu, shade_staged_kernel: x and
# the trial kept on chip, a chunk's loads issued together, the Philox stream
# hoisted, a generation counter read from the device) and B4
# (csrc/window_separation.cu, window_staged_kernel: the cut without a square
# root, each warp's near pairs worked off in a queue), and the SHADE run and
# the window rollout replayed from CUDA graphs.  Each kernel equals its plain
# version bit for bit (torch.equal; SHADE's ackley as the family's band);
# each replayed run equals the eager one on every state field.
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.models import (  # noqa: E402
    swarm as port_swarm,
)
from distributed_swarm_algorithm_tpu_torch.state import (  # noqa: E402
    TENSOR_FIELDS,
)

SHADE_REDESIGN_CASES = [
    # objective, n, d, rng, tile_n
    ("rastrigin", 4096, 30, "device", 1024),
    ("rastrigin", 512, 30, "host", 128),
    ("sphere", 640, 1, "device", 128),
    ("griewank", 768, 2, "device", 256),
    ("levy", 512, 3, "host", 128),
    ("schwefel", 1024, 4, "device", 128),
    ("styblinski_tang", 1280, 5, "device", 256),
    ("rosenbrock", 512, 31, "device", 128),
    ("zakharov", 1024, 100, "device", 512),
    ("michalewicz", 512, 10, "device", 128),
    ("ackley", 2048, 30, "device", 512),
    ("rastrigin", 512, 227, "device", 128),
    ("sphere", 384, 363, "device", 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,n,d,rng,tile_n", SHADE_REDESIGN_CASES,
    ids=[f"{c[0]}-{c[1]}x{c[2]}-{c[3]}" for c in SHADE_REDESIGN_CASES])
def test_shade_redesign_equals_plain(cuda, name, n, d, rng, tile_n):
    kernel, plain, args, kw = _rot_case("shade", name, n, d, 1, rng, cuda,
                                        tile_n)
    before = port_shade.LAUNCHES
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    assert port_shade.LAUNCHES == before + 1
    _assert_family_equal(name, got, want)
    # The generation from a counter on the device draws what the int does,
    # and the outputs may be given.
    out = (torch.empty_like(got[0]), torch.empty_like(got[1]))
    step = torch.tensor([kw["step"]], dtype=torch.int32, device=cuda)
    again = kernel(*args, **dict(kw, step=step), out=out)
    assert again[0] is out[0] and again[1] is out[1]
    _assert_family_equal(name, again, want)


@pytest.mark.cuda
def test_shade_redesign_every_lane_accepts_or_rejects(cuda):
    # Fitness -inf: no trial wins, every lane writes its x from the tile; +inf:
    # every trial wins.  CR 0 and 1: no gene crosses, every gene crosses.
    kernel, plain, args, kw = _rot_case("shade", "rastrigin", 2048, 30, 1,
                                        "device", cuda, 512)
    for fit in (float("-inf"), float("inf")):
        for cr in (0.0, 1.0):
            a = list(args)
            a[2] = torch.full_like(args[2], fit)
            a[4] = torch.full_like(args[4], cr)
            got, want = kernel(*a, **kw), plain(*a, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            if fit < 0:
                assert torch.equal(got[0], a[1])


@pytest.mark.cuda
def test_shade_redesign_rejects_bad_operands(cuda):
    kernel, _, args, kw = _rot_case("shade", "sphere", 512, 4, 1, "device",
                                    cuda, 128)
    before = port_shade.LAUNCHES
    for step in (torch.tensor([1], device=cuda),            # int64
                 torch.tensor([1, 2], dtype=torch.int32, device=cuda),
                 torch.tensor([1], dtype=torch.int32)):      # on the CPU
        with pytest.raises(ValueError, match="step"):
            kernel(*args, **dict(kw, step=step))
    with pytest.raises(ValueError, match="pos_out"):
        kernel(*args, **kw, out=(torch.empty((4, 256), device=cuda),
                                 torch.empty((1, 512), device=cuda)))
    assert port_shade.LAUNCHES == before


@pytest.mark.cuda
def test_shade_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["shade_fused"])
    log = _build.build_log("shade_fused")
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws.
    entries = [ln for ln in log.splitlines()
               if "Compiling entry" in ln and "shade_staged_kernel" in ln]
    assert len(entries) == 80, len(entries)
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= len(entries), spills
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


def _window_state(kind, cuda):
    """A Morton-sorted (pos, alive, window) of one kind of state."""
    rng = np.random.default_rng(11)
    n, window, dead = 20000, 16, 0.1
    if kind == "sparse":
        pos = rng.uniform(-90, 90, (n, 2))
    elif kind == "crowded":                 # every shift near
        pos = rng.uniform(-0.4, 0.4, (4096, 2))
        dead = 0.0
    elif kind == "co-located":
        pos = rng.uniform(-30, 30, (3000, 2))
        pos[1:2999:3] = pos[0:2999:3]
        pos[:64] = pos[0]
    elif kind == "dead-heavy":
        pos = rng.uniform(-20, 20, (n, 2))
        dead = 0.9
    elif kind == "all dead":
        pos, dead = rng.uniform(-2, 2, (5000, 2)), 1.1
    elif kind == "W=1":
        pos, window = rng.uniform(-5, 5, (1001, 2)), 1
    elif kind == "W=40":
        pos, window = rng.uniform(-25, 25, (7777, 2)), 40
    elif kind == "W=1500":                  # the widest staged halo
        pos, window = rng.uniform(-60, 60, (6000, 2)), 1500
    else:                                   # "n=37": a partial warp
        pos = rng.uniform(-1, 1, (37, 2))
    pos = torch.from_numpy(pos.astype(np.float32))
    alive = torch.from_numpy(rng.random(pos.shape[0]) >= dead)
    order = torch.sort(port_nb.morton_keys(pos, 2.0), stable=True).indices
    return (pos[order].contiguous().to(cuda),
            alive[order].contiguous().to(cuda), window)


WINDOW_KINDS = ["sparse", "crowded", "co-located", "dead-heavy", "all dead",
                "W=1", "W=40", "W=1500", "n=37"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_window_redesign_equals_plain(cuda, kind):
    pos, alive, window = _window_state(kind, cuda)
    before = port_win.LAUNCHES
    got = port_win.separation_window_cuda(pos, alive, K_SEP, R, EPS, window)
    want = port_nb.separation_window(pos, alive, K_SEP, R, EPS, 2.0, window,
                                     presorted=True)
    torch.cuda.synchronize()
    assert port_win.LAUNCHES == before + 1
    assert torch.equal(got, want)
    # The kernel is the numpy model of its queue, with IEEE square roots.
    model, counts = port_win.near_pair_queue(
        pos.cpu().numpy(), alive.cpu().numpy(), K_SEP, R, EPS, window)
    assert np.array_equal(got.cpu().numpy(), model)
    if kind == "crowded":
        assert counts.crowded.any()
    if kind == "all dead":
        assert not bool(got.any())


@pytest.mark.cuda
def test_window_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["window_separation"])
    log = _build.build_log("window_separation")
    assert "window_staged_kernel" in log and "window_global_kernel" in log
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= 2, spills
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


@pytest.mark.cuda
def test_graph_replayed_shade_run_equals_the_eager_loop(cuda, monkeypatch):
    from distributed_swarm_algorithm_tpu_torch.ops import shade
    fn, hw = port_obj.get_objective("rastrigin")
    runs = {}
    replays = port_shade.replays_graphs
    for replayed in (False, True):
        # The eager loop on the card: the run's graph seam refusing.
        monkeypatch.setattr(port_shade, "replays_graphs",
                            replays if replayed else lambda dev: False)
        st = shade.shade_init(fn, 5000, 30, hw, seed=2, device=cuda)
        before = port_shade.LAUNCHES
        st = port_shade.fused_shade_run(st, "rastrigin", 9, half_width=hw)
        captured = port_shade._replay
        st = port_shade.fused_shade_run(st, "rastrigin", 4, half_width=hw)
        torch.cuda.synchronize()
        assert port_shade.LAUNCHES == before + 13
        if replayed:
            assert captured is not None and port_shade._replay is captured
        runs[replayed] = st
    eager, graph = runs[False], runs[True]
    for f in shade.SHADE_TENSOR_FIELDS:
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    assert torch.equal(graph.gen.get_state(), eager.gen.get_state())


@pytest.mark.cuda
def test_graph_replayed_shade_run_counts_and_raises(cuda, monkeypatch):
    from distributed_swarm_algorithm_tpu_torch.ops import shade
    fn, hw = port_obj.get_objective("sphere")
    st = shade.shade_init(fn, 2048, 8, hw, seed=5, device=cuda)
    monkeypatch.setattr(port_shade, "_replay", None)
    before = port_shade.LAUNCHES
    port_shade.fused_shade_run(st, "sphere", 1, half_width=hw)
    assert port_shade._replay is None             # one generation: eager
    # A generation that waits for the host cannot be captured: the run
    # raises, and nothing runs eagerly in its place.
    elite = port_shade.tile_champion_elite

    def waits(pos_t, fit_row, n_tiles, tile_n):
        float(fit_row.min())
        return elite(pos_t, fit_row, n_tiles, tile_n)

    monkeypatch.setattr(port_shade, "tile_champion_elite", waits)
    with pytest.raises(RuntimeError):
        port_shade.fused_shade_run(st, "sphere", 6, half_width=hw)
    assert port_shade._replay is None
    assert port_shade.LAUNCHES == before + 1
    monkeypatch.setattr(port_shade, "tile_champion_elite", elite)
    out = port_shade.fused_shade_run(st, "sphere", 6, half_width=hw)
    assert port_shade.LAUNCHES == before + 7
    assert bool(torch.isfinite(out.best_fit))


def _window_scenario(n, cuda, seed=3):
    st = tdsa.make_swarm(n, spread=40.0, seed=seed, device=cuda)
    st = tdsa.with_tasks(st, [[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0]])
    return st.replace(target=torch.full_like(st.pos, 30.0),
                      has_target=torch.ones_like(st.has_target))


@pytest.mark.cuda
@pytest.mark.parametrize("spans,with_jitter", [((400, 400), False),
                                               ((59, 41), True),
                                               ((8, 13), False)])
def test_graph_replayed_window_rollout_equals_the_eager_one(
        cuda, monkeypatch, spans, with_jitter):
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="window", sort_every=8)
    n = 4096
    jitter = None
    if with_jitter:
        jitter = torch.from_numpy(np.random.default_rng(1).integers(
            0, 3, (sum(spans), n)).astype(np.int32)).to(cuda)
    runs = {}
    replays = port_swarm.replays_graphs
    for replay in (False, True):
        monkeypatch.setattr(port_swarm, "replays_graphs",
                            replays if replay else lambda dev: False)
        st, at, before = _window_scenario(n, cuda), 0, port_win.LAUNCHES
        leaders = []
        for k, ticks in enumerate(spans):
            if k:
                st = tdsa.kill(st, [n - 1])
            st = port_swarm.swarm_rollout(
                st, None, cfg, ticks,
                jitter=None if jitter is None else jitter[at:at + ticks])
            at += ticks
            leaders.append([int(v) for v in tdsa.current_leader(st)])
        torch.cuda.synchronize()
        assert port_win.LAUNCHES == before + sum(spans)
        runs[replay] = (st, leaders)
    (eager, le), (graph, lg) = runs[False], runs[True]
    assert lg == le
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    assert torch.equal(graph.gen.get_state(), eager.gen.get_state())
    if spans == (400, 400):
        assert le == [[n - 1, 1], [n - 2, 1]]


@pytest.mark.cuda
def test_graph_replayed_window_rollout_through_the_handle(cuda, monkeypatch):
    # VectorSwarm.step(n > 1) replays; step(1) and record stay eager; a
    # chunk that waits for the host raises and runs nothing eagerly.
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="window", sort_every=8)
    monkeypatch.setattr(port_swarm, "_chunk", None)
    sw = tdsa.VectorSwarm(2048, spread=40.0, config=cfg, seed=1,
                          device=cuda)
    sw.set_target([30.0, 0.0])
    sw.step(1)
    assert port_swarm._chunk is None
    before = port_win.LAUNCHES
    sw.step(16)
    chunk = port_swarm._chunk
    assert chunk is not None and port_win.LAUNCHES == before + 16
    sw.step(24)
    assert port_swarm._chunk is chunk and port_win.LAUNCHES == before + 40
    sw.step(8, record=True)
    assert port_win.LAUNCHES == before + 48
    sorted_ = port_swarm._morton_sorted

    def waits(state, cfg):
        int(state.tick)
        return sorted_(state, cfg)

    monkeypatch.setattr(port_swarm, "_chunk", None)
    monkeypatch.setattr(port_swarm, "_morton_sorted", waits)
    with pytest.raises(RuntimeError):
        sw.step(16)
    assert port_swarm._chunk is None and port_win.LAUNCHES == before + 48
    # The generator draws again after the failed capture.
    monkeypatch.setattr(port_swarm, "_morton_sorted", sorted_)
    sw.step(16)
    assert port_win.LAUNCHES == before + 64


# --------------------------------------------------------------------------
# The redesigned hashgrid kernels (B2 with its rescue, B3) and the hashgrid
# rollouts replayed from CUDA graphs.

@pytest.mark.cuda
@pytest.mark.parametrize("crowd,budget", [(0, 64), (150, 32)],
                         ids=["seam", "seam-past-budget"])
def test_grid_redesign_on_the_seam(cuda, crowd, budget):
    # Agents exactly on the seam (-hw and +hw) with partners across it,
    # and a crowd around the corner (-hw, -hw) past the cap and the budget.
    rng = np.random.default_rng(8)
    pos = rng.uniform(-HW, HW, (700, 2)).astype(np.float32)
    pos[:8] = [[-HW, 3.0], [HW - 0.5, 3.0], [HW, -5.0], [-HW + 0.7, -5.2],
               [2.0, -HW], [2.3, HW - 0.4], [-HW, -HW], [HW - 0.3, HW - 0.6]]
    if crowd:
        c = -HW + 0.6 * rng.normal(size=(crowd, 2))
        pos[8:8 + crowd] = np.mod(c + HW, 2 * HW) - HW
    alive = np.ones(700, dtype=bool)
    pos = torch.from_numpy(pos.astype(np.float32)).to(cuda)
    alive = torch.from_numpy(alive).to(cuda)
    _, plan, ops, g, r = _grid_operands(pos, alive, 2.0, 8, 0.0, cuda)
    got, _ = _check_grid_sweep(ops, g, 8, r, budget)
    assert (got[:8] != 0).any(1).all()
    assert (int(plan.cap_overflow) > budget) == bool(crowd)


@pytest.mark.cuda
def test_hashgrid_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["grid_separation", "candidate_sweep"])
    for name, kernels in (("grid_separation", 2), ("candidate_sweep", 1)):
        log = _build.build_log(name)
        entries = [ln for ln in log.splitlines() if "Compiling entry" in ln]
        assert len(entries) == kernels, entries
        spills = [ln for ln in log.splitlines() if "spill" in ln]
        assert len(spills) >= kernels, spills
        assert all("0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in spills), spills


HG_SCENARIOS = {
    # bench_swarm_tpu.py:49 and :43 (cap 16, rescue budget 1,024), and the
    # fast movers of decompose_rebuild.py:222-233, as chip_smoke.py runs
    # them, cut to short spans.
    "station": dict(grid_max_per_cell=16, hashgrid_overflow_budget=1024),
    "converge": dict(grid_max_per_cell=16, hashgrid_overflow_budget=1024),
    "fast movers": dict(grid_max_per_cell=24, hashgrid_overflow_budget=1024,
                        max_speed=5.0, hashgrid_kernel="candidates",
                        hashgrid_skin=1.5, hashgrid_neighbor_cap=48,
                        hashgrid_partial_refresh=True),
}


def _hashgrid_scenario(name, cuda, n=65536):
    cfg = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", formation_shape="none", world_hw=256.0,
        **HG_SCENARIOS[name])
    # The converging swarm starts crowded (about 10 agents a square
    # metre), so its rescue runs from the first tick.
    st = tdsa.make_swarm(n, spread=40.0 if name == "converge" else 250.0,
                         seed=0, device=cuda)
    st = tdsa.with_tasks(st, [[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0],
                              [0.0, 9.0]])
    target = (st.pos.clone() if name != "converge"
              else torch.tensor([50.0, 0.0], device=cuda).expand_as(st.pos)
              .clone())
    return cfg, st.replace(target=target,
                           has_target=torch.ones_like(st.has_target))


@pytest.mark.cuda
@pytest.mark.parametrize("name,spans,with_jitter", [
    ("station", (30, 23), False), ("converge", (40, 20), True),
    ("fast movers", (30, 20), True)])
def test_graph_replayed_hashgrid_rollout_equals_the_eager_one(
        cuda, monkeypatch, name, spans, with_jitter):
    # Full width (65,536 agents), a short rollout, the leader killed, more
    # ticks: the replayed rollout equals the eager one on every field of
    # the state and of the carried plan, and launches its kernel once a
    # tick and no other of the port's kernels.
    mod = port_cand if name == "fast movers" else port_grid
    other = port_grid if mod is port_cand else port_cand
    n = 65536
    jitter = None
    if with_jitter:
        jitter = torch.from_numpy(np.random.default_rng(1).integers(
            0, 3, (sum(spans), n)).astype(np.int32)).to(cuda)
    runs = {}
    replays = port_swarm.replays_graphs
    for replay in (False, True):
        monkeypatch.setattr(port_swarm, "replays_graphs",
                            replays if replay else lambda dev: False)
        cfg, st = _hashgrid_scenario(name, cuda)
        at, leaders, plans = 0, [], []
        before = (mod.LAUNCHES, other.LAUNCHES, port_win.LAUNCHES)
        for k, ticks in enumerate(spans):
            if k:
                st = tdsa.kill(st, [n - 1])
            st, plan = port_swarm.swarm_rollout(
                st, None, cfg, ticks, return_plan=True,
                jitter=None if jitter is None else jitter[at:at + ticks])
            at += ticks
            leaders.append([int(v) for v in tdsa.current_leader(st)])
            plans.append(plan)
        torch.cuda.synchronize()
        assert (mod.LAUNCHES, other.LAUNCHES, port_win.LAUNCHES) == (
            before[0] + sum(spans), before[1], before[2])
        runs[replay] = (st, leaders, plans)
    (eager, le, pe), (graph, lg, pg) = runs[False], runs[True]
    assert lg == le and le[-1][0] in (-1, n - 2)
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    assert torch.equal(graph.gen.get_state(), eager.gen.get_state())
    if name == "fast movers":
        for a, b in zip(pe, pg):
            for f in port_hp.HashgridPlan.ARRAY_FIELDS:
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                assert x is None or torch.equal(x, y), f
        assert int(pg[0].cells_rebuilt) > 0
    else:
        assert pe == pg == [None, None]
    if name == "converge":
        plan = tdsa.build_tick_plan(graph, cfg)
        assert int(plan.cap_overflow) > cfg.hashgrid_overflow_budget


@pytest.mark.cuda
def test_graph_replayed_hashgrid_rollout_through_the_handle(cuda,
                                                            monkeypatch):
    # VectorSwarm.step(n >= a chunk) replays, step(1), record and a shorter
    # last chunk run eagerly; a carried plan's chunk that needed a full
    # rebuild is discarded and runs again eagerly (its launches counted
    # once, CHUNKS_RERUN counting the chunk) and ends equal to the eager
    # rollout.
    from distributed_swarm_algorithm_tpu_torch.models.swarm import (
        HASHGRID_CHUNK,
    )
    monkeypatch.setattr(port_swarm, "_chunk", None)
    cfg = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", formation_shape="none", world_hw=96.0,
        **HG_SCENARIOS["station"])
    sw = tdsa.VectorSwarm(8192, config=cfg, spread=90.0, seed=1,
                          device=cuda)
    sw.set_target([5.0, 0.0])
    sw.step(1)
    assert port_swarm._chunk is None
    before = port_grid.LAUNCHES
    sw.step(2 * HASHGRID_CHUNK + 3)
    chunk = port_swarm._chunk
    assert chunk is not None and chunk.kernel is port_grid
    assert port_grid.LAUNCHES == before + 2 * HASHGRID_CHUNK + 3
    sw.step(HASHGRID_CHUNK, record=True)
    assert port_swarm._chunk is chunk
    assert port_grid.LAUNCHES == before + 3 * HASHGRID_CHUNK + 3
    # Full rebuilds inside replayed chunks (a crosser cap of 2).
    fast = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", formation_shape="none", world_hw=96.0,
        **dict(HG_SCENARIOS["fast movers"], hashgrid_partial_crosser_cap=2))
    runs = {}
    replays = port_swarm.replays_graphs
    monkeypatch.setattr(port_swarm, "CHUNKS_RERUN", 0)
    for replay in (False, True):
        monkeypatch.setattr(port_swarm, "replays_graphs",
                            replays if replay else lambda dev: False)
        s = tdsa.make_swarm(8192, spread=90.0, seed=2, device=cuda)
        s = s.replace(target=torch.zeros_like(s.pos),
                      has_target=torch.ones_like(s.has_target))
        start = port_cand.LAUNCHES
        out, plan = port_swarm.swarm_rollout(s, None, fast,
                                             2 * HASHGRID_CHUNK,
                                             return_plan=True)
        runs[replay] = (out, plan, port_cand.LAUNCHES - start)
    (eager, pe, le), (graph, pg, lg) = runs[False], runs[True]
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    assert int(pe.rebuilds) > 0 and int(pg.rebuilds) == int(pe.rebuilds)
    assert le == lg == 2 * HASHGRID_CHUNK and port_swarm.CHUNKS_RERUN > 0


# --------------------------------------------------------------------------
# Rule 2's redesign of B16 (csrc/mfo_fused.cu, mfo_sorted_kernel): moths at
# their flame's fixed point stopped, the moving ones regrouped.  Each case
# equals the plain version under torch.equal, moths stopped at the start,
# moths stopped mid-launch and moths past n_flames included.
# --------------------------------------------------------------------------


def _mfo_settings(setting):
    """The wrapper's geometry function for a setting of B16: the main
    variant at any D it holds, or the first version."""
    return {"main": lambda d: port_mfo.MfoGeometry(
                0, 128, port_mfo.sorted_bytes(d)),
            "first version": port_mfo.lane_geometry}[setting]


def _mfo_launch_equal(args, kw, monkeypatch, setting):
    """One launch of B16 in ``setting`` against the plain version; returns
    the plain version's outputs and tallies."""
    monkeypatch.setattr(port_mfo, "mfo_geometry", _mfo_settings(setting))
    before = port_mfo.LAUNCHES
    got = port_mfo.fused_mfo_step_cuda(*args, **kw)
    assert port_mfo.LAUNCHES == before + 1
    counts = {}
    want = port_mfo.fused_mfo_step_plain(*args, **kw, counts=counts)
    _assert_family_equal(kw["objective_name"], got, want)
    return want, counts


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["main", "first version"])
def test_mfo_redesign_mid_window_and_after_a_resort(cuda, monkeypatch,
                                                    setting):
    # Launches chained as the run chains them between its re-sorts, from a
    # fresh state (the flames sorted): after the first, most moths start at
    # the fixed point; then the flames re-sorted, which hands most moths
    # another flame.  4,096 x 30 rastrigin in 4 tiles, n_flames < N.
    from distributed_swarm_algorithm_tpu_torch.ops import mfo
    from distributed_swarm_algorithm_tpu_torch.ops.mfo import schedule
    fn, hw = port_obj.get_objective("rastrigin")
    st = mfo.mfo_init(fn, 4096, 30, hw, seed=0, device=cuda)
    pos, flames = st.pos.T.contiguous(), st.flame_pos.T.contiguous()
    ffit = st.flame_fit[None, :].contiguous()
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    stopped = []
    for i in range(4):
        if i == 3:
            flames, row = port_mfo.resort_flames(flames, ffit[0])
            ffit = row[None, :].contiguous()
        frac, n_flames = schedule(torch.tensor(100 + 8 * i, device=cuda),
                                  4096, 1000, torch.float32)
        r_lo = torch.round((-1.0 - frac) * 65536.0).to(torch.int32)
        last = flames.index_select(1, (n_flames - 1).long().reshape(1))
        args = [torch.cat([seed, n_flames.reshape(1), r_lo.reshape(1)]),
                last, pos, flames, ffit]
        kw = dict(objective_name="rastrigin", half_width=hw, tile_n=1024,
                  k_steps=8, step0=8 * i)
        (pos, _, flames, ffit), counts = _mfo_launch_equal(
            args, kw, monkeypatch, setting)
        assert int(n_flames) < 4096
        stopped.append(int(counts["stopped_at_start"][0]))
        assert int(counts["moving"][-1]) < int(counts["moving"][0])
    assert stopped[0] == 0 and stopped[1] > 2048 and stopped[2] > 2048
    assert stopped[3] < stopped[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name,d", [
    ("sphere", 28), ("rastrigin", 29), ("schwefel", 30),
    ("styblinski_tang", 31), ("ackley", 30), ("rosenbrock", 5),
    ("griewank", 9), ("levy", 7), ("zakharov", 3), ("michalewicz", 10)])
def test_mfo_redesign_objectives_and_widths(cuda, monkeypatch, name, d):
    # Every objective, D mod 4 of 0 to 3, device draws over 8 steps and
    # handed draws over one; a flame outside the domain with the moth on
    # it moves (the case's inputs).
    for rng, k in (("device", 8), ("host", 1)):
        _, _, args, kw = _rot_case("mfo", name, 1024, d, k, rng, cuda, 256)
        want, counts = _mfo_launch_equal(args, kw, monkeypatch, "main")
        if rng == "device":
            assert int(counts["stopped_at_start"][0]) > 0
        assert float(want[0].abs().max()) <= np.float32(kw["half_width"])


@pytest.mark.cuda
def test_mfo_redesign_takes_every_step_where_the_fixed_point_may_fail(
        cuda, monkeypatch):
    # An infinite domain, a huge spiral exponent: no moth stops, and the
    # kernel still equals the plain version.  The widest D of the main
    # variant (225) and the first version past it (226).
    _, _, args, kw = _rot_case("mfo", "sphere", 512, 12, 4, "device", cuda,
                               128)
    for extra in (dict(half_width=float("inf")), dict(b=1e31)):
        _, counts = _mfo_launch_equal(args, dict(kw, **extra), monkeypatch,
                                      "main")
        assert int(counts["stopped_at_start"][0]) == 0
    monkeypatch.undo()
    for d, variant in ((225, 0), (226, 1)):
        assert port_mfo.mfo_geometry(d).variant == variant
        _, _, args, kw = _rot_case("mfo", "rastrigin", 256, d, 2, "device",
                                   cuda, 128)
        got = port_mfo.fused_mfo_step_cuda(*args, **kw)
        _assert_family_equal("rastrigin", got,
                             port_mfo.fused_mfo_step_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [
    (0, 64, 4 * (2 * 30 * 64 + 32 + 64 + 2)),          # not 128 moths
    (0, 128, 30720),                                    # bytes
    (0, 128, 4 * (2 * 30 * 128 + 32 + 128 + 4)),        # a row too few
    (1, 64, 2 * 30 * 64 * 4),                           # not its block
    (2, 128, 30720),                                    # no variant
], ids=lambda v: str(v))
def test_mfo_entry_rejects_a_geometry_it_cannot_run(cuda, monkeypatch, geo):
    monkeypatch.setattr(port_mfo, "mfo_geometry",
                        lambda d: port_mfo.MfoGeometry(*geo))
    kernel, _, args, kw = _rot_case("mfo", "sphere", 1024, 30, 2, "device",
                                    cuda, 256)
    before = port_mfo.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*args, **kw)
    assert port_mfo.LAUNCHES == before


@pytest.mark.cuda
def test_mfo_hoisted_philox_equals_philox4x32_10(cuda):
    # Stream 0's group from philox_one.cuh on the lane's and the step's
    # products, beside philox4x32_10's words on the card and the plain
    # version's (ops/cuda/pso_fused.py).
    words, (lane, grp, ctr, seed) = _philox_check_words(
        cuda, "mfo_fused", "dsa_mfo_philox_check", 8)
    assert np.array_equal(words[:, :4], words[:, 4:])
    want = torch.stack(port_pf.philox4x32_10(lane, grp, ctr, 0, seed, 0), 1)
    assert np.array_equal(words[:, :4], want.numpy())


@pytest.mark.cuda
def test_mfo_redesign_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["mfo_fused"])
    # 4 classes of D mod 4 x 10 objectives x 2 sources of the draws, beside
    # the first version and the Philox check.
    log = _build.build_log("mfo_fused")
    entries = [ln for ln in log.splitlines()
               if "Compiling entry" in ln and "mfo_sorted_kernel" in ln]
    assert len(entries) == 80, len(entries)
    for other in ("mfo_lane_kernel", "philox_check_kernel"):
        assert other in log, other
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= len(entries) + 2, spills
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


# --------------------------------------------------------------------------
# NSGA-II's ranks, kernel N1 (csrc/nsga2_ranks.cu), against its plain
# version under torch.equal (comparisons only), and the four families
# without a TPU kernel (NSGA-II, ES, MAP-Elites, CMA-ES) on the card.
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (  # noqa: E402
    nsga2_ranks as port_n1,
)

# Device waits of one CMA-ES generation on the card: torch.linalg.eigh
# reads cuSOLVER's error code back on the host.
CMAES_EIGH_SYNCS = 1


def rank_case(kind, p, m, seed):
    """(objs [p, m] f32, viol [p] f32 or None): the cases N1 is held to
    (random points, a single chain of P fronts, all equal, duplicates, +-0
    and +-inf, feasible, infeasible and tied violations)."""
    rng = np.random.default_rng(seed)
    objs = rng.uniform(0.0, 1.0, (p, m)).astype(np.float32)
    viol = None
    if kind == "chain":        # P fronts: point k dominates k + 1
        objs = np.repeat(np.arange(p, dtype=np.float32)[:, None], m, 1)
        objs = objs[rng.permutation(p)]
    elif kind == "equal":      # one front
        objs[:] = 0.25
    elif kind == "duplicates":
        objs = objs[rng.integers(0, max(1, p // 4), p)]
    elif kind == "signed":     # -0 equals +0; +-inf compare as numbers
        vals = np.float32([-0.0, 0.0, np.inf, -np.inf, 1.0, -1.0])
        objs = vals[rng.integers(0, len(vals), (p, m))]
    elif kind == "viol":       # feasible, infeasible, tied violations
        viol = rng.choice(np.float32([0.0, 1e-4, 2e-4, 0.5, 0.5, 3.0]),
                          p).astype(np.float32)
    elif kind == "viol_zero":  # the generation's unconstrained form
        viol = np.zeros(p, np.float32)
    return objs, viol


N1_CASES = (
    [("random", p, m) for p in (1, 31, 1024, 1025, 2049, 4096)
     for m in (1, 2, 3)]
    + [("chain", p, m) for p in (33, 1024, 1300, 4096) for m in (1, 2)]
    + [(kind, p, m) for kind in ("equal", "duplicates", "signed", "viol",
                                 "viol_zero")
       for p in (31, 1024, 2049) for m in (1, 2, 3)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,p,m", N1_CASES)
def test_nsga2_ranks_kernel_equals_its_plain_version(cuda, kind, p, m):
    objs, viol = rank_case(kind, p, m, seed=p + m)
    o = torch.from_numpy(objs).to(cuda)
    v = None if viol is None else torch.from_numpy(viol).to(cuda)
    want = port_n1.nsga2_ranks_plain(o, v, 1e-4)   # its loop on the card
    fronts = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = port_n1.LAUNCHES
    got = port_n1.nsga2_ranks_cuda(o, v, 1e-4, fronts)
    torch.cuda.synchronize()
    assert port_n1.LAUNCHES == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, want), (kind, p, m)
    assert int(fronts) == int(want.max()) + 1
    if kind == "chain":
        assert int(fronts) == p


@pytest.mark.cuda
def test_nsga2_ranks_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["nsga2_ranks"])
    log = _build.build_log("nsga2_ranks")
    entries = [ln for ln in log.splitlines() if "Compiling entry" in ln]
    assert len(entries) == 3, entries      # pack, peel on chip, peel global
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= 3 and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills)


@pytest.mark.cuda
def test_nsga2_ranks_cuda_rejects_what_it_cannot_take(cuda):
    objs = torch.rand(64, 2, device=cuda)
    with pytest.raises(ValueError):
        port_n1.nsga2_ranks_cuda(objs.cpu(), None, 1e-4)
    with pytest.raises(ValueError):
        port_n1.nsga2_ranks_cuda(objs.double(), None, 1e-4)
    with pytest.raises(ValueError):
        port_n1.nsga2_ranks_cuda(objs, torch.zeros(63, device=cuda), 1e-4)
    with pytest.raises(TypeError):
        port_n1.nsga2_ranks_cuda(objs, torch.zeros(64, dtype=torch.float64,
                                                   device=cuda), 1e-4)


def _sync_waits(run):
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message)[:120] for w in seen
                 if "synchroniz" in str(w.message)]


@pytest.mark.cuda
def test_moo_qd_es_generations_never_wait_for_the_device(cuda):
    opts = {"nsga2": tdsa.NSGA2("zdt1", n=512, dim=30, seed=0),
            "es": tdsa.ES("rastrigin", n=256, dim=30, seed=0),
            "mapelites": tdsa.MAPElites("rastrigin", dim=6, bins=24,
                                        batch=512, seed=0)}
    for name, opt in opts.items():
        opt.run(2)                                   # warm up
        before = port_n1.LAUNCHES
        _, waits = _sync_waits(lambda: opt.run(3))
        assert not waits, (name, waits)
        assert port_n1.LAUNCHES == before + (3 if name == "nsga2" else 0)


@pytest.mark.cuda
def test_cmaes_generation_waits_only_for_eigh(cuda):
    opt = tdsa.CMAES("rosenbrock", dim=30, n=64, seed=0)
    opt.run(2)
    _, waits = _sync_waits(lambda: opt.run(3))
    assert len(waits) == 3 * CMAES_EIGH_SYNCS, waits
    eig = torch.linalg.eigh(opt.state.cov)
    _, waits = _sync_waits(lambda: opt.step(eig=eig))
    assert not waits, waits


@pytest.mark.cuda
def test_nsga2_generation_on_the_card_selects_as_the_cpu_does(cuda):
    # The same state and draws on both devices: the children within the
    # band of pow, and the selection from the card's own parents and
    # children (ranks by N1) equal to the CPU's (the plain loop).
    from distributed_swarm_algorithm_tpu_torch.ops import nsga2 as tn
    st = tn.nsga2_init(tn.zdt1, 256, 30, seed=1, device="cpu")
    st = tn.nsga2_run(st, tn.zdt1, 5)
    gen = torch.Generator().manual_seed(3)
    draws = tn.variation_draws(st.pos, gen)
    on = lambda x: x.to(cuda)  # noqa: E731
    st_c = st.replace(**{f: on(getattr(st, f))
                         for f in tn.NSGA2_TENSOR_FIELDS})
    draws_c = (on(draws[0]), on(draws[1]), tuple(map(on, draws[2])),
               tuple(map(on, draws[3])))
    kids_c = tn.nsga2_offspring(st_c, draws=draws_c)
    kids = tn.nsga2_offspring(st, draws=draws)
    assert torch.allclose(kids_c.cpu(), kids, rtol=1e-6, atol=1e-6)
    objs_c = torch.cat([st_c.objs, tn.zdt1(kids_c)])
    viol_c = torch.zeros(512, device=cuda)
    got = tn.nsga2_select(objs_c, viol_c, 256)
    want = tn.nsga2_select(objs_c.cpu(), viol_c.cpu(), 256)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    out = tn.nsga2_step(st_c, tn.zdt1, draws=draws_c)
    assert bool((out.pos >= 0).all() and (out.pos <= 1).all())


# --------------------------------------------------------------------------
# Queue A items 9 and 10: N2 (the auction's bidding loop), the auction tick
# and the moments field on the card.
# --------------------------------------------------------------------------

from distributed_swarm_algorithm_tpu_torch.ops import (  # noqa: E402
    auction as port_auction,
)
from distributed_swarm_algorithm_tpu_torch.ops import (  # noqa: E402
    grid_moments as port_gm,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (  # noqa: E402
    auction as port_n2,
)


def n2_values(kind, s, seed):
    """[S, S] float32 square values: uniform in [1, 100), all ties, an
    infeasible agent and task (a zero row and column), a price war (eight
    hot tasks near 100, the rest below 1), or a rectangular [S, 2S/3]
    problem with a third of its pairs infeasible, squared."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(1.0, 100.0, (s, s)).astype(np.float32)
    if kind == "ties":
        v[:] = 10.0
    elif kind == "infeasible":
        v[s // 3] = 0.0
        v[:, s // 2] = 0.0
    elif kind == "price-war":
        v = rng.uniform(0.5, 1.0, (s, s)).astype(np.float32)
        v[:, :8] = 100.0 + rng.uniform(0.0, 0.01, (s, 8)).astype(np.float32)
    elif kind == "rect":
        util = torch.from_numpy(v[:, :2 * s // 3].copy())
        feas = torch.from_numpy(rng.random(tuple(util.shape)) < 0.67)
        return port_auction._square_values(util, feas)
    return torch.from_numpy(v)


N2_CASES = ([("uniform", s) for s in (1, 2, 3, 5, 31, 33, 100, 1023, 1025)]
            + [("ties", 40), ("ties", 97), ("infeasible", 50),
               ("infeasible", 257), ("price-war", 256), ("rect", 90),
               ("rect", 600)])


def _n2_both(cuda, values, prices=None, cap=100_000, run=True):
    s = values.shape[0]
    v = values.to(cuda)
    p = torch.zeros(s, device=cuda) if prices is None else prices.to(cuda)
    eps = torch.full((), 0.25, device=cuda)
    flag = torch.full((), run, dtype=torch.bool, device=cuda)
    before = port_n2.LAUNCHES
    got = port_n2.auction_square_cuda(v, p, eps, cap, flag)
    torch.cuda.synchronize()
    assert port_n2.LAUNCHES == before + 1
    want = port_n2.auction_square_plain(v, p, eps, cap, flag)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind,s", N2_CASES)
def test_auction_kernel_equals_its_plain_version(cuda, kind, s):
    got, want = _n2_both(cuda, n2_values(kind, s, seed=s + 1))
    assert [t.dtype for t in got] == [torch.int32, torch.int32,
                                      torch.float32, torch.int32]
    for name, a, b in zip(("agent_task", "task_agent", "prices", "rounds"),
                          got, want):
        assert torch.equal(a, b), (kind, s, name)
    assert bool((got[0] >= 0).all())            # every agent seated


@pytest.mark.cuda
def test_auction_kernel_cap_warm_prices_run_flag_and_global_state(cuda):
    v = n2_values("uniform", 256, seed=3)
    warm = torch.rand(256, generator=torch.Generator().manual_seed(2)) * 5.0
    for kw in (dict(cap=7), dict(prices=warm), dict(run=False)):
        got, want = _n2_both(cuda, v, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw
    off, _ = _n2_both(cuda, v, run=False)
    assert int(off[3]) == 0 and bool((off[0] == -1).all())
    # Past ~9,680 tasks the state leaves shared memory for the scratch.
    got, want = _n2_both(cuda, n2_values("uniform", 9_800, seed=4))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_auction_assign_on_the_card_equals_the_cpu(cuda):
    # Rectangular and scaled: the whole entry (padding, N2 a phase,
    # unpadding) on the card against the same on the CPU.
    rng = np.random.default_rng(5)
    util = torch.from_numpy(rng.uniform(0.0, 100.0, (300, 170))
                            .astype(np.float32))
    feas = torch.from_numpy(rng.random((300, 170)) < 0.8)
    for fn in (port_auction.auction_assign,
               port_auction.auction_assign_scaled):
        before = port_n2.LAUNCHES
        got = fn(util.to(cuda), feas.to(cuda))
        want = fn(util, feas)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        assert port_n2.LAUNCHES == before + (
            1 if fn is port_auction.auction_assign else 4)


@pytest.mark.cuda
def test_auction_builds_spill_no_registers(cuda):
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    _build.build(["auction"])
    log = _build.build_log("auction")
    entries = [ln for ln in log.splitlines() if "Compiling entry" in ln]
    assert len(entries) == 4, entries   # shared or global state, float4 or not
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= 4 and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills)


@pytest.mark.cuda
def test_auction_cuda_rejects_what_it_cannot_take(cuda):
    v = torch.rand(8, 8, device=cuda)
    p = torch.zeros(8, device=cuda)
    eps = torch.full((), 0.25, device=cuda)
    run = torch.ones((), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        port_n2.auction_square_cuda(v.cpu(), p.cpu(), eps.cpu(), 10,
                                    run.cpu())
    with pytest.raises(ValueError):
        port_n2.auction_square_cuda(v[:, :7].contiguous(), p, eps, 10, run)
    with pytest.raises(TypeError):
        port_n2.auction_square_cuda(v.double(), p, eps, 10, run)
    with pytest.raises(ValueError):
        port_n2.auction_square_cuda(v, p[:7], eps, 10, run)
    with pytest.raises(ValueError):
        port_n2.auction_square_cuda(v, p, eps, 10, run.int())


def _auction_cfg(**kw):
    return tdsa.DEFAULT_CONFIG.replace(
        allocation_mode="auction", auction_every=2, utility_threshold=5.0,
        separation_mode="pallas", **kw)


def _field_cfg(**kw):
    return tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", formation_shape="none", world_hw=64.0,
        grid_max_per_cell=16, k_align=0.3, k_coh=0.1, **kw)


def _led_swarm(cuda, n, tasks, spread, seed=0):
    """A swarm whose top agent already leads (so every tick may solve)."""
    from distributed_swarm_algorithm_tpu_torch.state import LEADER
    st = tdsa.make_swarm(n, spread=spread, seed=seed, device=cuda)
    rng = np.random.default_rng(seed)
    st = tdsa.with_tasks(st, torch.from_numpy(rng.uniform(
        -spread, spread, (tasks, 2)).astype(np.float32)).to(cuda))
    fsm = st.fsm.clone()
    fsm[-1] = LEADER
    return st.replace(fsm=fsm)


@pytest.mark.cuda
def test_auction_and_field_ticks_never_wait_for_the_device(cuda):
    st = _led_swarm(cuda, 512, 64, 20.0)
    cfg = _auction_cfg()
    st = tdsa.swarm_tick(st, None, cfg)              # warm up

    def ticks(s, k):
        for _ in range(k):
            s = tdsa.swarm_tick(s, None, cfg)
        return s

    before = port_n2.LAUNCHES
    out, waits = _sync_waits(lambda: ticks(st, 4))
    assert not waits, waits
    assert port_n2.LAUNCHES == before + 4
    assert bool((out.task_winner >= 0).any())
    fs = tdsa.make_swarm(4096, spread=60.0, seed=1, device=cuda)
    for deposit in ("scatter", "sorted"):
        fcfg = _field_cfg(field_deposit=deposit)
        fs = tdsa.swarm_tick(fs, None, fcfg)         # the tables land
        _, waits = _sync_waits(lambda: tdsa.swarm_tick(fs, None, fcfg))
        assert not waits, (deposit, waits)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["field-scatter", "field-sorted",
                                  "auction", "auction-field",
                                  "window-auction-field"])
def test_graph_replayed_rollout_with_field_or_auction_equals_eager(
        cuda, monkeypatch, case):
    # A hashgrid rollout on the slots kernel (or a window rollout with its
    # re-sort) with the field, the auction or both: replayed in chunks, it
    # equals the eager rollout on every field across a kill, and launches
    # its separation kernel (and N2) once a tick.
    extra = {}
    if case.startswith("field"):
        extra["field_deposit"] = case.split("-")[1]
    cfg = _field_cfg(**extra)
    sep_mod = port_grid
    if "auction" in case:
        cfg = cfg.replace(allocation_mode="auction", auction_every=3,
                          utility_threshold=5.0)
        if case == "auction":
            cfg = cfg.replace(k_align=0.0, k_coh=0.0)
    if case.startswith("window"):
        cfg = cfg.replace(separation_mode="window", sort_every=8)
        sep_mod = port_win
    # The auction pads to S = max(N, T): agents past the tasks bid for
    # zero-valued slots, a price war of thousands of rounds at 8,192.
    n = 1024 if "auction" in case else 8192
    spans = (20, 13) if sep_mod is port_grid else (24, 16)
    runs = {}
    replays = port_swarm.replays_graphs
    for replay in (False, True):
        monkeypatch.setattr(port_swarm, "replays_graphs",
                            replays if replay else lambda dev: False)
        monkeypatch.setattr(port_swarm, "_chunk", None)
        st = _led_swarm(cuda, n, 32, 60.0, seed=2)
        before = (sep_mod.LAUNCHES, port_n2.LAUNCHES)
        for k, ticks in enumerate(spans):
            if k:
                st = tdsa.kill(st, [n - 1, 5])
            st = port_swarm.swarm_rollout(st, None, cfg, ticks)
        torch.cuda.synchronize()
        auction = cfg.allocation_mode == "auction"
        assert (sep_mod.LAUNCHES - before[0],
                port_n2.LAUNCHES - before[1]) == (
            sum(spans), sum(spans) if auction else 0)
        runs[replay] = st
        if replay:
            assert port_swarm._chunk is not None
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(runs[False], f), getattr(runs[True], f)), f
    if cfg.allocation_mode == "auction":
        won = runs[True].task_winner[runs[True].task_winner >= 0]
        assert won.numel() > 0 and won.unique().numel() == won.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("deposit", ["scatter", "sorted"])
def test_field_deposit_repeats_bit_for_bit_on_the_card(cuda, deposit):
    # The per-cell sums take a fixed order (no atomics), so two runs are
    # equal; against the CPU the field keeps its band (2e-4 relative,
    # 2e-5 of the largest value).
    rng = np.random.default_rng(6)
    pos = torch.from_numpy(rng.uniform(-64.0, 64.0, (65536, 2))
                           .astype(np.float32))
    vel = torch.from_numpy(rng.normal(size=(65536, 2)).astype(np.float32))
    alive = torch.from_numpy(rng.random(65536) > 0.05)
    g = port_gm.commensurate_geometry(64.0, 2.0)[0]
    plan = port_hp.build_hashgrid_plan(pos.to(cuda), alive.to(cuda), 64.0,
                                       2.0, 16, g=g, field_sep_cell=2.0)
    args = (pos.to(cuda), vel.to(cuda), alive.to(cuda), 64.0, 2.0)
    kw = dict(keys=port_hp.plan_field_keys(plan), deposit=deposit,
              plan=plan if deposit == "sorted" else None)
    one = port_gm.cic_field_commensurate(*args, **kw)
    two = port_gm.cic_field_commensurate(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    cpu = port_gm.cic_field_commensurate(pos, vel, alive, 64.0, 2.0)
    for a, b in zip(one, cpu):
        scale = max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-5 * scale)
