#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX.  Phases, each of which must pass:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, one nvcc per source, started
   together, into build/kernels/;
3. kernel vs plain: the separation kernel against its plain PyTorch
   version on the card at three shapes, the window-separation kernel
   against its own at five (W = 600 and W = 3000 included), the hashgrid
   slot kernel at four (R = 1, R = 2, past the cap, a stale skinned plan)
   and the candidate kernel at four (skin 0, stale, after partial
   refreshes, truncated tables);
4. CPU vs GPU: the port's tick on the CPU and on the card, 100 ticks with
   the same injected jitter and a leader kill, ends in equal discrete
   state, in "pallas" mode, in "window" mode with a re-sort every 8 ticks
   (compared in agent-id order), and in "hashgrid" mode with the slot
   kernel and with the candidate kernel on a partially refreshed plan;
5. full width, "pallas": the protocol bench scenario (65,536 agents in
   +-1000 m, 4 tasks, shared target [50, 0], V formation) through
   ``VectorSwarm`` for 120 ticks, the leader killed at tick 60; the kernel
   must launch once per tick, the leader go 65535 -> 65534; then the kernel
   is timed beside its plain version at that shape;
6. full width, "window": the JAX package's 1M flagship row
   (benchmarks/bench_swarm_tpu.py:55, 1,048,576 agents, sort_every=8) in
   the same scenario through ``VectorSwarm`` for 800 ticks, the leader
   killed after tick 400; the window kernel must launch once per tick, the
   leader go 1048575 -> 1048574; a ``torch.profiler`` trace of 16 more
   ticks gives the device's busy time per tick and its heaviest kernels;
   then the window kernel is timed beside its plain version at the final
   state;
7. full width, "hashgrid": the JAX package's bounded-arena rows
   (benchmarks/bench_swarm_tpu.py:43 and :49, 65,536 agents spawned in
   +-250 m on the torus [-256, 256)^2, cap 16, rescue budget 1024, no
   formation), each for 1,000 ticks with the leader killed after tick 500:
   (a) station keeping (every agent holds its spawn position) through
   ``VectorSwarm``, with a ``torch.profiler`` trace of 16 more ticks and
   the plan build's share of the tick (its own events and trace);
   (b) converging on [50, 0], which crowds cells past the cap, so the
   final state must show ``cap_overflow > 0`` and the rescue engaged;
   (c) the fast-mover regime of benchmarks/decompose_rebuild.py:222-233
   (``max_speed=5``, the candidates kernel on a Verlet plan, skin 1.5, cap
   24, neighbor cap 48, the partial refresh) through ``swarm_rollout(...,
   return_plan=True)`` from the station scenario settled for 48 ticks,
   reporting the plan's rebuilds, rows rebuilt and cap overflow.  Each run
   must launch its kernel once per tick and no other kernel, and the
   leader must go 65535 -> 65534.  Then the slot kernel (at the station
   and converge final states) and the candidate kernel (at its final
   state) are held against their plain versions and timed beside them.

Each main-path run sets every kernel's launch count to 0 just before it
and reads the counts just after.

Earlier lines are JSON records of each phase.  The line before the last
holds ``{"kernels": [...]}``; the last is the ``{"ok": true, ...}`` line.
Any failure raises, so the script exits non-zero and prints no ok line.
It exits non-zero at once where no CUDA device is available.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

K_SEP, R, EPS = 20.0, 2.0, 1e-3
BENCH_N, BENCH_SPREAD, BENCH_TICKS, KILL_AT = 65_536, 1000.0, 120, 60
BENCH_TASKS = [[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0], [0.0, 9.0]]
# The window tick: bench_swarm_tpu.py:55, (1_048_576, "window", 800, 8).
WIN_N, WIN_TICKS, WIN_KILL_AFTER, WIN_SORT_EVERY = 1_048_576, 800, 400, 8
CELL, WINDOW = 2.0, 16
# The hashgrid rows: bench_swarm_tpu.py:43 (converge) and :49 (station),
# scenario built at :64-90; the fast movers of decompose_rebuild.py:222-233.
HG_N, HG_SPREAD, HG_HW, HG_TICKS, HG_KILL_AFTER = (65_536, 250.0, 256.0,
                                                    1000, 500)
HG_SETTLE = 48
HG_BASE = dict(separation_mode="hashgrid", formation_shape="none",
               world_hw=HG_HW, grid_max_per_cell=16,
               hashgrid_overflow_budget=1024)
HG_FAST = dict(max_speed=5.0, hashgrid_kernel="candidates",
               hashgrid_skin=1.5, grid_max_per_cell=24,
               hashgrid_neighbor_cap=48, hashgrid_partial_refresh=True)
# Published peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# |kernel - plain| <= REL_BAND * sum_j |term_ij| + ABS_BAND: both take the
# same squared distances (so the same pairs count as near) and differ only
# by a few ulps per term and by the order of the sum.
REL_BAND, ABS_BAND = 1e-5, 1e-6
# The window kernel repeats its plain version op for op (IEEE intrinsics,
# the same shift order), so its band is ten times tighter.
WIN_REL_BAND, WIN_ABS_BAND = 1e-6, 1e-7


def record(**fields):
    print(json.dumps(fields), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run, timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def near_pairs(pos, alive):
    """Ordered pairs (i, j), i != j, both alive, closer than R."""
    n = pos.shape[0]
    rows = max(1, (1 << 24) // n)
    ids = torch.arange(n, device=pos.device)
    total = 0
    for s in range(0, n, rows):
        e = min(n, s + rows)
        d2 = ((pos[s:e, None, :] - pos[None, :, :]) ** 2).sum(-1)
        near = ((d2 < R * R) & (ids[s:e, None] != ids[None, :])
                & alive[s:e, None] & alive[None, :])
        total += int(near.sum())
    return total


def separation_bound_ms(pos, alive):
    """Least time for one separation call on this card: each pair's
    squared distance and cut (3D operations), each near pair's force
    (rsqrt, clamp, three products for k/d^3, a multiply-add per axis:
    2D + 5), over the f32 peak; against each input read and each output
    written once over the memory rate."""
    n, dim = pos.shape
    ops = n * n * 3 * dim + near_pairs(pos, alive) * (2 * dim + 5)
    nbytes = n * dim * 4 * 2 + n
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes")


def compare_separation(sep, pos, alive, label):
    """Hold the kernel against the plain version on the same inputs."""
    before = sep.LAUNCHES
    got = sep.separation_cuda(pos, alive, K_SEP, R, EPS)
    torch.cuda.synchronize()
    check(sep.LAUNCHES == before + 1, f"{label}: launch not counted")
    want = sep.separation_plain(pos, alive, K_SEP, R, EPS)
    scale = sep.separation_abs_sum(pos, alive, K_SEP, R, EPS)
    err = (got - want).abs()
    ratio = float((err / (REL_BAND * scale + ABS_BAND)).max())
    out = dict(
        phase="kernel_vs_plain", kernel="separation", shape=label,
        max_abs_err=float(err.max()),
        max_rel_err=float((err / want.abs().clamp(min=1e-30)).max()),
        max_abs_force=float(want.abs().max()),
        band=f"|kernel-plain| <= {REL_BAND}*sum|terms| + {ABS_BAND}",
        worst_share_of_band=ratio,
    )
    record(**out)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite force")
    check(ratio <= 1.0, f"{label}: kernel outside its band of plain")
    check(bool((got[~alive.bool()] == 0).all()), f"{label}: dead agent moved")
    return got, out


def window_pair_counts(pos, alive):
    """(tests, near): the (slot, shift) pairs of the window pass whose
    partner is a real slot and both agents alive, and those of them closer
    than R."""
    from distributed_swarm_algorithm_tpu_torch.ops.neighbors import (
        window_shifts,
    )
    alive = alive.bool()
    tests = near = 0
    for s, valid in window_shifts(pos.shape[0], WINDOW, pos.device):
        both = valid & alive & torch.roll(alive, s, 0)
        d = (pos - torch.roll(pos, s, 0)).norm(dim=1)
        tests += int(both.sum())
        near += int((both & (d < R)).sum())
    return tests, near


def window_bound_ms(pos, alive):
    """Least time for one window-kernel call on this card: each tested
    pair's distance (two differences, two products, a sum, a square root,
    the clamp and the cut: 8 operations) and each near pair's force (dc^2,
    a division for k/dc^2, per axis a product, a division and a sum: 8),
    over the f32 peak; against positions and alive flags read once and the
    force written once over the memory rate."""
    n = pos.shape[0]
    tests, near = window_pair_counts(pos, alive)
    ops = tests * 8 + near * 8
    nbytes = n * (8 + 1) + n * 8
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), tests, near


def compare_window(win, nb, pos, alive, window, presorted, label):
    """Hold the window kernel against its plain version on the same
    inputs."""
    before = win.LAUNCHES
    got = win.separation_window(pos, alive, K_SEP, R, EPS, CELL, window,
                                presorted=presorted)
    torch.cuda.synchronize()
    check(win.LAUNCHES == before + 1, f"{label}: launch not counted")
    want = nb.separation_window(pos, alive, K_SEP, R, EPS, CELL, window,
                                presorted=presorted)
    scale = nb.separation_window(pos, alive, K_SEP, R, EPS, CELL, window,
                                 presorted=presorted, absolute=True)
    err = (got - want).abs()
    ratio = float((err / (WIN_REL_BAND * scale + WIN_ABS_BAND)).max())
    out = dict(
        phase="kernel_vs_plain", kernel="window_separation", shape=label,
        window=window, presorted=presorted,
        max_abs_err=float(err.max()),
        bitwise_equal=bool(torch.equal(got, want)),
        max_abs_force=float(want.abs().max()),
        agents_with_force=int((want != 0).any(1).sum()),
        band=f"|kernel-plain| <= {WIN_REL_BAND}*sum|terms| + {WIN_ABS_BAND}",
        worst_share_of_band=ratio,
    )
    record(**out)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite force")
    check(ratio <= 1.0, f"{label}: kernel outside its band of plain")
    check(bool((got[~alive.bool()] == 0).all()), f"{label}: dead agent moved")
    return got, out


def morton_sorted(nb, pos, alive):
    order = torch.sort(nb.morton_keys(pos, CELL), stable=True).indices
    return pos[order].contiguous(), alive[order].contiguous()


def in_id_order(arrays, agent_axis_fields):
    """The state's numpy arrays with the agent axis put in id order."""
    order = np.argsort(arrays["agent_id"], kind="stable")
    return {f: (a[order] if f in agent_axis_fields else a)
            for f, a in arrays.items()}


def random_swarm(n, dim, seed, box, dead, co_locate, device):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-box, box, (n, dim)).astype(np.float32)
    alive = rng.random(n) >= dead
    if co_locate:
        pos[1] = pos[0]
        pos[2] = pos[0]
        alive[:3] = True
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(alive).to(device))


def cpu_vs_gpu(dsa, cfg, jitter, dev, agent_axis_fields):
    """The port on the CPU and on the card, 100 ticks with the same jitter
    and a leader kill at tick 60; discrete state compared in id order."""
    n_cmp, ticks_cmp = jitter.shape[1], jitter.shape[0]
    cpu = dsa.make_swarm(n_cmp, seed=1, spread=32.0, device="cpu")
    cpu = dsa.with_tasks(cpu, BENCH_TASKS)
    cpu = cpu.replace(target=torch.tensor([50.0, 0.0]).expand_as(cpu.pos)
                      .clone(), has_target=torch.ones_like(cpu.has_target))
    gpu = dsa.state_from_numpy(dsa.state_to_numpy(cpu), device=dev)
    leaders = []
    for lo, hi in ((0, KILL_AT - 1), (KILL_AT - 1, ticks_cmp)):
        if lo:
            cpu, gpu = dsa.kill(cpu, [n_cmp - 1]), dsa.kill(gpu, [n_cmp - 1])
        cpu = dsa.swarm_rollout(cpu, None, cfg, hi - lo, jitter=jitter[lo:hi])
        gpu = dsa.swarm_rollout(gpu, None, cfg, hi - lo,
                                jitter=jitter[lo:hi].to(dev))
        leaders.append([int(dsa.current_leader(s)[0]) for s in (cpu, gpu)])
    a, b = dsa.state_to_numpy(cpu), dsa.state_to_numpy(gpu)
    same_slots = bool(np.array_equal(a["agent_id"], b["agent_id"]))
    a, b = in_id_order(a, agent_axis_fields), in_id_order(b, agent_axis_fields)
    unequal = [f for f in a if a[f].dtype.kind in "biu"
               and not np.array_equal(a[f], b[f])]
    record(phase="cpu_vs_gpu", separation_mode=cfg.separation_mode,
           sort_every=cfg.sort_every, hashgrid_kernel=cfg.hashgrid_kernel,
           hashgrid_skin=cfg.hashgrid_skin, agents=n_cmp, ticks=ticks_cmp,
           leaders_before_and_after_kill=leaders, unequal_fields=unequal,
           slot_order_equal=same_slots,
           max_pos_dev_m=float(np.abs(a["pos"] - b["pos"]).max()),
           median_pos_dev_m=float(np.median(np.abs(a["pos"] - b["pos"]))))
    check(not unequal, f"discrete fields differ CPU vs GPU: {unequal}")
    check(leaders == [[n_cmp - 1] * 2, [n_cmp - 2] * 2],
          f"unexpected leaders {leaders}")


def run_main_path(dsa, kernels, n, cfg, ticks, kill_after):
    """The bench scenario through ``VectorSwarm``: ``kill_after`` ticks,
    the leader killed, the rest of ``ticks``."""
    sw = dsa.VectorSwarm(n, spread=BENCH_SPREAD, config=cfg, seed=0)
    sw.add_tasks(BENCH_TASKS)
    sw.set_target([50.0, 0.0])
    return drive(sw, kernels, n, ticks, kill_after)


def device_breakdown(sw, n_ticks):
    """Kernel time per tick on the card, from a ``torch.profiler`` trace of
    ``n_ticks`` more ticks: the sum over every CUDA kernel, memset and copy,
    the launches, and the kernels that take most of it.  The profiler slows
    the host, not the kernels, so the sum is compared with the unprofiled
    tick.  An empty trace reads as None (not measured)."""
    return device_time(lambda: sw.step(n_ticks), n_ticks)


def device_time(fn, n_calls):
    """(busy ms, device operations, heaviest operations) per call of
    ``fn``, which makes ``n_calls`` calls, from a ``torch.profiler`` trace
    (see ``device_breakdown``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass   # the first trace of a process pays the profiler's set-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.device_time_total / 1e3 / n_calls, e.count / n_calls)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1])
    if not rows:
        return None, None, []
    top = [dict(kernel=k[:90], ms_per_tick=ms, per_tick=c)
           for k, ms, c in rows[:8]]
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), top)


def plan_build_share(dsa, state, cfg, ms_per_tick, busy_ms, ops, smi):
    """The hashgrid plan build alone at ``state``: its time on the device
    timeline per call (CUDA events, so the host's launch gaps count, as
    they do in the tick) and its device busy time and operations (a
    trace), each beside the tick's."""
    build_ms = cuda_ms(lambda: dsa.build_tick_plan(state, cfg), 50)
    reps = 16

    def builds():
        for _ in range(reps):
            dsa.build_tick_plan(state, cfg)

    b_busy, b_ops, _ = device_time(builds, reps)
    record(phase="plan_build_share", ms_per_call=build_ms,
           share_of_tick=build_ms / ms_per_tick,
           device_busy_ms_per_call=b_busy, device_ops_per_call=b_ops,
           share_of_device_busy=(None if b_busy is None or busy_ms is None
                                 else b_busy / busy_ms),
           share_of_device_ops=(None if b_ops is None or ops is None
                                else b_ops / ops), smi=smi)


def hashgrid_swarm(n, seed, hw, crowd, dev, dead=0.1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (n, 2)).astype(np.float32)
    pos[:crowd] = (1.0 + 0.5 * rng.normal(size=(crowd, 2))).astype(
        np.float32)
    alive = rng.random(n) >= dead
    alive[:crowd] = True
    return (torch.from_numpy(pos).to(dev), torch.from_numpy(alive).to(dev))


def compare_grid_sweep(grid, pos, plan, label):
    """Hold the slot kernel against its plain version on the planes of
    ``plan`` at ``pos``.  Returns (record, sweep args)."""
    g, k = plan.g, plan.max_per_cell
    r = grid._stencil_radius(plan.cell_eff, R + plan.skin)
    x, y, slot = grid.slot_planes(pos, plan)
    args = (x, y, slot, g, k, r, K_SEP, R, EPS, plan.torus_hw)
    before = grid.LAUNCHES
    fx, fy = grid.grid_sweep_cuda(*args)
    torch.cuda.synchronize()
    check(grid.LAUNCHES == before + 1, f"{label}: launch not counted")
    px, py = grid.grid_sweep_plain(*args)
    sx, sy = grid.grid_sweep_plain(*args, absolute=True)
    err = torch.maximum((fx - px).abs(), (fy - py).abs())
    ratio = float(torch.maximum((fx - px).abs() / (REL_BAND * sx + ABS_BAND),
                                (fy - py).abs() / (REL_BAND * sy + ABS_BAND)
                                ).max())
    out = dict(
        phase="kernel_vs_plain", kernel="grid_separation", shape=label,
        g=g, K=k, R=r, in_grid=int(plan.ok.sum()),
        cap_overflow=int(plan.cap_overflow),
        max_abs_err=float(err.max()),
        bitwise_equal=bool(torch.equal(fx, px) and torch.equal(fy, py)),
        max_abs_force=float(torch.maximum(px.abs(), py.abs()).max()),
        band=f"|kernel-plain| <= {REL_BAND}*sum|terms| + {ABS_BAND}",
        worst_share_of_band=ratio,
    )
    record(**out)
    check(bool(torch.isfinite(fx).all() and torch.isfinite(fy).all()),
          f"{label}: non-finite force")
    check(ratio <= 1.0, f"{label}: kernel outside its band of plain")
    check(bool((fx[x == grid.SENTINEL] == 0).all()),
          f"{label}: an empty slot got force")
    return out, args


def compare_candidates(cand, pos, plan, label):
    """Hold the candidate kernel against its plain version on ``plan``'s
    tables at ``pos``."""
    before = cand.LAUNCHES
    got = cand.candidate_sweep_cuda(pos, plan.cand, plan.recv, K_SEP, R, EPS,
                                    plan.torus_hw)
    torch.cuda.synchronize()
    check(cand.LAUNCHES == before + 1, f"{label}: launch not counted")
    want = cand.candidate_sweep_plain(pos, plan.cand, plan.recv, K_SEP, R,
                                      EPS, plan.torus_hw)
    scale = cand.candidate_sweep_plain(pos, plan.cand, plan.recv, K_SEP, R,
                                       EPS, plan.torus_hw, absolute=True)
    err = (got - want).abs()
    ratio = float((err / (WIN_REL_BAND * scale + WIN_ABS_BAND)).max())
    out = dict(
        phase="kernel_vs_plain", kernel="candidate_sweep", shape=label,
        g=plan.g, W=plan.cand.shape[1], RK=plan.recv.shape[1],
        cand_overflow=int(plan.cand_overflow),
        recv_overflow=int(plan.recv_overflow),
        max_abs_err=float(err.max()),
        bitwise_equal=bool(torch.equal(got, want)),
        max_abs_force=float(want.abs().max()),
        agents_with_force=int((want != 0).any(1).sum()),
        band=f"|kernel-plain| <= {WIN_REL_BAND}*sum|terms| + {WIN_ABS_BAND}",
        worst_share_of_band=ratio,
    )
    record(**out)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite force")
    check(ratio <= 1.0, f"{label}: kernel outside its band of plain")
    return out


def hashgrid_small_shapes(hp, grid, cand, dev):
    """Phase 3's hashgrid part: each kernel against its plain version."""
    hw = 16.0
    for label, cell, k, crowd, skin in (
        ("n=600 R=1", 2.0, 8, 0, 0.0), ("n=600 R=2 half cells", 1.0, 8, 0,
                                        0.0),
        ("n=600 R=1, 40 past the cap", 2.0, 8, 40, 0.0),
        ("n=600 stale plan, skin 0.5", 1.5, 16, 0, 0.5),
    ):
        pos, alive = hashgrid_swarm(600, 3, hw, crowd, dev)
        g = (int(2 * hw / (cell + skin)) // 16) * 16
        plan = hp.build_hashgrid_plan(pos, alive, hw, cell, k, g=g, skin=skin)
        if skin:
            gen = torch.Generator(device=dev).manual_seed(0)
            pos = pos + 0.34 * (torch.rand(pos.shape, generator=gen,
                                           device=dev) - 0.5)
        compare_grid_sweep(grid, pos, plan, label)
    for label, crowd, k, skin, w, rk, refreshes in (
        ("n=800 skin 0", 0, 24, 0.0, 128, 48, 0),
        ("n=800 stale plan, skin 0.5", 0, 24, 0.5, 128, 48, 0),
        ("n=800 after 3 partial refreshes", 0, 24, 0.5, 128, 48, 3),
        ("n=800, truncated rows and receivers", 60, 8, 0.0, 32, 8, 0),
    ):
        pos, alive = hashgrid_swarm(800, 5, hw, crowd, dev)
        g = int(2 * hw / (2.0 + skin))
        plan = hp.build_hashgrid_plan(pos, alive, hw, 2.0, k, g=g, skin=skin,
                                      need_csr=True, neighbor_cap=w,
                                      recv_cap=rk)
        gen = torch.Generator(device=dev).manual_seed(1)
        if skin and not refreshes:
            pos = pos + 0.4 * (torch.rand(pos.shape, generator=gen,
                                          device=dev) - 0.5)
        for _ in range(refreshes):
            pos = pos + 0.45 * torch.randn(pos.shape, generator=gen,
                                           device=dev)
            plan = hp.refresh_plan_partial(pos, alive, plan)
        compare_candidates(cand, pos, plan, label)


def stencil_tests(plan, counts, r):
    """Tested (receiver, partner) pairs an exact slot sweep needs: for each
    in-grid agent, the in-grid agents of its (2R+1)^2 stencil cells other
    than itself."""
    g, k = plan.g, plan.max_per_cell
    occ = counts.clamp(max=k).reshape(g, g)
    around = torch.zeros_like(occ)
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            around += torch.roll(occ, (dr, dc), (0, 1))
    return int((occ * (around - 1)).sum())


def grid_bound_ms(grid, nb, plan, args):
    """Least time for one slot-kernel call: the planes read and the force
    planes written once, the slot index read once (bytes), against each
    needed pair test (two differences, two wraps, a product, a
    multiply-add, the cut: 8 operations) and each near pair's force (the
    clamp, rsqrt, three products, two products and two sums: 9)."""
    x, _, slot = args[:3]
    counts = nb.cell_counts(plan.key, plan.g * plan.g)
    tests = stencil_tests(plan, counts, args[5])
    _, tx, ty = grid._sweep_terms(*args)
    near = int(((tx != 0) | (ty != 0)).sum())
    ops = tests * 8 + near * 9
    nbytes = 4 * x.numel() * 4 + 4 * slot.numel()
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), tests, near


def candidate_bound_ms(cand, pos, plan):
    """Least time for one candidate-kernel call: the tables and positions
    read and the force written once (bytes), against each (receiver,
    candidate) test (two differences, two wraps, a product, a multiply-add,
    the square root, the cut: 9 operations) and each near pair's force
    (the clamp, two products, a division, two products, two sums: 8)."""
    n = pos.shape[0]
    valid_c = (plan.cand < n).sum(1)
    valid_r = (plan.recv < n).sum(1)
    tests = int((valid_r * (valid_c - 1).clamp(min=0)).sum())
    agents = plan.recv.reshape(-1)
    cells = torch.arange(plan.recv.shape[0], device=pos.device
                         ).repeat_interleave(plan.recv.shape[1])
    keep = agents < n
    rows = plan.cand[cells[keep]]
    npos = pos[rows.clamp(max=n - 1).long()]
    d = pos[agents[keep].long()][:, None, :] - npos
    d = torch.where(d >= plan.torus_hw, d - 2 * plan.torus_hw,
                    torch.where(d < -plan.torus_hw, d + 2 * plan.torus_hw, d))
    near = int(((rows < n) & (d.norm(dim=-1) < R)
                & (rows != agents[keep][:, None])).sum())
    ops = tests * 9 + near * 8
    nbytes = (4 * (plan.cand.numel() + plan.recv.numel()) + 8 * n + 8 * n)
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), tests, near


def hashgrid_launch_check(launches, kernel, ticks):
    want = {name: 0 for name in launches}
    want[kernel] = ticks
    check(launches == want, f"unexpected launches {launches}")


def run_hashgrid(dsa, kernels, cfg, station):
    """The bench's bounded arena through ``VectorSwarm``: ``HG_KILL_AFTER``
    ticks, the leader killed, the rest of ``HG_TICKS``; counts set to 0
    just before and read just after."""
    sw = dsa.VectorSwarm(HG_N, spread=HG_SPREAD, config=cfg, seed=0)
    sw.add_tasks(BENCH_TASKS)
    sw.set_target(sw.state.pos.clone() if station else [50.0, 0.0])
    return drive(sw, kernels, HG_N, HG_TICKS, HG_KILL_AFTER)


def drive(sw, kernels, n, ticks, kill_after):
    """``kill_after`` ticks of ``sw``, the leader killed, the rest of
    ``ticks``.  Every kernel's launch count is set to 0 just before and
    read just after.  Returns the swarm, the counts, the leaders and the
    CUDA-event milliseconds of each span."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.LAUNCHES = 0
    spans, leaders = [], []
    for n_ticks in (kill_after, ticks - kill_after):
        if spans:
            sw.kill([n - 1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sw.step(n_ticks)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
        leaders.append(sw.leader())
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    state = sw.state
    check(leaders == [(n - 1, True), (n - 2, True)],
          f"unexpected leaders {leaders}")
    check(bool(torch.isfinite(state.pos).all()), "non-finite positions")
    check(tuple(state.pos.shape) == (n, 2), "wrong state shape")
    return sw, launches, leaders, spans


def run_fast_movers(dsa, kernels, settle_cfg, cfg):
    """The fast-mover regime through ``swarm_rollout(..., return_plan=
    True)``: the station scenario settled for ``HG_SETTLE`` ticks, then
    ``HG_KILL_AFTER`` ticks, the leader killed, the rest of ``HG_TICKS``.
    Returns the final state and plan, the counts, leaders, spans and the
    plan counters of each half."""
    sw = dsa.VectorSwarm(HG_N, spread=HG_SPREAD, config=settle_cfg, seed=0)
    sw.add_tasks(BENCH_TASKS)
    sw.set_target(sw.state.pos.clone())
    sw.step(HG_SETTLE)
    state = sw.state
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.LAUNCHES = 0
    spans, leaders, counters = [], [], []
    plan = None
    for n_ticks in (HG_KILL_AFTER, HG_TICKS - HG_KILL_AFTER):
        if spans:
            state = dsa.kill(state, [HG_N - 1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, plan = dsa.swarm_rollout(state, None, cfg, n_ticks,
                                        return_plan=True)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
        lid, exists = dsa.current_leader(state)
        leaders.append((int(lid), bool(exists)))
        counters.append(dict(
            ticks=n_ticks, rebuilds=int(plan.rebuilds),
            cells_rebuilt=int(plan.cells_rebuilt), age=int(plan.age),
            cap_overflow=int(plan.cap_overflow),
            cand_overflow=int(plan.cand_overflow),
            recv_overflow=int(plan.recv_overflow),
            rows_per_full_build=plan.g * plan.g))
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    check(leaders == [(HG_N - 1, True), (HG_N - 2, True)],
          f"unexpected leaders {leaders}")
    check(bool(torch.isfinite(state.pos).all()), "non-finite positions")
    return state, plan, launches, leaders, spans, counters


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import distributed_swarm_algorithm_tpu_torch as dsa
    from distributed_swarm_algorithm_tpu_torch.ops import neighbors as nb
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        separation as sep,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        window_separation as win,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        grid_separation as grid,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        candidate_sweep as cand,
    )
    from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as hp
    from distributed_swarm_algorithm_tpu_torch.state import AGENT_AXIS_FIELDS

    kernels = {"separation": sep, "window_separation": win,
               "grid_separation": grid, "candidate_sweep": cand}
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record(phase="device", kind=kind, nvidia_smi=smi,
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda)

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build(list(kernels))
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name in kernels}
    record(phase="build", seconds=time.perf_counter() - t0,
           per_source=per_source, ptxas=ptxas)

    # 3. kernels vs plain on the card ---------------------------------------
    for label, n, dim, box, dead, co in (
        ("n=300 D=2, 20% dead, co-located trio", 300, 2, 5.0, 0.2, True),
        ("n=4096 D=3", 4096, 3, 10.0, 0.0, False),
        ("n=65536 D=2 spread 1000", BENCH_N, 2, BENCH_SPREAD, 0.0, False),
    ):
        pos, alive = random_swarm(n, dim, n, box, dead, co, dev)
        got, _ = compare_separation(sep, pos, alive, label)
        if co:
            check(torch.equal(got[1], got[0]) and torch.equal(got[2], got[0]),
                  "co-located trio feels different forces")
    for label, n, box, dead, co, window, presorted in (
        ("n=300, 20% dead, co-located trio", 300, 5.0, 0.2, True, 8, True),
        ("n=5000 unsorted", 5000, 40.0, 0.0, False, 16, False),
        ("n=1048576 spread 1000", WIN_N, BENCH_SPREAD, 0.0, False, 16, True),
        ("n=4096, W=600 (staged halo)", 4096, 20.0, 0.0, False, 600, True),
        ("n=4096, W=3000 (global reads)", 4096, 20.0, 0.0, False, 3000,
         True),
    ):
        pos, alive = random_swarm(n, 2, n, box, dead, co, dev)
        p0 = pos[0].clone()
        if presorted:
            pos, alive = morton_sorted(nb, pos, alive)
        got, _ = compare_window(win, nb, pos, alive, window, presorted, label)
        if co:   # the stable sort keeps the trio in adjacent slots
            trio = torch.nonzero((pos == p0).all(1)).flatten()
            check(len(trio) == 3 and int(trio[2] - trio[0]) == 2
                  and bool(torch.isfinite(got[trio]).all()),
                  "co-located trio lost or given a non-finite force")

    hashgrid_small_shapes(hp, grid, cand, dev)

    # 4. the port on the CPU and on the card --------------------------------
    rng = np.random.default_rng(2)
    cfg = dsa.DEFAULT_CONFIG.replace(separation_mode="pallas")
    cpu_vs_gpu(dsa, cfg, torch.from_numpy(rng.integers(
        0, cfg.election_jitter_ticks + 1, (100, 1024)).astype(np.int32)),
        dev, AGENT_AXIS_FIELDS)
    # Window mode: the jitter is equal for every agent in a tick, so slot
    # order (which may differ where the two devices round differently)
    # cannot change the election.
    wcfg = dsa.DEFAULT_CONFIG.replace(separation_mode="window",
                                      sort_every=WIN_SORT_EVERY)
    cpu_vs_gpu(dsa, wcfg, torch.from_numpy(np.repeat(rng.integers(
        0, cfg.election_jitter_ticks + 1, (100, 1)), 1024, 1)
        .astype(np.int32)), dev, AGENT_AXIS_FIELDS)
    # Hashgrid mode on the torus [-64, 64)^2 (the target [50, 0] inside):
    # the slot kernel with the rescue, and the candidate kernel on a plan
    # carried with the partial refresh.
    hg_cmp = dsa.DEFAULT_CONFIG.replace(**dict(HG_BASE, world_hw=64.0,
                                               hashgrid_overflow_budget=256))
    for hcfg in (hg_cmp, hg_cmp.replace(**HG_FAST)):
        cpu_vs_gpu(dsa, hcfg, torch.from_numpy(rng.integers(
            0, cfg.election_jitter_ticks + 1, (100, 1024)).astype(np.int32)),
            dev, AGENT_AXIS_FIELDS)

    # 5. the main path at full width, "pallas" ------------------------------
    sw, launches, leaders, spans = run_main_path(
        dsa, kernels, BENCH_N, cfg, BENCH_TICKS, KILL_AT)
    state = sw.state
    total_ms = sum(spans)
    record(
        phase="full_width", agents=BENCH_N, ticks=BENCH_TICKS,
        separation_mode="pallas", leaders=leaders, launches=launches,
        ms_per_tick=total_ms / BENCH_TICKS,
        ms_per_tick_after_kill=spans[1] / (BENCH_TICKS - KILL_AT),
        agent_steps_per_sec=BENCH_N * BENCH_TICKS / (total_ms / 1e3),
        tasks_awarded=int((state.task_winner >= 0).sum()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    hashgrid_launch_check(launches, "separation", BENCH_TICKS)
    sep_launches = launches["separation"]

    # The kernel at the main path's shape: against its plain version, its
    # time beside the plain version's and the bound.
    pos, alive = state.pos, state.alive
    _, sep_cmp = compare_separation(sep, pos, alive, "main path, final state")
    sep_ms = cuda_ms(
        lambda: sep.separation_cuda(pos, alive, K_SEP, R, EPS), 20)
    sep_plain_ms = cuda_ms(
        lambda: sep.separation_plain(pos, alive, K_SEP, R, EPS), 3)
    sep_bound_ms, sep_bound_by = separation_bound_ms(pos, alive)
    record(phase="separation_timing", shape=[BENCH_N, 2], kernel_ms=sep_ms,
           plain_ms=sep_plain_ms, bound_ms=sep_bound_ms, bound_by=sep_bound_by,
           near_pairs=near_pairs(pos, alive), smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    del sw, state, pos, alive

    # 6. the main path at full width, "window" ------------------------------
    sw, launches, leaders, spans = run_main_path(
        dsa, kernels, WIN_N, wcfg, WIN_TICKS, WIN_KILL_AFTER)
    state = sw.state
    total_ms = sum(spans)
    ms_per_tick = total_ms / WIN_TICKS
    record(
        phase="full_width", agents=WIN_N, ticks=WIN_TICKS,
        separation_mode="window", sort_every=WIN_SORT_EVERY, window=WINDOW,
        leaders=leaders, launches=launches, ms_per_tick=ms_per_tick,
        ms_per_tick_after_kill=spans[1] / (WIN_TICKS - WIN_KILL_AFTER),
        agent_steps_per_sec=WIN_N * WIN_TICKS / (total_ms / 1e3),
        tasks_awarded=int((state.task_winner >= 0).sum()),
        ids_moved=int((state.agent_id != torch.arange(
            WIN_N, dtype=state.agent_id.dtype, device=dev)).sum()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    hashgrid_launch_check(launches, "window_separation", WIN_TICKS)
    win_launches = launches["window_separation"]
    busy_ms, kernels_per_tick, top = device_breakdown(sw, 2 * WIN_SORT_EVERY)
    record(phase="window_tick_breakdown", agents=WIN_N,
           profiled_ticks=2 * WIN_SORT_EVERY, ms_per_tick=ms_per_tick,
           device_busy_ms_per_tick=busy_ms,
           device_idle_share=(None if busy_ms is None
                              else 1.0 - busy_ms / ms_per_tick),
           device_ops_per_tick=kernels_per_tick, top_device_ops=top, smi=smi)
    state = sw.state

    # The window kernel at the main path's shape and order (the final
    # state, sorted at most 8 ticks ago).
    pos, alive = state.pos, state.alive
    _, win_cmp = compare_window(win, nb, pos, alive, WINDOW, True,
                                "main path, final state")
    win_ms = cuda_ms(lambda: win.separation_window_cuda(
        pos, alive, K_SEP, R, EPS, WINDOW), 50)
    win_plain_ms = cuda_ms(lambda: nb.separation_window(
        pos, alive, K_SEP, R, EPS, CELL, WINDOW, presorted=True), 5)
    win_bound_ms, win_bound_by, tests, near = window_bound_ms(pos, alive)
    record(phase="window_timing", shape=[WIN_N, 2], window=WINDOW,
           kernel_ms=win_ms, plain_ms=win_plain_ms, bound_ms=win_bound_ms,
           bound_by=win_bound_by, pair_tests=tests, near_pairs=near,
           kernel_share_of_tick=win_ms / ms_per_tick, smi=smi,
           seconds_so_far=time.perf_counter() - t_start)

    del sw, state, pos, alive

    # 7. the main path at full width, "hashgrid" ----------------------------
    hg = {}
    for name, station in (("station", True), ("converge", False)):
        hcfg = dsa.DEFAULT_CONFIG.replace(**HG_BASE)
        sw, launches, leaders, spans = run_hashgrid(dsa, kernels, hcfg,
                                                    station)
        total_ms = sum(spans)
        ms_per_tick = total_ms / HG_TICKS
        state = sw.state
        plan = dsa.build_tick_plan(state, hcfg)
        live_over = int(plan.cap_overflow)
        record(
            phase="full_width", agents=HG_N, ticks=HG_TICKS,
            separation_mode="hashgrid", hashgrid_kernel="slots",
            scenario=name, leaders=leaders, launches=launches,
            ms_per_tick=ms_per_tick,
            ms_per_tick_after_kill=spans[1] / (HG_TICKS - HG_KILL_AFTER),
            agent_steps_per_sec=HG_N * HG_TICKS / (total_ms / 1e3),
            tasks_awarded=int((state.task_winner >= 0).sum()),
            final_cap_overflow=live_over,
            final_rescued=min(live_over, hcfg.hashgrid_overflow_budget),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        hashgrid_launch_check(launches, "grid_separation", HG_TICKS)
        if station:
            busy_ms, per_tick, top = device_breakdown(sw, 16)
            record(phase="hashgrid_tick_breakdown", agents=HG_N,
                   scenario=name, profiled_ticks=16,
                   ms_per_tick=ms_per_tick, device_busy_ms_per_tick=busy_ms,
                   device_idle_share=(None if busy_ms is None
                                      else 1.0 - busy_ms / ms_per_tick),
                   device_ops_per_tick=per_tick, top_device_ops=top, smi=smi)
            state = sw.state
            plan_build_share(dsa, state, hcfg, ms_per_tick, busy_ms, per_tick,
                             smi)
            plan = dsa.build_tick_plan(state, hcfg)
        else:
            check(live_over > 0, "the converge run shows no cap overflow")
        cmp, args = compare_grid_sweep(grid, state.pos, plan,
                                       f"main path, {name} final state")
        ms = cuda_ms(lambda: grid.grid_sweep_cuda(*args), 50)
        plain_ms = cuda_ms(lambda: grid.grid_sweep_plain(*args), 5)
        bound_ms, bound_by, tests, near = grid_bound_ms(grid, nb, plan, args)
        hg[name] = dict(launches=launches["grid_separation"], cmp=cmp, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        record(phase="grid_separation_timing", scenario=name,
               planes=[plan.g, plan.g, plan.max_per_cell], kernel_ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               pair_tests=tests, near_pairs=near,
               kernel_share_of_tick=ms / ms_per_tick, smi=smi,
               seconds_so_far=time.perf_counter() - t_start)
        del sw, state, plan, args

    fcfg = dsa.DEFAULT_CONFIG.replace(**dict(HG_BASE, **HG_FAST))
    settle = dsa.DEFAULT_CONFIG.replace(**HG_BASE, max_speed=5.0)
    state, plan, launches, leaders, spans, counters = run_fast_movers(
        dsa, kernels, settle, fcfg)
    total_ms = sum(spans)
    ms_per_tick = total_ms / HG_TICKS
    record(
        phase="full_width", agents=HG_N, ticks=HG_TICKS,
        separation_mode="hashgrid", hashgrid_kernel="candidates",
        scenario="fast movers, partial refresh", leaders=leaders,
        launches=launches, ms_per_tick=ms_per_tick,
        ms_per_tick_after_kill=spans[1] / (HG_TICKS - HG_KILL_AFTER),
        agent_steps_per_sec=HG_N * HG_TICKS / (total_ms / 1e3),
        plan_counters_per_half=counters,
        table_shapes=dict(g=plan.g, W=plan.cand.shape[1],
                          RK=plan.recv.shape[1]),
    )
    hashgrid_launch_check(launches, "candidate_sweep", HG_TICKS)
    plan = hp.refresh_plan_partial(state.pos, state.alive, plan)
    cand_cmp = compare_candidates(cand, state.pos, plan,
                                  "main path, fast-mover final state")
    args = (state.pos, plan.cand, plan.recv, K_SEP, R, EPS, plan.torus_hw)
    cand_ms = cuda_ms(lambda: cand.candidate_sweep_cuda(*args), 50)
    cand_plain_ms = cuda_ms(lambda: cand.candidate_sweep_plain(*args), 5)
    cand_bound_ms, cand_bound_by, tests, near = candidate_bound_ms(
        cand, state.pos, plan)
    record(phase="candidate_sweep_timing", tables=[plan.g * plan.g,
                                                   plan.cand.shape[1],
                                                   plan.recv.shape[1]],
           kernel_ms=cand_ms, plain_ms=cand_plain_ms, bound_ms=cand_bound_ms,
           bound_by=cand_bound_by, pair_tests=tests, near_pairs=near,
           kernel_share_of_tick=cand_ms / ms_per_tick, smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    cand_launches = launches["candidate_sweep"]
    station = hg["station"]

    print(json.dumps({"kernels": [
        {
            "name": "separation",
            "route": "cuda",
            "source": "distributed_swarm_algorithm_tpu_torch/csrc/"
                      "separation.cu",
            "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                        "separation.py:84",
            "launches": sep_launches,
            "max_abs_err": sep_cmp["max_abs_err"],
            "ms": sep_ms,
            "plain_ms": sep_plain_ms,
            "bound_ms": sep_bound_ms,
            "bound_by": sep_bound_by,
            "library_ms": None,
        },
        {
            "name": "window_separation",
            "route": "cuda",
            "source": "distributed_swarm_algorithm_tpu_torch/csrc/"
                      "window_separation.cu",
            "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                        "window_separation.py:149",
            "launches": win_launches,
            "max_abs_err": win_cmp["max_abs_err"],
            "ms": win_ms,
            "plain_ms": win_plain_ms,
            "bound_ms": win_bound_ms,
            "bound_by": win_bound_by,
            "library_ms": None,
        },
        {
            "name": "grid_separation",
            "route": "cuda",
            "source": "distributed_swarm_algorithm_tpu_torch/csrc/"
                      "grid_separation.cu",
            "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                        "grid_separation.py:602",
            "launches": station["launches"],
            "max_abs_err": station["cmp"]["max_abs_err"],
            "ms": station["ms"],
            "plain_ms": station["plain_ms"],
            "bound_ms": station["bound_ms"],
            "bound_by": station["bound_by"],
            "library_ms": None,
        },
        {
            "name": "candidate_sweep",
            "route": "cuda",
            "source": "distributed_swarm_algorithm_tpu_torch/csrc/"
                      "candidate_sweep.cu",
            "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                        "candidate_sweep.py:157",
            "launches": cand_launches,
            "max_abs_err": cand_cmp["max_abs_err"],
            "ms": cand_ms,
            "plain_ms": cand_plain_ms,
            "bound_ms": cand_bound_ms,
            "bound_by": cand_bound_by,
            "library_ms": None,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
