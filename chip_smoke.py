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
   against its own at five (W = 600 and W = 3000 included);
4. CPU vs GPU: the port's tick on the CPU and on the card, 100 ticks with
   the same injected jitter and a leader kill, ends in equal discrete
   state, in "pallas" mode and in "window" mode with a re-sort every 8
   ticks (compared in agent-id order);
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
   state.

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
           sort_every=cfg.sort_every, agents=n_cmp, ticks=ticks_cmp,
           leaders_before_and_after_kill=leaders, unequal_fields=unequal,
           slot_order_equal=same_slots,
           max_pos_dev_m=float(np.abs(a["pos"] - b["pos"]).max()),
           median_pos_dev_m=float(np.median(np.abs(a["pos"] - b["pos"]))))
    check(not unequal, f"discrete fields differ CPU vs GPU: {unequal}")
    check(leaders == [[n_cmp - 1] * 2, [n_cmp - 2] * 2],
          f"unexpected leaders {leaders}")


def run_main_path(dsa, kernels, n, cfg, ticks, kill_after):
    """The bench scenario through ``VectorSwarm``: ``kill_after`` ticks,
    the leader killed, the rest of ``ticks``.  Every kernel's launch count
    is set to 0 just before and read just after.  Returns the swarm, the
    counts, the leaders and the CUDA-event milliseconds of each span."""
    sw = dsa.VectorSwarm(n, spread=BENCH_SPREAD, config=cfg, seed=0)
    sw.add_tasks(BENCH_TASKS)
    sw.set_target([50.0, 0.0])
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


def device_breakdown(sw, n_ticks):
    """Kernel time per tick on the card, from a ``torch.profiler`` trace of
    ``n_ticks`` more ticks: the sum over every CUDA kernel, memset and copy,
    the launches, and the kernels that take most of it.  The profiler slows
    the host, not the kernels, so the sum is compared with the unprofiled
    tick.  An empty trace reads as None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass   # the first trace of a process pays the profiler's set-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw.step(n_ticks)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.device_time_total / 1e3 / n_ticks, e.count / n_ticks)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1])
    if not rows:
        return None, None, []
    top = [dict(kernel=k[:90], ms_per_tick=ms, per_tick=c)
           for k, ms, c in rows[:8]]
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), top)


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
    from distributed_swarm_algorithm_tpu_torch.state import AGENT_AXIS_FIELDS

    kernels = {"separation": sep, "window_separation": win}
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
    check(launches == {"separation": BENCH_TICKS, "window_separation": 0},
          f"unexpected launches {launches}")
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
    check(launches == {"separation": 0, "window_separation": WIN_TICKS},
          f"unexpected launches {launches}")
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
