#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX.  Phases, each of which must pass:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, one nvcc per source, started
   together, into build/kernels/;
3. kernel vs plain: the separation kernel against its plain PyTorch
   version on the card at three shapes;
4. CPU vs GPU: the port's tick on the CPU and on the card, 100 ticks with
   the same injected jitter and a leader kill, ends in equal discrete state;
5. full width: the protocol bench scenario (65,536 agents in +-1000 m,
   4 tasks, shared target [50, 0], V formation, separation_mode="pallas")
   through ``VectorSwarm`` for 120 ticks, the leader killed at tick 60;
   the kernel must launch once per tick, the leader go 65535 -> 65534;
   then the kernel is timed beside its plain version at that shape.

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
# Published peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# |kernel - plain| <= REL_BAND * sum_j |term_ij| + ABS_BAND: both take the
# same squared distances (so the same pairs count as near) and differ only
# by a few ulps per term and by the order of the sum.
REL_BAND, ABS_BAND = 1e-5, 1e-6


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import distributed_swarm_algorithm_tpu_torch as dsa
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import _build
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        separation as sep,
    )

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
    per_source = _build.build(["separation"])
    ptxas = [ln.strip() for ln in _build.build_log("separation").splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    record(phase="build", seconds=time.perf_counter() - t0,
           per_source=per_source, ptxas=ptxas)

    # 3. kernel vs plain on the card ----------------------------------------
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

    # 4. the port on the CPU and on the card --------------------------------
    n_cmp, ticks_cmp = 1024, 100
    cfg = dsa.DEFAULT_CONFIG.replace(separation_mode="pallas")
    cpu = dsa.make_swarm(n_cmp, seed=1, spread=32.0, device="cpu")
    cpu = dsa.with_tasks(cpu, BENCH_TASKS)
    cpu = cpu.replace(target=torch.tensor([50.0, 0.0]).expand_as(cpu.pos)
                      .clone(), has_target=torch.ones_like(cpu.has_target))
    gpu = dsa.state_from_numpy(dsa.state_to_numpy(cpu), device=dev)
    jitter = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.election_jitter_ticks + 1, (ticks_cmp, n_cmp)
    ).astype(np.int32))
    leaders = []
    for lo, hi in ((0, KILL_AT - 1), (KILL_AT - 1, ticks_cmp)):
        if lo:
            cpu, gpu = dsa.kill(cpu, [n_cmp - 1]), dsa.kill(gpu, [n_cmp - 1])
        cpu = dsa.swarm_rollout(cpu, None, cfg, hi - lo, jitter=jitter[lo:hi])
        gpu = dsa.swarm_rollout(gpu, None, cfg, hi - lo,
                                jitter=jitter[lo:hi].to(dev))
        leaders.append([int(dsa.current_leader(s)[0]) for s in (cpu, gpu)])
    a, b = dsa.state_to_numpy(cpu), dsa.state_to_numpy(gpu)
    unequal = [f for f in a if a[f].dtype.kind in "biu"
               and not np.array_equal(a[f], b[f])]
    record(phase="cpu_vs_gpu", agents=n_cmp, ticks=ticks_cmp,
           leaders_before_and_after_kill=leaders, unequal_fields=unequal,
           max_pos_dev_m=float(np.abs(a["pos"] - b["pos"]).max()),
           median_pos_dev_m=float(np.median(np.abs(a["pos"] - b["pos"]))))
    check(not unequal, f"discrete fields differ CPU vs GPU: {unequal}")
    check(leaders == [[n_cmp - 1] * 2, [n_cmp - 2] * 2],
          f"unexpected leaders {leaders}")

    # 5. the main path at full width ----------------------------------------
    sw = dsa.VectorSwarm(BENCH_N, spread=BENCH_SPREAD, config=cfg, seed=0)
    sw.add_tasks(BENCH_TASKS)
    sw.set_target([50.0, 0.0])
    torch.cuda.synchronize()
    sep.LAUNCHES = 0
    spans = []
    leaders = []
    for n_ticks in (KILL_AT, BENCH_TICKS - KILL_AT):
        if spans:
            sw.kill([BENCH_N - 1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sw.step(n_ticks)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
        leaders.append(sw.leader())
    launches = sep.LAUNCHES
    state = sw.state
    total_ms = sum(spans)
    record(
        phase="full_width", agents=BENCH_N, ticks=BENCH_TICKS,
        separation_mode="pallas", leaders=leaders,
        launches={"separation": launches},
        ms_per_tick=total_ms / BENCH_TICKS,
        ms_per_tick_after_kill=spans[1] / (BENCH_TICKS - KILL_AT),
        agent_steps_per_sec=BENCH_N * BENCH_TICKS / (total_ms / 1e3),
        tasks_awarded=int((state.task_winner >= 0).sum()),
        pos_finite=bool(torch.isfinite(state.pos).all()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    check(leaders == [(BENCH_N - 1, True), (BENCH_N - 2, True)],
          f"unexpected leaders {leaders}")
    check(launches == BENCH_TICKS, f"{launches} kernel launches in "
          f"{BENCH_TICKS} ticks")
    check(bool(torch.isfinite(state.pos).all()), "non-finite positions")
    check(tuple(state.pos.shape) == (BENCH_N, 2), "wrong state shape")

    # The kernel at the main path's shape: against its plain version, its
    # time beside the plain version's and the bound.
    pos, alive = state.pos, state.alive
    _, cmp = compare_separation(sep, pos, alive, "main path, final state")
    kernel_ms = cuda_ms(
        lambda: sep.separation_cuda(pos, alive, K_SEP, R, EPS), 20)
    plain_ms = cuda_ms(
        lambda: sep.separation_plain(pos, alive, K_SEP, R, EPS), 3)
    bound_ms, bound_by = separation_bound_ms(pos, alive)
    record(phase="separation_timing", shape=[BENCH_N, 2], kernel_ms=kernel_ms,
           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
           near_pairs=near_pairs(pos, alive), smi=smi,
           seconds_so_far=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [{
        "name": "separation",
        "route": "cuda",
        "source": "distributed_swarm_algorithm_tpu_torch/csrc/separation.cu",
        "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                    "separation.py:84",
        "launches": launches,
        "max_abs_err": cmp["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
