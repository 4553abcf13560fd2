#!/usr/bin/env python3
"""Clock the hashgrid tick's two kernels of one or more checkouts of the
port on the same inputs, and the replayed rollouts' chunk length.

    python3 hashgrid_clock.py [ROOT ...]

From the root of the repository, on a machine with a CUDA card and the
CUDA toolkit.  Each ROOT is the root of a checkout of the repository
(default: this file's own); each is timed in a process of its own that
imports that checkout's ``distributed_swarm_algorithm_tpu_torch``, in the
order given, so that ``OLD NEW NEW OLD`` brackets a drift of the card's
clock.  Imports nothing of JAX.

1. Inputs, made once by this file's checkout: the final states of
   ``chip_smoke.py``'s hashgrid runs (phase 7: 65,536 agents on the torus
   [-256, 256)^2, 1,000 ticks with the leader killed after 500; station,
   converge, and the fast movers on a Verlet plan), saved under
   ``build/``.  Then, in that process, the replayed rollouts of the
   station and the fast movers at chunks of 10, 20 and 50 ticks: 500
   ticks that capture the chunk, then 500 that replay it alone.
2. For each ROOT, on those states and on plans that checkout builds
   itself (``build_tick_plan``): B2 (``grid_separation``) at the station's
   and converge's states, the kernel's wrapper back to back (CUDA events
   around 50 calls) and from a CUDA graph of 50 calls, and the whole
   function ``separation_hashgrid`` (its operands, the kernel, the
   rescue) from a graph; B3 (``candidate_sweep``) at the fast movers'
   state, back to back and from a graph.

Prints one JSON line a measurement and, on the line before the last, the
card's name and power limit; the last line is ``{"ok": true}``.  Exits
non-zero on any failure.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STATES = os.path.join(HERE, "build", "hashgrid_clock_states.pt")
REPS = 50
CHUNKS = (10, 20, 50)
SWEEP_TICKS = 500


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (its configurations
    and timers; it imports only torch and numpy at load)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(**fields):
    print(json.dumps(fields), flush=True)


def configs(dsa, cs):
    base = dsa.DEFAULT_CONFIG.replace(**cs.HG_BASE)
    fast = dsa.DEFAULT_CONFIG.replace(**dict(cs.HG_BASE, **cs.HG_FAST))
    settle = dsa.DEFAULT_CONFIG.replace(**cs.HG_BASE, max_speed=5.0)
    return base, fast, settle


def rollout_ms(dsa, state, cfg, ticks):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    dsa.swarm_rollout(state, None, cfg, ticks)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def make_inputs():
    """Step 1: the three final states, saved; then the chunk sweep."""
    import torch

    import distributed_swarm_algorithm_tpu_torch as dsa
    from distributed_swarm_algorithm_tpu_torch.models import swarm as swm

    cs = smoke()
    base, fast, settle = configs(dsa, cs)
    states = {}
    for name, station in (("station", True), ("converge", False)):
        sw = cs.run_hashgrid(dsa, {}, base, station)[0]
        states[name] = sw.state
    states["fast"] = cs.run_fast_movers(dsa, {}, settle, fast)[0]
    os.makedirs(os.path.dirname(STATES), exist_ok=True)
    torch.save({k: dict(pos=s.pos.cpu(), alive=s.alive.cpu())
                for k, s in states.items()}, STATES)
    emit(phase="inputs", agents=cs.HG_N,
         cap_overflow={k: int(dsa.build_tick_plan(s, base).cap_overflow)
                       for k, s in states.items() if k != "fast"})
    for chunk in CHUNKS:
        swm.HASHGRID_CHUNK = chunk
        for name, cfg in (("station", base), ("fast movers", fast)):
            state = states["station" if name == "station" else "fast"]
            swm._chunk = None
            swm.CHUNKS_RERUN = 0
            first = rollout_ms(dsa, state, cfg, SWEEP_TICKS)
            again = rollout_ms(dsa, state, cfg, SWEEP_TICKS)
            emit(phase="chunk_length", scenario=name, chunk_ticks=chunk,
                 ticks=SWEEP_TICKS, ms_per_tick_with_capture=first
                 / SWEEP_TICKS, ms_per_tick_replayed=again / SWEEP_TICKS,
                 capture_ms=first - again, chunks_rerun=swm.CHUNKS_RERUN,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        swm._chunk = None


def time_root(root):
    """Step 2 in ROOT's checkout of the package."""
    import torch

    import distributed_swarm_algorithm_tpu_torch as dsa
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        candidate_sweep as cand,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        grid_separation as grid,
    )

    where = os.path.dirname(os.path.abspath(dsa.__file__))
    if os.path.dirname(where) != root:
        raise SystemExit(f"imported the package from {where}, not {root}")
    cs = smoke()
    base, fast, _ = configs(dsa, cs)
    saved = torch.load(STATES)
    dev = torch.device("cuda")

    def state_of(name):
        s = dsa.make_swarm(cs.HG_N, device=dev, seed=0)
        return s.replace(pos=saved[name]["pos"].to(dev),
                         alive=saved[name]["alive"].to(dev))

    budget = base.hashgrid_overflow_budget
    for name in ("station", "converge"):
        state = state_of(name)
        plan = dsa.build_tick_plan(state, base)
        pos, g, k, hw = state.pos, plan.g, plan.max_per_cell, plan.torus_hw
        r = grid._stencil_radius(plan.cell_eff, cs.R + plan.skin)
        if hasattr(grid, "sweep_operands"):
            ops = grid.sweep_operands(pos, plan)

            def kernel():
                return grid.grid_sweep_cuda(ops, g, k, r, budget, cs.K_SEP,
                                            cs.R, cs.EPS, hw)
        else:
            x, y, slot = grid.slot_planes(pos, plan)

            def kernel():
                return grid.grid_sweep_cuda(x, y, slot, g, k, r, cs.K_SEP,
                                            cs.R, cs.EPS, hw)

        def function():
            return grid.separation_hashgrid(
                pos, state.alive, cs.K_SEP, cs.R, cs.EPS,
                cell=float(base.grid_cell) + plan.skin, max_per_cell=k,
                torus_hw=hw, overflow_budget=budget, plan=plan)

        rec = dict(kernel_ms=cs.cuda_ms(kernel, REPS),
                   kernel_graph_ms=cs.graph_ms(kernel, REPS),
                   function_ms=cs.cuda_ms(function, REPS))
        try:
            rec["function_graph_ms"] = cs.graph_ms(function, REPS)
        except RuntimeError as e:         # a function that cannot capture
            rec["function_graph_error"] = str(e)[:200]
        emit(phase="kernel_clock", root=root, kernel="grid_separation",
             scenario=name, cap_overflow=int(plan.cap_overflow), **rec)
    state = state_of("fast")
    plan = dsa.build_tick_plan(state, fast)

    def candidates():
        return cand.candidate_sweep_cuda(state.pos, plan.cand, plan.recv,
                                         cs.K_SEP, cs.R, cs.EPS,
                                         plan.torus_hw)

    n = cs.HG_N
    emit(phase="kernel_clock", root=root, kernel="candidate_sweep",
         scenario="fast movers", tables=list(plan.cand.shape)
         + [plan.recv.shape[1]],
         valid_entries=int((plan.cand < n).sum() + (plan.recv < n).sum()),
         kernel_ms=cs.cuda_ms(candidates, REPS),
         kernel_graph_ms=cs.graph_ms(candidates, REPS))


def run(args, env=None):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                          env=env)
    if proc.returncode != 0:
        raise SystemExit(f"{args} failed with code {proc.returncode}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--inputs", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--time", metavar="ROOT", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.inputs:
        make_inputs()
        return 0
    if a.time:
        sys.path.insert(0, a.time)
        time_root(a.time)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    run(["--inputs"])
    for root in a.roots:
        run(["--time", os.path.abspath(root)])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
