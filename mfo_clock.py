#!/usr/bin/env python3
"""Clock the MFO run of one or more checkouts of the port: its time with
its spread, and its kernel's device time a launch.

    python3 mfo_clock.py [--reps R] [ROOT ...]

From the root of the repository, on a machine with a CUDA card and the
CUDA toolkit.  Each ROOT is the root of a checkout of the repository
(default: this file's own); each is timed in a process of its own that
imports that checkout's ``distributed_swarm_algorithm_tpu_torch``, in the
order given, so that ``OLD NEW NEW OLD`` brackets a drift of the card's
clock.  Imports nothing of JAX.

The run is ``chip_smoke.py``'s (phase 12): ``MFO`` on rastrigin, 1,048,576
moths of 30 dimensions, seed 0, ``t_max`` 1,000, launches of 8 steps; a
warm-up launch, then 256 steps timed with CUDA events, R + 1 times from
the same state and generator (the first not kept), then once more under a
``torch.profiler`` trace, which must end where the timed runs ended.

Prints one JSON line a ROOT (the runs' milliseconds, their median, least
and most; the kernel's device milliseconds a launch in the traced run; the
best flame at the end) and, on the line before the last, the card's name
and power limit; the last line is ``{"ok": true}``.  Exits non-zero on any
failure.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

N, DIM, STEPS, K, T_MAX = 1 << 20, 30, 256, 8, 1000


def clock(reps: int) -> dict:
    """The run of the package on ``sys.path``, timed ``reps`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import distributed_swarm_algorithm_tpu_torch as dsa
    from distributed_swarm_algorithm_tpu_torch.ops.mfo import (
        MFO_TENSOR_FIELDS,
    )

    opt = dsa.MFO("rastrigin", n=N, dim=DIM, seed=0, steps_per_kernel=K,
                  t_max=T_MAX)
    opt.run(K)
    start = (opt.state, opt.state.gen.get_state())

    def restart():
        opt.state = start[0]
        opt.state.gen.set_state(start[1])

    def one() -> float:
        restart()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        opt.run(STEPS)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    runs = [one() for _ in range(reps + 1)][1:]
    end = opt.state
    restart()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.run(STEPS)
        torch.cuda.synchronize()
    if not all(torch.equal(getattr(opt.state, f), getattr(end, f))
               for f in MFO_TENSOR_FIELDS):
        raise RuntimeError("the traced run differs from the timed ones")
    kernel_us = sum(
        getattr(e, "device_time_total", 0) for e in prof.key_averages()
        if "mfo_" in e.key and "kernel" in e.key)
    if kernel_us <= 0:
        raise RuntimeError("the trace holds no time of the MFO kernel")
    return dict(runs_ms=runs, median_ms=statistics.median(runs),
                min_ms=min(runs), max_ms=max(runs),
                kernel_device_ms_per_launch=kernel_us / 1e3 / (STEPS // K),
                best=float(end.flame_fit[0]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        sys.path.insert(0, args.one)
        print(json.dumps(dict(root=args.one, **clock(args.reps))),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("mfo_clock.py: no CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    for root in args.roots or [here]:
        root = os.path.abspath(root)
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--reps", str(args.reps), "--one", root],
                             cwd=root)
        if rc != 0:
            print(f"mfo_clock.py: {root} failed ({rc})", file=sys.stderr)
            return rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
