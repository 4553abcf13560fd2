"""Command-line interface of the PyTorch port.

  swarm   the vectorized swarm (VectorSwarm) on the CUDA card, or on the
          CPU with ``--device cpu``

The other subcommands of the JAX package's CLI are ported with their
slices (ROADMAP Queue A).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_swarm(args) -> int:
    import torch

    from .models.swarm import VectorSwarm
    from .utils.config import DEFAULT_CONFIG

    cfg = DEFAULT_CONFIG.replace(separation_mode=args.separation)
    sw = VectorSwarm(args.n, dim=args.dim, seed=args.seed,
                     spread=args.spread, config=cfg, device=args.device)
    if args.target:
        sw.set_target([float(x) for x in args.target])
    start = time.perf_counter()
    sw.step(args.steps)
    if sw.device.type == "cuda":
        torch.cuda.synchronize(sw.device)
    elapsed = time.perf_counter() - start
    lid, exists = sw.leader()
    print(json.dumps({
        "agents": args.n,
        "ticks": args.steps,
        "backend": f"torch-{sw.device.type}",
        "leader": lid if exists else None,
        "ticks_per_sec": round(args.steps / elapsed, 1),
        "agent_steps_per_sec": round(args.steps * args.n / elapsed, 1),
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="distributed_swarm_algorithm_tpu_torch"
    )
    sub = parser.add_subparsers(dest="cmd")

    p_swarm = sub.add_parser("swarm", help="vectorized swarm on the GPU")
    p_swarm.add_argument("--n", type=int, default=1024)
    p_swarm.add_argument("--dim", type=int, default=2)
    p_swarm.add_argument("--steps", type=int, default=1000)
    p_swarm.add_argument("--seed", type=int, default=0)
    p_swarm.add_argument("--spread", type=float, default=10.0)
    p_swarm.add_argument("--target", nargs="+", default=None)
    p_swarm.add_argument(
        "--separation", default="dense", choices=["dense", "pallas", "off"],
        help="neighbor separation: dense all-pairs broadcast, pallas "
             "(exact all pairs by the CUDA kernel; the name is the "
             "config value of the JAX package), or off",
    )
    p_swarm.add_argument(
        "--device", default=None, choices=["cuda", "cpu"],
        help="where the swarm runs (default: cuda; without a CUDA device "
             "the command fails unless cpu is asked for)",
    )
    p_swarm.set_defaults(fn=_cmd_swarm)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    try:
        return args.fn(args)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
