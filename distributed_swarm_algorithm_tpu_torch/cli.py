"""Command-line interface of the PyTorch port.

  swarm   the vectorized swarm (VectorSwarm) on the CUDA card, or on the
          CPU with ``--device cpu``
  pso     particle swarm optimization (PSO, MemeticPSO, or the island
          model with ``--islands``), on the card or with ``--device cpu``
  bat, gwo, salp, woa, de, shade, ga, mfo, cuckoo, hho, abc, pt, firefly
          the optimizer zoo (bat algorithm, grey wolf, salp swarm, whale,
          differential evolution, SHADE, genetic algorithm, moth-flame,
          cuckoo search, Harris hawks, artificial bee colony, parallel
          tempering, firefly algorithm), on the card or with
          ``--device cpu``
  aco     the ant-colony TSP solver, on the card or with ``--device cpu``

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
    if args.separation == "hashgrid":
        # Default arena: 4x the spawn spread, so targets well outside the
        # spawn box stay inside the torus.
        cfg = cfg.replace(world_hw=args.world_hw if args.world_hw > 0
                          else 4.0 * max(args.spread, 1.0))
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


def _cmd_pso(args) -> int:
    if args.islands < 1:
        raise SystemExit(f"error: --islands ({args.islands}) must be >= 1")
    if args.islands > 1:
        # The island path has its own migration-based social structure;
        # reject flags it would otherwise silently drop.
        if args.topology != "gbest" or args.refine_every > 0:
            raise SystemExit(
                "error: --topology/--refine-every are not supported with "
                "--islands > 1 (each island is a gbest swarm; diversity "
                "comes from migration)"
            )
        return _cmd_pso_islands(args)

    kwargs = dict(topology=args.topology, ring_radius=args.ring_radius,
                  device=args.device)
    if args.refine_every > 0:
        from .models.memetic import MemeticPSO

        opt = MemeticPSO(
            args.objective, n=args.n, dim=args.dim, seed=args.seed,
            refine_every=args.refine_every, refine_steps=args.refine_steps,
            lr=args.lr, **kwargs,
        )
    else:
        from .models.pso import PSO

        opt = PSO(args.objective, n=args.n, dim=args.dim, seed=args.seed,
                  **kwargs)
    start = time.perf_counter()
    opt.run(args.steps)
    # run() does not wait for the card; reading the best does, so the
    # clock covers the run and not only its enqueue.
    best = opt.best
    elapsed = time.perf_counter() - start
    print(json.dumps({
        "objective": args.objective,
        "particles": args.n,
        "dim": args.dim,
        "iters": args.steps,
        "topology": args.topology,
        "memetic": args.refine_every > 0,
        "path": _path(opt),
        "backend": f"torch-{opt.device.type}",
        "best": best,
        "steps_per_sec": round(args.steps / elapsed, 1),
    }))
    return 0


def _cmd_pso_islands(args) -> int:
    """Island-model PSO: the fused kernel on the card inside its envelope,
    the portable island step elsewhere."""
    from .ops.cuda.islands_fused import (
        fused_island_run,
        islands_pallas_supported,
    )
    from .ops.objectives import get_objective
    from .parallel.islands import global_best, island_init, island_run

    fn, hw = get_objective(args.objective)
    n_per, rem = divmod(args.n, args.islands)
    if n_per < 1:
        raise SystemExit(
            f"error: --n ({args.n}) must be >= --islands ({args.islands})"
        )
    if rem:
        print(
            f"note: --n {args.n} not divisible by --islands "
            f"{args.islands}; running {n_per * args.islands} particles",
            file=sys.stderr,
        )
    st = island_init(fn, n_islands=args.islands, n_per_island=n_per,
                     dim=args.dim, half_width=hw, seed=args.seed,
                     device=args.device)
    dev = st.pso.device
    use_fused = dev.type == "cuda" and islands_pallas_supported(
        args.objective, st.pso.pos.dtype, st.pso.pos.shape[-1]
    )
    start = time.perf_counter()
    if use_fused:
        st = fused_island_run(
            st, args.objective, args.steps,
            migrate_every=args.migrate_every, migrate_k=args.migrate_k,
            half_width=hw,
        )
    else:
        st = island_run(
            st, fn, args.steps, migrate_every=args.migrate_every,
            migrate_k=args.migrate_k, half_width=hw,
        )
    fit, _ = global_best(st)
    best = float(fit)   # waits for the card, inside the timing
    elapsed = time.perf_counter() - start
    print(json.dumps({
        "objective": args.objective,
        "islands": args.islands,
        "particles_per_island": n_per,
        "dim": args.dim,
        "iters": args.steps,
        "path": "cuda-fused" if use_fused else "portable",
        "backend": f"torch-{dev.type}",
        "best": best,
        "steps_per_sec": round(args.steps / elapsed, 1),
    }))
    return 0


def _path(opt) -> str:
    """Which path an optimizer's ``run`` takes: the fused kernel on the
    card, its plain version on the CPU, or the portable step."""
    if not opt.use_pallas:
        return "portable"
    return "cuda-fused" if opt.device.type == "cuda" else "plain-fused"


def _run_report(opt, args, count_key: str, extra=None) -> int:
    """The optimizer subcommands' tail: a timed run and one JSON line
    (with ``extra``'s keys added)."""
    start = time.perf_counter()
    opt.run(args.steps)
    # run() does not wait for the card; reading the best does, so the
    # clock covers the run and not only its enqueue.
    best = opt.best
    elapsed = time.perf_counter() - start
    print(json.dumps({
        "objective": args.objective,
        count_key: args.n,
        "dim": args.dim,
        "iters": args.steps,
        "path": _path(opt),
        "backend": f"torch-{opt.device.type}",
        "best": best,
        "steps_per_sec": round(args.steps / elapsed, 1),
        **(extra or {}),
    }))
    return 0


def _cmd_bat(args) -> int:
    from .models.bat import Bat

    opt = Bat(args.objective, n=args.n, dim=args.dim, seed=args.seed,
              device=args.device)
    return _run_report(opt, args, "bats")


def _cmd_de(args) -> int:
    from .models.de import DE

    opt = DE(args.objective, n=args.n, dim=args.dim, f=args.f, cr=args.cr,
             variant=args.variant, seed=args.seed, device=args.device)
    return _run_report(opt, args, "population",
                       extra={"variant": args.variant})


def _cmd_shade(args) -> int:
    from .models.shade import SHADE

    opt = SHADE(args.objective, n=args.n, dim=args.dim, seed=args.seed,
                device=args.device)
    return _run_report(opt, args, "individuals")


def _cmd_ga(args) -> int:
    from .models.ga import GA

    opt = GA(args.objective, n=args.n, dim=args.dim, seed=args.seed,
             device=args.device)
    return _run_report(opt, args, "individuals")


def _cmd_cuckoo(args) -> int:
    from .models.cuckoo import Cuckoo

    opt = Cuckoo(args.objective, n=args.n, dim=args.dim, pa=args.pa,
                 seed=args.seed, device=args.device)
    return _run_report(opt, args, "nests")


def _cmd_abc(args) -> int:
    from .models.abc_bees import ABC

    opt = ABC(args.objective, n=args.n, dim=args.dim, limit=args.limit,
              seed=args.seed, device=args.device)
    return _run_report(opt, args, "sources")


def _cmd_pt(args) -> int:
    from .models.tempering import ParallelTempering

    opt = ParallelTempering(args.objective, n=args.n, dim=args.dim,
                            swap_every=args.swap_every, seed=args.seed,
                            device=args.device)
    return _run_report(opt, args, "chains")


def _cmd_firefly(args) -> int:
    from .models.firefly import Firefly

    opt = Firefly(args.objective, n=args.n, dim=args.dim, gamma=args.gamma,
                  alpha0=args.alpha0, seed=args.seed, device=args.device)
    return _run_report(opt, args, "fireflies")


def _cmd_aco(args) -> int:
    import numpy as np

    from .models.aco import ACO

    rng = np.random.default_rng(args.seed)
    if args.cities_file:
        coords = np.loadtxt(args.cities_file, delimiter=",")
    else:
        coords = rng.uniform(0.0, 100.0, size=(args.cities, 2))
    colony = ACO(coords=coords, n_ants=args.ants, alpha=args.alpha,
                 beta=args.beta, rho=args.rho, q0=args.q0, elite=args.elite,
                 seed=args.seed, device=args.device)
    start = time.perf_counter()
    colony.run(args.steps)
    best = colony.best_length      # waits for the card
    elapsed = time.perf_counter() - start
    print(json.dumps({
        "cities": int(coords.shape[0]),
        "ants": args.ants,
        "iters": args.steps,
        "path": _path(colony),
        "backend": f"torch-{colony.device.type}",
        "best_length": round(best, 4),
        "steps_per_sec": round(args.steps / elapsed, 1),
    }))
    return 0


def _scheduled_cmd(module: str, cls: str, noun: str):
    """Handler of a family whose one extra knob is the schedule horizon
    ``--t-max`` (0 means ``--steps``)."""

    def cmd(args) -> int:
        import importlib

        model = getattr(
            importlib.import_module(f".models.{module}", __package__), cls)
        opt = model(args.objective, n=args.n, dim=args.dim,
                    t_max=args.t_max if args.t_max else args.steps,
                    seed=args.seed, device=args.device)
        return _run_report(opt, args, noun)

    return cmd


# (subcommand, module, class, report noun, help text)
_SCHEDULED_FAMILIES = (
    ("gwo", "gwo", "GWO", "wolves", "grey wolf optimizer"),
    ("woa", "woa", "WOA", "whales", "whale optimization"),
    ("salp", "salp", "Salp", "salps", "salp swarm algorithm"),
    ("mfo", "mfo", "MFO", "moths", "moth-flame optimization"),
    ("hho", "hho", "HarrisHawks", "hawks", "Harris hawks optimization"),
)


def _add_device(p) -> None:
    p.add_argument(
        "--device", default=None, choices=["cuda", "cpu"],
        help="where the command runs (default: cuda; without a CUDA device "
             "the command fails unless cpu is asked for)",
    )


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
        "--separation", default="dense",
        choices=["dense", "pallas", "grid", "window", "hashgrid", "off"],
        help="neighbor separation: dense all-pairs broadcast, pallas "
             "(exact all pairs by the CUDA kernel; the name is the "
             "config value of the JAX package), grid (spatial hash), "
             "window (the +-16 Morton-order neighbours by the CUDA kernel; "
             "approximate, for very large N), hashgrid (torus-world hash, "
             "exact up to the cell cap, by the CUDA slot kernel on the "
             "card; see --world-hw), or off",
    )
    p_swarm.add_argument(
        "--world-hw", type=float, default=0.0, metavar="HW",
        help="torus half-width for --separation hashgrid: the world "
             "becomes [-HW, HW)^2 (default: 4x --spread)",
    )
    _add_device(p_swarm)
    p_swarm.set_defaults(fn=_cmd_swarm)

    p_pso = sub.add_parser("pso", help="particle swarm optimization")
    p_pso.add_argument("--objective", default="rastrigin")
    p_pso.add_argument("--n", type=int, default=8192,
                       help="total particles (split across --islands)")
    p_pso.add_argument("--dim", type=int, default=30)
    p_pso.add_argument("--steps", type=int, default=500)
    p_pso.add_argument("--seed", type=int, default=0)
    p_pso.add_argument("--islands", type=int, default=1,
                       help="island-model: number of independent swarms "
                            "with periodic ring migration")
    p_pso.add_argument("--migrate-every", type=int, default=25)
    p_pso.add_argument("--migrate-k", type=int, default=4)
    p_pso.add_argument("--topology", default="gbest",
                       choices=["gbest", "ring", "vonneumann"],
                       help="social topology (lbest ring / torus grid)")
    p_pso.add_argument("--ring-radius", type=int, default=1)
    p_pso.add_argument("--refine-every", type=int, default=0,
                       help="memetic mode: autograd refinement every K "
                            "iterations (0 = off)")
    p_pso.add_argument("--refine-steps", type=int, default=5)
    p_pso.add_argument("--lr", type=float, default=0.01,
                       help="memetic gradient-descent learning rate")
    _add_device(p_pso)
    p_pso.set_defaults(fn=_cmd_pso)

    def optimizer_parser(name, helptext, n=128):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("--objective", default="rastrigin")
        p.add_argument("--n", type=int, default=n)
        p.add_argument("--dim", type=int, default=30)
        p.add_argument("--steps", type=int, default=500)
        p.add_argument("--seed", type=int, default=0)
        _add_device(p)
        return p

    for name, module, cls, noun, helptext in _SCHEDULED_FAMILIES:
        p_fam = optimizer_parser(name, helptext)
        p_fam.add_argument("--t-max", type=int, default=0,
                           help="schedule horizon (default --steps)")
        p_fam.set_defaults(fn=_scheduled_cmd(module, cls, noun))
    optimizer_parser("bat", "bat algorithm").set_defaults(fn=_cmd_bat)
    p_de = optimizer_parser("de", "differential evolution", n=256)
    p_de.add_argument("--f", type=float, default=0.5,
                      help="differential weight F")
    p_de.add_argument("--cr", type=float, default=0.9,
                      help="crossover rate CR")
    p_de.add_argument("--variant", default="rand1bin",
                      choices=["rand1bin", "best1bin"])
    p_de.set_defaults(fn=_cmd_de)
    optimizer_parser("ga", "real-coded genetic algorithm").set_defaults(
        fn=_cmd_ga)
    optimizer_parser("shade", "success-history adaptive DE",
                     n=256).set_defaults(fn=_cmd_shade)
    p_cs = optimizer_parser("cuckoo", "cuckoo search")
    p_cs.add_argument("--pa", type=float, default=0.25,
                      help="nest abandonment probability")
    p_cs.set_defaults(fn=_cmd_cuckoo)
    p_abc = optimizer_parser("abc", "artificial bee colony")
    p_abc.add_argument("--limit", type=int, default=None,
                       help="scout abandonment limit (default n*dim)")
    p_abc.set_defaults(fn=_cmd_abc)
    p_pt = optimizer_parser("pt", "parallel tempering", n=32)
    p_pt.set_defaults(steps=2000)
    p_pt.add_argument("--swap-every", type=int, default=5)
    p_pt.set_defaults(fn=_cmd_pt)
    p_ff = optimizer_parser("firefly", "firefly algorithm")
    p_ff.add_argument("--gamma", type=float, default=1.0,
                      help="light absorption coefficient")
    p_ff.add_argument("--alpha0", type=float, default=0.25,
                      help="initial random-walk scale")
    p_ff.set_defaults(fn=_cmd_firefly)

    p_aco = sub.add_parser("aco", help="ant-colony TSP solver")
    p_aco.add_argument("--cities", type=int, default=32,
                       help="random-uniform instance size")
    p_aco.add_argument("--cities-file", default=None,
                       help="CSV of x,y coordinates (overrides --cities)")
    p_aco.add_argument("--ants", type=int, default=64)
    p_aco.add_argument("--steps", type=int, default=200)
    p_aco.add_argument("--alpha", type=float, default=1.0)
    p_aco.add_argument("--beta", type=float, default=2.0)
    p_aco.add_argument("--rho", type=float, default=0.1)
    p_aco.add_argument("--q0", type=float, default=0.0,
                       help="ACS exploitation probability")
    p_aco.add_argument("--elite", type=float, default=0.0,
                       help="elitist deposit weight on best-so-far tour")
    p_aco.add_argument("--seed", type=int, default=0)
    _add_device(p_aco)
    p_aco.set_defaults(fn=_cmd_aco)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    try:
        return args.fn(args)
    except (ValueError, RuntimeError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
