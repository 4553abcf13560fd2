#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX.  Phases, each of which must pass:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, one nvcc per source, started
   together, into build/kernels/;
3. kernel vs plain: the separation kernel against its plain PyTorch
   version on the card at eight shapes (N below a warp, N one past a
   block's 256 receivers, all dead, a dead receiver among live ones, D = 3,
   a co-located trio, a crowded swarm, N = 65,536), the window-separation
   kernel against its own at five (W = 600 and W = 3000 included), the hashgrid
   slot kernel at four (R = 1, R = 2, past the cap, a stale skinned plan)
   and the candidate kernel at four (skin 0, stale, after partial
   refreshes, truncated tables); the fused PSO kernel at N not a multiple
   of its block, D = 1, 8, 30 and 100, one step and eight, uniforms handed
   in and drawn in the kernel, with and without the best candidate, every
   objective at least once, and the island kernel at 3 ragged islands;
4. CPU vs GPU: the port's tick on the CPU and on the card, 100 ticks with
   the same injected jitter and a leader kill, ends in equal discrete
   state, in "pallas" mode, in "window" mode with a re-sort every 8 ticks
   (compared in agent-id order), and in "hashgrid" mode with the slot
   kernel and with the candidate kernel on a partially refreshed plan;
   and three fused PSO blocks from one state with the same injected
   uniforms on the CPU (plain version) and on the card (kernel);
5. full width, "pallas": the protocol bench scenario (65,536 agents in
   +-1000 m, 4 tasks, shared target [50, 0], V formation) through
   ``VectorSwarm`` for 120 ticks after an 8-tick warm-up swarm, the leader
   killed at tick 60; the kernel must launch once per tick, the leader go
   65535 -> 65534; then the kernel
   is timed beside its plain version at that shape, and on the same number
   of agents inside +-5 m, where every warp takes the force branch; a
   ``torch.profiler`` trace of 16 more ticks gives the device's busy time
   per tick;
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

8. full width, PSO: the JAX package's headline run (bench.py:27-29,158),
   ``PSO("rastrigin", n=1_048_576, dim=30, steps_per_kernel=64)`` for 2,560
   steps after a warm-up run of 64, timed with CUDA events: 40 launches of
   the fused kernel and of no other, gbest never rising from run to run,
   every position inside the domain; the kernel's uniforms of one step
   read back at full width (mean, variance, equal to the plain version's);
   then the kernel at the final state against its plain version over a
   whole 64-step launch, timed beside it and its bound;
9. full width, islands: 64 islands of 16,384 particles, Rastrigin-30D,
   1,280 steps, migration of 4 every 64 (benchmarks/bench_islands.py:18-39)
   through ``fused_island_run``: 20 launches of the island kernel, no
   island's gbest rising, the global best reported; then the island kernel
   against its plain version, timed beside it;
10. full width, memetic: ``MemeticPSO("rastrigin", n=1_048_576, dim=30)``
   for 100 steps (benchmarks/bench_memetic_1m.py:17-23, cut from 256
   steps): fused PSO blocks counted, no personal best worsening;
11. full width, the bat, grey-wolf, salp and whale optimizers, each at its
   JAX bench's configuration, Rastrigin-30D at 1,048,576
   (benchmarks/bench_bat_1m.py:14-22, bench_gwo_1m.py:16-23 with t_max =
   5,120, bench_salp_1m.py:16-22 and bench_woa_1m.py:15-21 with t_max =
   512): ``Bat`` and ``GWO`` for 1,280 steps in launches of 8, ``Salp``
   for 512 in launches of 16, ``WOA`` for 512 in launches of 8, each after
   a warm-up launch, timed with CUDA events: the launch count, no
   incumbent (gwo: no leader) rising, every position inside the domain;
   then one launch of the kernel at the final state against its plain
   version, timed beside it and its bound.  Phase 3 holds the four kernels
   at small ragged shapes (several tiles for salp and whale, 1 and k
   steps, draws handed in and made in the kernel) and phase 4 three
   launches of each on the CPU and on the card;
12. full width, differential evolution, SHADE, the genetic algorithm and
   moth-flame optimization, each at its JAX bench's configuration,
   Rastrigin-30D at 1,048,576 in 256 tiles of 4,096 lanes
   (benchmarks/bench_de_1m.py:16-22, bench_shade_1m.py:16-22,
   bench_ga_1m.py:16-22, bench_mfo_1m.py:17-23 with t_max = 1,000): ``DE``
   for 1,024 steps in launches of 32, ``SHADE`` for 256 generations, one a
   launch, ``GA`` and ``MFO`` for 256 in launches of 8 (MFO re-sorting its
   flames every 8 launches and at the end), each after a warm-up launch,
   timed with CUDA events: the launch count, no incumbent (MFO: no best
   flame) rising, every position inside the domain; SHADE's device busy
   share from a trace of 16 more generations; then one launch of the kernel
   at the final state against its plain version, timed beside it and its
   bound.  Phase 3 holds the four kernels at small ragged shapes (4 tiles or
   more, 1 and k steps, GA at every k from 1 to 8, draws handed in and made
   in the kernel) and phase 4 three launches of each on the CPU and on the
   card;
13. full width, cuckoo search, Harris hawks, the artificial bee colony and
   parallel tempering, each at its JAX bench's configuration, Rastrigin-30D
   at 1,048,576 in 256 tiles of 4,096 lanes (benchmarks/bench_cuckoo_1m.py:
   16-24, bench_hho_1m.py:15-23 with t_max = 256, bench_abc_1m.py:16-24
   with limit = n * dim, bench_pt_1m.py:18-26): ``Cuckoo``, ``HarrisHawks``
   and ``ABC`` for 256 steps in launches of 8, ``ParallelTempering`` for
   512 in launches of 16, each after a warm-up launch, timed with CUDA
   events: the launch count, the incumbent never rising (PT: its best
   visited), every position inside the domain, ABC's trial counters not
   below 0; the device's busy share from a trace of one more launch; then
   one launch of the kernel at the final state against its plain version,
   timed beside it and its bound (the data-dependent work, abandoned,
   exploring, diving, probed and exhausted lanes, tallied by the plain
   version on the same inputs).  Phase 3 holds the four kernels at small
   ragged shapes (4 tiles or more, an explicit tile, every k from 1 to the
   family's cap, draws handed in and made in the kernel, ABC at a small
   limit so that its scouts fire, PT with padded lanes and with the widest
   halo) and phase 4 three launches of each on the CPU and on the card.
14. full width, firefly and ACO at their JAX benches: ``Firefly("rastrigin",
   n=65_536, dim=30)`` for 8 generations and ``n=16_384`` for 32
   (benchmarks/bench_firefly_64k.py:17-24), each after a warm-up run: one
   launch of B19 a generation and no other kernel, the best never rising,
   every position inside the domain, then B19 at the 65,536 final state
   against its plain version within its band, timed beside it and its
   bound, and again on that swarm drawn 50 times closer, where about half
   the pairs attract; ``ACO`` on 256 cities uniform in [0, 100)^2 with 1,024 ants for
   400 iterations (benchmarks/bench_aco.py:28-36) after a warm-up: one
   launch each of B20 and B21 an iteration and no other kernel, the best
   never rising, every tour of the last iteration a permutation with its
   in-kernel lengths the ordered sums, tau symmetric (within 4 ulps / rho)
   and finite, the device's busy share from a trace of 16 more; B20 and B21
   at the final pheromone equal to their plain versions, timed beside them,
   their bounds and ``index_add_`` (B21 and ``index_add_`` replayed from a
   CUDA graph, the device's time alone, and back to back, where the host
   paces them); then C = 512 and 1,024 for 50 iterations (B21 timed at
   each) and the circle of 1,024 for 100 (q0 = 0.1, elite = 4) with
   its gap to the known optimum (benchmarks/bench_aco_sweep.py:35-86).
   Phase 3 holds B19 at N = 1, 127, 300, 1,000 by D = 1, 5, 30, 100, in the
   rectangular form and with equal fitness, and B20 and B21 at C = 2 to
   1,024, A = 1 to 1,000, q0 = 0, 0.5 and 1, draws handed in and made in
   the kernel, constant scores (every greedy step a tie), and B21 alone at
   C = 1, 2, 129 and 2,048, A = 1 to 20,000, on tours that are not
   permutations, one tour for every ant, rows of ~10,000 edges and 313
   bucketing chunks, each call twice and equal; phase 4 three firefly
   generations and three ACO iterations on the CPU and on the card with the
   same draws.

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
# The PSO family: bench.py:27-29,158; bench_islands.py:18-22;
# bench_memetic_1m.py:17-19 (100 of its 256 steps).
PSO_N, PSO_DIM, PSO_STEPS, PSO_K = 1_048_576, 30, 2560, 64
ISL_I, ISL_N, ISL_STEPS, ISL_EVERY, ISL_MIGRANTS = 64, 16_384, 1280, 64, 4
MEM_STEPS = 100
# The optimizer zoo's first group, each at its JAX bench's configuration
# (bench_bat_1m.py:14-22, bench_gwo_1m.py:16-23, bench_salp_1m.py:16-22,
# bench_woa_1m.py:15-21): family -> (steps, steps per launch, t_max).
ZOO_N, ZOO_DIM = 1_048_576, 30
ZOO = {"bat": (1280, 8, None), "gwo": (1280, 8, 5120),
       "salp": (512, 16, 512), "woa": (512, 8, 512)}
ZOO_TPU_KERNELS = {"bat": "bat_fused.py:138", "gwo": "gwo_fused.py:98",
                   "salp": "salp_fused.py:156", "woa": "woa_fused.py:126"}
# Operations of each family kernel, counted from its source (csrc/*_fused.cu)
# with a Philox call at 100 (10 rounds of 4 multiplies and 6 adds or xors),
# a uniform from its bits at 3, rastrigin at 23 per element and 1 per
# particle, expf at 10: (per element and step, per particle and step, per
# element once a launch, per particle once a launch).
#   bat   64 = eps (a quarter call, its uniform, 2u-1: 30), the walk and the
#         flight with their select and clip (9), rastrigin (23), the pos/vel
#         selects (2); 134 = the row call and its three uniforms (109), freq
#         (2), the walk and acceptance tests (4), three selects, the
#         loudness product and the pulse (18), rastrigin's offset (1);
#   gwo   198 = per leader, A's and C's draws (2 x 28) and the attraction
#         term (8), times 3, the sum (3), /3 and the clip (3); 6 = the
#         schedule a; then rastrigin once (23 and 1);
#   salp  28 = the follower (2), the clip (2), rastrigin (23), the running
#         best's select (1); 3 = its test, the fit select, the offset;
#   whale 75 = A's and C's draws (56), A and C (3), the explore test and
#         select (3), the contraction (5), the spiral (5), the select and
#         the clip (3); 147 = the row call and two uniforms (106), a (6),
#         l (2), e^{b l} (11), cos 2 pi l (17), the peer's lane (5); then
#         rastrigin once (23 and 1).
ZOO_OPS = {"bat": (64, 134, 0, 0), "gwo": (198, 6, 23, 1),
           "salp": (28, 3, 0, 0), "woa": (75, 147, 23, 1)}
# The bat and whale runs on the CPU against the card: a last-bit
# difference of exp (and of the bat's mean loudness) carried three steps.
ZOO_CPU_BAND = {"pos": dict(rtol=1e-5, atol=1e-5),
                "fit": dict(rtol=2e-5, atol=2e-5)}
# The rotational-donor families, each at its JAX bench's configuration
# (bench_de_1m.py:16-22, steps_per_kernel 32; bench_shade_1m.py:16-22;
# bench_ga_1m.py:16-22, the driver's 8 steps a launch; bench_mfo_1m.py:17-23,
# t_max 1,000): family -> (steps, steps per launch, t_max).
ROT = {"de": (1024, 32, None), "shade": (256, 1, None), "ga": (256, 8, None),
       "mfo": (256, 8, 1000)}
ROT_TPU_KERNELS = {"de": "de_fused.py:125", "shade": "shade_fused.py:122",
                   "ga": "ga_fused.py:204", "mfo": "mfo_fused.py:139"}
# Their operations, counted as ZOO_OPS from csrc/*_fused.cu: (per element and
# step, per particle and step).
#   de    58 = the draw (a quarter call and its uniform: 28), the crossover
#         test (1), the mutant and its clip (5), the select (1), rastrigin
#         (23); 12 = the three donor lanes, the acceptance and its select,
#         rastrigin's offset;
#   shade 63 = the draw (28), the crossover test (1), the source select (1),
#         the mutant and its clip (9), the select (1), rastrigin (23); 128 =
#         the source uniform's call and bits (103), the donor and elite lanes
#         (20), the fixed-point fraction, the acceptance and selects (5);
#   ga    207 = three draws (84), beta through log2 and 2^x (44), c1 or c2
#         (6), the gate (2), delta (43), the mutation and the clip (5),
#         rastrigin (23); 150 = the gate's call and bits (103), the two
#         tournaments (16), the argmin and argmax with their share of the
#         reductions (30), rastrigin's offset;
#   mfo   101 = the draw (28), l (3), the flame select (1), |flame - x| (2),
#         2^(b l log2 e) (20), cos 2 pi l (17), the spiral and the clip (5),
#         rastrigin (23), the flame update (2); 3 = the own test, the flame
#         fitness test and its select.
ROT_OPS = {"de": (58, 12), "shade": (63, 128), "ga": (207, 150),
           "mfo": (101, 3)}
# SHADE's generations profiled for the device's busy share.
SHADE_PROFILED = 16
# The Levy-flight and multi-evaluation families, each at its JAX bench's
# configuration (bench_cuckoo_1m.py:16-24, bench_hho_1m.py:15-23 with t_max
# 256, bench_abc_1m.py:16-24 with limit n * dim, bench_pt_1m.py:18-26):
# family -> (steps, steps per launch, t_max).
LEVY = {"cuckoo": (256, 8, None), "hho": (256, 8, 256),
        "abc": (256, 8, None), "pt": (512, 16, None)}
LEVY_TPU_KERNELS = {"cuckoo": "cuckoo_fused.py:189",
                    "hho": "hho_fused.py:175", "abc": "abc_fused.py:189",
                    "pt": "tempering_fused.py:210"}
LEVY_SOURCES = {"cuckoo": "cuckoo_fused", "hho": "hho_fused",
                "abc": "abc_fused", "pt": "tempering_fused"}
# Their operations, counted as ZOO_OPS from csrc/*_fused.cu, with the fast
# math of csrc/fast_math.cuh at: log2 18 (the bit fields 5, 6 Horner steps,
# the sum), 2^x 20, cos 2 pi x 17 (sin 18), a Box-Muller pair 58 (1 - u,
# log2, the product, the root, cos and sin, two products; its cosine half
# alone 39), the Levy power |n|^(-1/beta) 41; a NaN-keeping clip 3.  Per
# element and step unless said otherwise; "lane" is per particle and step.
#   cuckoo  elem 188 = the pair's two quarter calls and uniforms (56), the
#           pair (58), the Levy step (43), the flight and its clip (7),
#           rastrigin (23), the egg's select (1); lane 110 = the abandonment
#           call and uniform (103), the egg's lane and test (6), rastrigin's
#           offset; per abandoned element 57 = the walk's draw (28), the walk
#           and its clip (6), rastrigin (23), and 1 per abandoned lane;
#   hho     elem 26 = the final clip (3) and rastrigin (23); lane 126 = the
#           row call and four uniforms (112), t and frac (4), E, |E| and J
#           (7), rastrigin's offset, the branch tests (2); per exploring
#           element 63 = two quarter calls and uniforms (56) and the perch
#           (7); per besieging element 6; per diving element 248 = three
#           quarter calls and uniforms (84), the pair (58), y (5), the Levy
#           step (43), z (2), two clips (6), two rastrigins (46), the pick
#           (4), and 4 per diving lane;
#   abc     elem 31 = the employed candidate (the mask, phi (b - p), the sum
#           and the clip: 8) and rastrigin (23); lane 236 = the two row calls
#           and five uniforms (215), the two dimensions and phis (8), the
#           quality and its share of the tile maximum (7), the gate (2), the
#           trial updates (3), rastrigin's offset; per probed element 31 and
#           1 per probed lane; per exhausted element 54 = the draw (28), the
#           fresh coordinate (3), rastrigin (23), and 1 per exhausted lane;
#   pt      elem 123 = two quarter calls and uniforms (56), the cosine half
#           (39), the move and its clip (5), rastrigin (23); lane 133 = the
#           row call and two uniforms (106), the acceptance (sub, product,
#           min, exp_fast: 24), the running best's test, rastrigin's offset,
#           the select; per lane and exchange round 30 (the validity, the
#           pair's product, min and exp_fast, the test).
FAM_OPS = {
    "cuckoo": dict(elem=188, lane=110, abandoned=57, abandoned_lane=1),
    "hho": dict(elem=26, lane=126, explore=63, besiege=6, dive=248,
                dive_lane=4),
    "abc": dict(elem=31, lane=236, probed=31, probed_lane=1, exhausted=54,
                exhausted_lane=1),
    "pt": dict(elem=123, lane=133, round_lane=30),
}
# Firefly and ACO at their JAX benches (bench_firefly_64k.py:17-24: 65,536
# x 30 for 8 generations, 16,384 x 30 for 32; bench_aco.py:28-36: C = 256
# cities uniform in [0, 100)^2, A = 1,024 ants, 400 iterations;
# bench_aco_sweep.py:35-86: C = 512 and 1,024 for 50 iterations, and the
# circle of 1,024 for 100 with q0 = 0.1, elite = 4).
FF_N, FF_N2, FF_DIM, FF_STEPS, FF_STEPS2 = 65_536, 16_384, 30, 8, 32
ACO_C, ACO_A, ACO_ITERS, ACO_PROFILED = 256, 1024, 400, 16
ACO_SWEEP = ((512, 50), (1024, 50))
ACO_CIRCLE, ACO_CIRCLE_ITERS = 1024, 100
# B19 against its plain version: attraction_band(N_j) * sum|terms| + this.
FF_ABS_BAND = 1e-6
# Operations of B19 and B20/B21, counted from csrc/firefly_fused.cu and
# csrc/aco_fused.cu as FAM_OPS (a Philox call 100, a uniform 3, log2 18),
# only where the function needs them:
#   firefly  per pair 1 (the brightness test); per brighter pair 2 D + 27
#            (the dot product, r^2 4, the exponent's product, exp_fast 21,
#            beta0's product); per pair of nonzero weight 2 D + 1 (the
#            accumulation and the weight sum); |x|^2 and the closing
#            move 2 D a row;
#   tours    (the sampling rule) per block of four cities that holds an open
#            city, and step, 100 (its Philox call); per open city and step
#            49 (its uniform 3; the Gumbel transform: 1 - u, the clip, two
#            log2s, two products and negations; the score and its test);
#            per ant and step 20 (the shuffle argmax, the visited bit, the
#            length, the tour's write);
#   deposit  per tour edge 2 (the match and the add).
FF_OPS = dict(pair=1, brighter=27, weighted=1)
ACO_OPS = dict(open_block=100, open_city=49, step=20, deposit_edge=2)
# Operations per element and step of the fused PSO kernels: two Philox
# calls per four elements (10 rounds of 4 multiplies and 6 adds or xors),
# the two uniforms from their bits, the update with its clamps, and
# rastrigin (square, range reduction, 7 Horner steps, 3 more).
PSO_OPS_PER_ELEMENT_STEP = 50 + 6 + 14 + 23
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


def cuda_ms(fn, reps, warmup=True):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run (unless ``warmup`` is false, for calls of seconds), timed
    with CUDA events."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` with the host out of the way:
    ``reps`` calls captured in one CUDA graph (after a warm-up call),
    replayed and timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


# B1's shapes of phase 3: (label, n, dim, box, dead share, co-located trio,
# one dead receiver among live ones).  A block holds 256 receivers, a warp
# 32 senders a vote; "crowded" puts about 12% of all pairs inside R, so
# every warp takes the force branch on every group.
SEP_SHAPES = (
    ("n=300 D=2, 20% dead, co-located trio", 300, 2, 5.0, 0.2, True, False),
    ("n=5 (below a warp), co-located trio", 5, 2, 1.0, 0.0, True, False),
    ("n=257 (a block and one), one dead receiver", 257, 2, 4.0, 0.0, False,
     True),
    ("n=1000, all dead", 1000, 2, 3.0, 1.01, False, False),
    ("n=4096 D=3", 4096, 3, 10.0, 0.0, False, False),
    ("n=1000 D=3, 20% dead, co-located trio", 1000, 3, 5.0, 0.2, True,
     False),
    ("n=8192 crowded in +-5 m", 8192, 2, 5.0, 0.0, False, False),
    ("n=65536 D=2 spread 1000", BENCH_N, 2, BENCH_SPREAD, 0.0, False, False),
)


def separation_small_shapes(sep, dev):
    """Phase 3's part for B1: the kernel against its plain version at its
    design's edge cases; the co-located trio feels equal forces."""
    for label, n, dim, box, dead, co, one_dead in SEP_SHAPES:
        pos, alive = random_swarm(n, dim, n, box, dead, co, dev)
        if one_dead:
            alive[n // 2] = False
        got, _ = compare_separation(sep, pos, alive, label)
        if co:
            check(torch.equal(got[1], got[0]) and torch.equal(got[2], got[0]),
                  f"{label}: co-located trio feels different forces")
    record(phase="separation_small_shapes", cases=len(SEP_SHAPES))


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


def pso_inputs(pf, name, n, d, seed, dev, islands=0):
    """A transposed swarm on the card from numpy draws: (half width, seed,
    gbest, pos, vel, bpos, bfit, r1, r2).  With ``islands`` the gbest is
    [D, islands], each island's own best."""
    from distributed_swarm_algorithm_tpu_torch.ops.objectives import (
        get_objective,
    )
    _, hw = get_objective(name)
    rng = np.random.default_rng(seed)
    draws = [rng.uniform(-hw, hw, (d, n)), 0.1 * rng.uniform(-hw, hw, (d, n)),
             rng.uniform(-hw, hw, (d, n)), rng.uniform(size=(d, n)),
             rng.uniform(size=(d, n))]
    pos, vel, bpos, r1, r2 = (torch.from_numpy(a.astype(np.float32)).to(dev)
                              for a in draws)
    bfit = pf.OBJECTIVES_T[name](bpos)
    if islands:
        per = n // islands
        flat = (torch.arange(islands, device=dev) * per
                + bfit.reshape(islands, per).argmin(1))
        gbest = bpos[:, flat].contiguous()
    else:
        gbest = bpos[:, int(bfit.argmin())][:, None].contiguous()
    seed_t = torch.tensor([seed + 99], dtype=torch.int32, device=dev)
    return float(hw), seed_t, gbest, pos, vel, bpos, bfit, r1, r2


def compare_pso(pf, kernel, name, label, got, want, bfit_before, k_steps):
    """Hold a fused PSO launch against its plain version.  Both run the
    same arithmetic in the same order with the same draws, so for nine
    objectives the band is zero: every output equal bit for bit.  Ackley
    calls expf: after one step positions and velocities are equal, the
    fitness within 1e-6 relative + 1e-6, and the ``fit < bfit`` decisions
    differ only where ``|fit - bfit|`` is inside that; after more steps at
    least 99% of the particles are equal."""
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], want[:4]))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    out = dict(phase="kernel_vs_plain", kernel=kernel, objective=name,
               shape=label, k_steps=k_steps, max_abs_err=err,
               bitwise_equal=equal,
               band=("expf: fit within 1e-6 rel + 1e-6" if name == "ackley"
                     else "0 (bit for bit)"))
    record(**out)
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{label}: non-finite output")
    if name != "ackley":
        check(equal, f"{label}: {kernel} differs from its plain version")
    elif k_steps == 1:
        band = 1e-6 * want[3].abs() + 1e-6
        fit = pf.OBJECTIVES_T[name](want[0])
        flipped = (got[3] != bfit_before) != (want[3] != bfit_before)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{label}: positions differ")
        check(bool((~flipped | ((fit - bfit_before).abs() <= band)).all()),
              f"{label}: a select flipped outside the band")
        check(bool((flipped | ((got[3] - want[3]).abs() <= band)).all()),
              f"{label}: fitness outside the band")
    else:
        check(float((got[0] == want[0]).all(0).float().mean()) >= 0.99,
              f"{label}: more than 1% of the particles differ")
    return out


def pso_small_shapes(pf, isl, dev):
    """Phase 3's PSO part: each fused kernel against its plain version."""
    names = list(pf.OBJECTIVES_T)
    shapes = [(300, 8, 1, "host", True), (1000, 30, 8, "device", False),
              (77, 1, 8, "device", True), (130, 100, 1, "device", True),
              (1000, 30, 1, "host", False), (515, 8, 8, "device", True)]
    cases = [(name, *shapes[1]) for name in names]
    cases += [(names[i % len(names)], *shape)
              for i, shape in enumerate(shapes)]
    cases += [("ackley", *shapes[0]), ("michalewicz", *shapes[3])]
    for name, n, d, k, rng, track in cases:
        hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = pso_inputs(
            pf, name, n, d, n + d, dev)
        rr = (r1, r2) if rng == "host" else (None, None)
        kw = dict(objective_name=name, half_width=hw, rng=rng, k_steps=k,
                  track_best=track, step0=5)
        before = pf.LAUNCHES
        got = pf.fused_pso_step_t(seed, gbest, pos, vel, bpos, bfit, *rr,
                                  **kw)
        check(pf.LAUNCHES == before + 1, "launch not counted")
        want = pf.fused_pso_step_plain(seed, gbest, pos, vel, bpos, bfit,
                                       *rr, **kw)
        compare_pso(pf, "pso_fused", name,
                    f"n={n} D={d} k={k} rng={rng} track_best={track}",
                    got, want, bfit, k)
    for name, k, rng in (("rastrigin", 8, "device"), ("griewank", 1, "host"),
                         ("levy", 8, "device")):
        n_i, n_l, d = 3, 157, 12
        hw, seed, gbest, pos, vel, bpos, bfit, r1, r2 = pso_inputs(
            pf, name, n_i * n_l, d, 7, dev, islands=n_i)
        rr = (r1, r2) if rng == "host" else (None, None)
        kw = dict(objective_name=name, half_width=hw, lanes_per_island=n_l,
                  rng=rng, k_steps=k, step0=3)
        before = isl.LAUNCHES
        got = isl._islands_step_t(seed, gbest, pos, vel, bpos, bfit, *rr,
                                  **kw)
        check(isl.LAUNCHES == before + 1, "launch not counted")
        want = isl.islands_step_plain(seed, gbest, pos, vel, bpos, bfit, *rr,
                                      **kw)
        compare_pso(pf, "islands_fused", name,
                    f"I={n_i} n_l={n_l} D={d} k={k} rng={rng}", got, want,
                    bfit, k)


def pso_cpu_vs_gpu(dsa, pf, dev):
    """Three fused blocks (one step each, the uniforms handed in) from one
    state on the CPU, where the wrapper runs the plain version, and on the
    card, where it launches the kernel.  Rastrigin needs no math library,
    so the band is zero: equal bit for bit."""
    from distributed_swarm_algorithm_tpu_torch.ops import pso as pso_ops
    n, d, blocks = 4096, 30, 3
    cpu = dsa.PSO("rastrigin", n=n, dim=d, seed=3, device="cpu",
                  use_pallas=True)
    gpu = dsa.PSO("rastrigin", n=n, dim=d, seed=3, device=dev)
    gpu.state = pso_ops.pso_state_from_numpy(
        pso_ops.pso_state_to_numpy(cpu.state), device=dev)
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(2, blocks, d, n)).astype(np.float32))
    a = pf.fused_pso_run(cpu.state, "rastrigin", blocks, rng="host",
                         uniforms=(u[0], u[1]))
    before = pf.LAUNCHES
    b = pf.fused_pso_run(gpu.state, "rastrigin", blocks, rng="host",
                         uniforms=(u[0].to(dev), u[1].to(dev)))
    check(pf.LAUNCHES == before + blocks, "launches not counted")
    fields = ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
              "gbest_fit")
    devs = {f: float((getattr(a, f) - getattr(b, f).cpu()).abs().max())
            for f in fields}
    record(phase="cpu_vs_gpu", path="fused_pso_run", particles=n, dim=d,
           blocks=blocks, band="0 (bit for bit)", max_abs_dev=devs,
           gbest_cpu=float(a.gbest_fit), gbest_gpu=float(b.gbest_fit))
    check(all(v == 0.0 for v in devs.values()),
          f"fused PSO differs CPU vs GPU: {devs}")
    check(int(a.iteration) == int(b.iteration) == blocks, "iteration")


def pso_bound_ms(n, d, k_steps, gbest_cols):
    """Least time for one fused PSO launch on this card: pos, vel, bpos
    and bfit read once and written once, gbest and the seed read (bytes),
    against ``PSO_OPS_PER_ELEMENT_STEP`` operations per element and step
    plus two per particle and step (the objective's offset and the pbest
    comparison), over the f32 peak."""
    nbytes = 2 * 4 * (3 * d + 1) * n + 4 * d * gbest_cols + 4
    ops = k_steps * n * (d * PSO_OPS_PER_ELEMENT_STEP + 2)
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def reset_launches(kernels):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.LAUNCHES = 0


def timed(fn):
    """(result, CUDA-event milliseconds) of ``fn()``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def zoo_modules():
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        bat_fused, gwo_fused, salp_fused, woa_fused,
    )
    return {"bat": bat_fused, "gwo": gwo_fused, "salp": salp_fused,
            "woa": woa_fused}


def zoo_case(mods, pf, fam, name, n, d, k, rng, dev, tile_n=None, seed=0):
    """(kernel step, plain step, positional args, keywords) of one launch of
    family ``fam`` on numpy-drawn inputs on the card."""
    from distributed_swarm_algorithm_tpu_torch.ops.objectives import (
        get_objective,
    )
    _, hw = get_objective(name)
    g = np.random.default_rng(seed + n + d + k)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    pos = to(g.uniform(-hw, hw, (d, n)))
    fit = pf.OBJECTIVES_T[name](pos)
    best = pos[:, int(fit.argmin())][:, None].contiguous()
    it0 = int(g.integers(0, 50))
    kw = dict(objective_name=name, half_width=hw, rng=rng, k_steps=k,
              step0=int(g.integers(0, 1000)))
    mod = mods[fam]
    if fam == "bat":
        vel = to(g.uniform(-1, 1, (d, n)))
        loud = to(g.uniform(0.4, 1.0, (1, n)))
        pulse = to(g.uniform(0.0, 0.6, (1, n)))
        draws = [to(g.uniform(size=s)) for s in ((1, n), (1, n), (d, n),
                                                 (1, n))]
        args = [i32(seed + 7, it0), best, loud.mean().reshape(1), pos, vel,
                fit, loud, pulse]
    elif fam == "gwo":
        order = torch.sort(fit[0], stable=True).indices[:3]
        draws = [to(g.uniform(size=(3 * d, n))) for _ in range(2)]
        args = [i32(seed + 7, it0), pos[:, order].T.contiguous(), pos]
        kw.update(t_max=60)
    elif fam == "salp":
        draws = [to(g.uniform(size=(d, 1))) for _ in range(2)]
        args = [i32(seed + 7, it0), best, pos, fit]
        kw.update(t_max=60, tile_n=tile_n or n)
    else:
        draws = [to(g.uniform(size=s)) for s in ((d, n), (d, n), (1, n),
                                                 (1, n))]
        tile = tile_n or n
        args = [i32(seed + 7, int(g.integers(0, n // tile)), it0,
                    int(g.integers(0, tile))), best, pos]
        kw.update(t_max=60, tile_n=tile)
    if rng == "host":
        args += draws
    return (getattr(mod, f"fused_{fam}_step_cuda"),
            getattr(mod, f"fused_{fam}_step_plain"), args, kw)


def compare_family(fam, name, label, got, want, k_steps):
    """Hold a family kernel's launch against its plain version.  Both run
    the same arithmetic in the same order with the same draws (the bat
    pulse and the whale spiral call expf, as torch.exp does on the card),
    so the band is zero: every output equal bit for bit.  With ackley,
    whose expf is the objective's, at least 99% of the lanes are equal."""
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    lanes_equal = float((got[0] == want[0]).all(0).float().mean())
    out = dict(phase="kernel_vs_plain", kernel=f"{fam}_fused",
               objective=name, shape=label, k_steps=k_steps,
               max_abs_err=err, bitwise_equal=equal,
               share_of_lanes_equal=lanes_equal,
               band=("expf: 99% of the lanes equal" if name == "ackley"
                     else "0 (bit for bit)"))
    record(**out)
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{fam} {label}: non-finite output")
    if name == "ackley":
        check(lanes_equal >= 0.99, f"{fam} {label}: over 1% of lanes differ")
    else:
        check(equal, f"{fam} {label}: the kernel differs from its plain "
                     "version")
    return out


def zoo_small_shapes(mods, pf, dev):
    """Phase 3's zoo part: each family kernel against its plain version at
    ragged shapes, 1 and k steps, both rng modes, several tiles."""
    cases = [
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
    for fam, name, n, d, k, rng, tile_n in cases:
        kernel, plain, args, kw = zoo_case(mods, pf, fam, name, n, d, k, rng,
                                           dev, tile_n)
        before = mods[fam].LAUNCHES
        got = kernel(*args, **kw)
        check(mods[fam].LAUNCHES == before + 1, "launch not counted")
        compare_family(fam, name, f"n={n} D={d} k={k} rng={rng} "
                       f"tile_n={tile_n}", got, plain(*args, **kw), k)


def zoo_cpu_vs_gpu(dsa, mods, dev):
    """Three launches of each family from one state, one step each with
    the draws handed in, on the CPU (plain version) and on the card
    (kernel), at 4,096 x 30 in tiles of 1,024 for salp and whale (the
    chain link and the tile shift at work).  Rastrigin needs no math
    library, so gwo and salp are equal bit for bit.  The bat run averages
    the loudness over the colony (a sum the two devices add in other
    orders) and takes its pulse from exp, the whale its spiral: each
    device's library rounds its own way, so their floats carry
    ``ZOO_CPU_BAND`` while the bat's loudness (every acceptance) and the
    iteration stay exact."""
    from distributed_swarm_algorithm_tpu_torch.ops import (
        bat, gwo, objectives, salp, woa,
    )
    n, d, calls = 4096, 30, 3
    fn, hw = objectives.get_objective("rastrigin")
    g = torch.Generator().manual_seed(5)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    cases = {
        "bat": (bat, dict(uniforms=[(u(1, n), u(1, n), u(d, n), u(1, n))
                                    for _ in range(calls)])),
        "gwo": (gwo, dict(uniforms=[(u(3 * d, n), u(3 * d, n))
                                    for _ in range(calls)], tile_n=n)),
        "salp": (salp, dict(uniforms=[(u(d, 1), u(d, 1))
                                      for _ in range(calls)], tile_n=1024)),
        "woa": (woa, dict(uniforms=[(u(d, n), u(d, n), u(1, n), u(1, n))
                                    for _ in range(calls)], tile_n=1024,
                          shifts=torch.tensor([[1, 5], [3, 1000], [2, 77]],
                                              dtype=torch.int32))),
    }
    for fam, (ops, kw) in cases.items():
        run = getattr(mods[fam], f"fused_{fam}_run")
        to_np = getattr(ops, f"{fam}_state_to_numpy")
        cpu = getattr(ops, f"{fam}_init")(fn, n, d, hw, seed=3, device="cpu")
        gpu = getattr(ops, f"{fam}_state_from_numpy")(to_np(cpu), device=dev)
        a = to_np(run(cpu, "rastrigin", calls, rng="host", **kw))
        kw_gpu = {key: ([tuple(t.to(dev) for t in c) for c in v]
                        if key == "uniforms" else
                        v.to(dev) if torch.is_tensor(v) else v)
                  for key, v in kw.items()}
        before = mods[fam].LAUNCHES
        b = to_np(run(gpu, "rastrigin", calls, rng="host", **kw_gpu))
        check(mods[fam].LAUNCHES == before + calls, "launches not counted")
        devs = {f: float(np.abs(a[f].astype(np.float64)
                                - b[f].astype(np.float64)).max())
                for f in a}
        exact = ({"loudness", "iteration"} if fam == "bat" else
                 {"iteration"} if fam == "woa" else set(a))
        close = all(np.allclose(b[f], a[f], **(ZOO_CPU_BAND["fit"]
                                               if "fit" in f else
                                               ZOO_CPU_BAND["pos"]))
                    for f in a)
        record(phase="cpu_vs_gpu", path=f"fused_{fam}_run", particles=n,
               dim=d, launches=calls,
               band=("0 (bit for bit)" if exact == set(a) else
                     f"{ZOO_CPU_BAND} for all but {sorted(exact)}, exact"),
               max_abs_dev=devs)
        check(all(devs[f] == 0.0 for f in exact) and close,
              f"fused {fam} run differs CPU vs GPU: {devs}")


def zoo_bound_ms(fam, n, d, k_steps):
    """Least time for one launch of a family kernel on this card: its
    operations (``ZOO_OPS``) over the f32 peak, against the bytes it must
    move (each state array read once and each output written once) over
    the memory rate."""
    per_elem, per_particle, elem_once, particle_once = ZOO_OPS[fam]
    ops = (k_steps * n * (d * per_elem + per_particle)
           + n * (d * elem_once + particle_once))
    nbytes = {"bat": 8 * (2 * d + 3) * n + 4 * d + 12,
              "gwo": 4 * (2 * d + 1) * n + 12 * d + 8,
              "salp": 4 * (2 * d + 2) * n + 4 * d + 8,
              "woa": 4 * (2 * d + 1) * n + 4 * d + 16}[fam]
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def zoo_incumbent(fam, state):
    """The family's incumbent best as a tensor: gwo's three leader fits."""
    return (state.leader_fit if fam == "gwo" else state.best_fit).clone()


def zoo_launch_args(fam, state, seed, dev):
    """One full-width launch's (args, keywords) at a family state."""
    pos_t = state.pos.T.contiguous()
    it = state.iteration.reshape(1).to(torch.int32)
    fit_t = state.fit[None, :].contiguous()
    if fam == "bat":
        return ([torch.cat([seed, it]), state.best_pos[:, None].contiguous(),
                 state.loudness.mean().reshape(1), pos_t,
                 state.vel.T.contiguous(), fit_t,
                 state.loudness[None, :].contiguous(),
                 state.pulse[None, :].contiguous()], {})
    if fam == "gwo":
        return ([torch.cat([seed, it]), state.leaders.contiguous(), pos_t],
                dict(t_max=ZOO["gwo"][2]))
    if fam == "salp":
        return ([torch.cat([seed, it]), state.best_pos[:, None].contiguous(),
                 pos_t, fit_t], dict(t_max=ZOO["salp"][2], tile_n=4096))
    shifts = torch.tensor([37], dtype=torch.int32, device=dev)
    return ([torch.cat([seed, shifts, it, shifts * 33]),
             state.best_pos[:, None].contiguous(), pos_t],
            dict(t_max=ZOO["woa"][2], tile_n=4096))


def zoo_full_width(dsa, fam, mod, kernels, smi, t_start, dev):
    """Phase 11 for one family: the model's run at its bench's width after
    a warm-up launch, counted and checked; then one launch at the final
    state against its plain version, timed beside it and its bound."""
    steps, k, t_max = ZOO[fam]
    model = {"bat": dsa.Bat, "gwo": dsa.GWO, "salp": dsa.Salp,
             "woa": dsa.WOA}[fam]
    kw = dict(seed=0)
    if fam != "salp":
        kw["steps_per_kernel"] = k
    if t_max is not None:
        kw["t_max"] = t_max
    opt = model("rastrigin", n=ZOO_N, dim=ZOO_DIM, **kw)
    check(opt.use_pallas, f"{fam}: the model did not take the fused kernel")
    hw32 = float(np.float32(opt.half_width))
    bests = [zoo_incumbent(fam, opt.state)]
    opt.run(k)                                       # warm-up: one launch
    bests.append(zoo_incumbent(fam, opt.state))
    reset_launches(kernels)
    _, run_ms = timed(lambda: opt.run(steps))
    launches = {name: m.LAUNCHES for name, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = opt.state
    bests.append(zoo_incumbent(fam, state))
    rec = dict(
        phase="full_width", model=type(opt).__name__, objective="rastrigin",
        particles=ZOO_N, dim=ZOO_DIM, steps=steps, steps_per_kernel=k,
        t_max=t_max, launches=launches, run_ms=run_ms,
        ms_per_launch_in_run=run_ms / (steps // k),
        particle_steps_per_sec=ZOO_N * steps / (run_ms / 1e3),
        best_initial_warm_final=[b.tolist() for b in bests],
        max_abs_pos=float(state.pos.abs().max()),
        iteration=int(state.iteration), peak_mem_gib=peak, smi=smi)
    record(**rec)
    hashgrid_launch_check(launches, f"{fam}_fused", steps // k)
    check(bool((bests[0] >= bests[1]).all() and (bests[1] >= bests[2]).all()
               and torch.isfinite(bests[2]).all()),
          f"{fam}: the incumbent rose or is not finite: {rec}")
    check(rec["max_abs_pos"] <= hw32, f"{fam}: a position left the domain")
    check(tuple(state.pos.shape) == (ZOO_N, ZOO_DIM)
          and rec["iteration"] == k + steps, f"{fam}: wrong state")

    seed = torch.tensor([2025], dtype=torch.int32, device=dev)
    args, extra = zoo_launch_args(fam, state, seed, dev)
    step_kw = dict(objective_name="rastrigin", half_width=opt.half_width,
                   k_steps=k, step0=steps, **extra)
    kernel = getattr(mod, f"fused_{fam}_step_cuda")
    got = kernel(*args, **step_kw)
    want, plain_ms = timed(
        lambda: getattr(mod, f"fused_{fam}_step_plain")(*args, **step_kw))
    cmp = compare_family(fam, "rastrigin", "main path, final state", got,
                         want, k)
    del got, want
    ms = cuda_ms(lambda: kernel(*args, **step_kw), 10)
    bound, bound_by, ops, nbytes = zoo_bound_ms(fam, ZOO_N, ZOO_DIM, k)
    record(phase=f"{fam}_fused_timing", shape=[ZOO_DIM, ZOO_N], k_steps=k,
           kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
           bound_by=bound_by, operations=ops, bytes=nbytes,
           kernel_share_of_run=ms * launches[f"{fam}_fused"] / run_ms,
           smi=smi, seconds_so_far=time.perf_counter() - t_start)
    return dict(name=f"{fam}_fused", route="cuda",
                source=f"distributed_swarm_algorithm_tpu_torch/csrc/"
                       f"{fam}_fused.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                         + ZOO_TPU_KERNELS[fam],
                launches=launches[f"{fam}_fused"],
                max_abs_err=cmp["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=None)


def rot_modules():
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        de_fused, ga_fused, mfo_fused, shade_fused,
    )
    return {"de": de_fused, "shade": shade_fused, "ga": ga_fused,
            "mfo": mfo_fused}


def rot_case(mods, pf, fam, name, n, d, k, rng, dev, tile_n, seed=0):
    """(kernel step, plain step, positional args, keywords) of one launch of
    a rotational-donor family on numpy-drawn inputs on the card."""
    from distributed_swarm_algorithm_tpu_torch.ops.objectives import (
        get_objective,
    )
    _, hw = get_objective(name)
    g = np.random.default_rng(seed + n + d + k)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    pos = to(g.uniform(-hw, hw, (d, n)))
    fit = pf.OBJECTIVES_T[name](pos)
    n_tiles = n // tile_n
    lanes = lambda m: [int(v) for v in g.integers(0, 3 * tile_n, m)]  # noqa
    tiles = lambda m: [int(v) for v in g.integers(1, n_tiles, m)]  # noqa
    kw = dict(objective_name=name, half_width=hw, rng=rng, tile_n=tile_n)
    if fam == "de":
        args = [i32(seed + 7, 1, 2, 3, *lanes(3)), pos, fit]
        draws = [to(g.uniform(size=(d, n)))]
        kw.update(k_steps=k, step0=int(g.integers(0, 1000)))
    elif fam == "shade":
        args = [i32(seed + 7, *tiles(3), *lanes(3), int(g.integers(0, 128)),
                    int(g.integers(0, 65537))),
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
        ffit = pf.OBJECTIVES_T[name](flames)
        ffit[0, ::9] = float("inf")
        n_flames = int(g.integers(1, n + 1))
        args = [i32(seed + 7, n_flames, int(g.integers(-131072, -65535))),
                flames[:, n_flames - 1:n_flames].contiguous(), pos, flames,
                ffit]
        draws = [to(g.uniform(size=(d, n)))]
        kw.update(k_steps=k, step0=int(g.integers(0, 1000)))
    if rng == "host":
        args += draws
    return (getattr(mods[fam], f"fused_{fam}_step_cuda"),
            getattr(mods[fam], f"fused_{fam}_step_plain"), args, kw)


def rot_small_shapes(mods, pf, dev):
    """Phase 3's part for DE, SHADE, GA and MFO: each kernel against its
    plain version at ragged shapes, with 4 or more tiles, 1 and k steps,
    both rng modes; GA at every k from 1 to 8 (the tile kept in step)."""
    cases = [
        ("de", "rastrigin", 512, 8, 1, "host", 128),
        ("de", "sphere", 480, 30, 32, "device", 96),
        ("de", "michalewicz", 640, 1, 8, "device", 160),
        ("de", "ackley", 4096, 30, 32, "device", 1024),
        ("shade", "rastrigin", 512, 8, 1, "host", 128),
        ("shade", "griewank", 1280, 30, 1, "device", 256),
        ("shade", "levy", 512, 1, 1, "device", 128),
        ("shade", "schwefel", 768, 100, 1, "device", 128),
        ("ga", "rastrigin", 512, 8, 1, "host", 128),
        ("ga", "zakharov", 500, 3, 8, "device", 100),
        ("ga", "ackley", 16384, 30, 8, "device", 4096),
        *(("ga", "rastrigin", 16384, 30, k, "device", 4096)
          for k in range(1, 9)),
        ("mfo", "rastrigin", 512, 8, 1, "host", 128),
        ("mfo", "styblinski_tang", 1000, 30, 8, "device", 200),
        ("mfo", "rosenbrock", 77, 1, 32, "device", 77),
        ("mfo", "ackley", 640, 30, 8, "device", 128),
    ]
    for fam, name, n, d, k, rng, tile_n in cases:
        kernel, plain, args, kw = rot_case(mods, pf, fam, name, n, d, k, rng,
                                           dev, tile_n)
        before = mods[fam].LAUNCHES
        got = kernel(*args, **kw)
        check(mods[fam].LAUNCHES == before + 1, "launch not counted")
        compare_family(fam, name, f"n={n} D={d} k={k} rng={rng} "
                       f"tile_n={tile_n}", got, plain(*args, **kw), k)


def rot_cpu_vs_gpu(mods, dev):
    """Three launches of each rotational family from one state, one step
    each with the draws handed in, on the CPU (plain version) and on the
    card (kernel), at 4,096 x 30 in 4 tiles of 1,024.  DE, GA and MFO are
    equal bit for bit; SHADE's success memory sums over N in another order
    on each device, so its floats carry ``ZOO_CPU_BAND``, its counters
    exact."""
    from distributed_swarm_algorithm_tpu_torch.ops import (
        de, ga, mfo, objectives, shade,
    )
    n, d, calls, tile = 4096, 30, 3, 1024
    fn, hw = objectives.get_objective("rastrigin")
    g = torch.Generator().manual_seed(6)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    i32 = lambda rows: torch.tensor(rows, dtype=torch.int32)  # noqa: E731
    cases = {
        "de": (de, dict(uniforms=[u(d, n) for _ in range(calls)],
                        shifts=i32([[1, 2, 3, 5, 1000, 7], [3, 2, 1, 0, 1, 2],
                                    [2, 1, 3, 9, 9, 1023]]))),
        "shade": (shade, dict(draws=[
            mods["shade"].generation_draws(g, n, d, n // tile, tile, True,
                                           "cpu") for _ in range(calls)])),
        "ga": (ga, dict(uniforms=[(u(d, n), u(1, n), u(d, n), u(d, n))
                                  for _ in range(calls)],
                        shifts=i32([[1, 2, 5, 1000, 7], [3, 3, 0, 1, 2],
                                    [2, 1, 9, 9, 1023]]))),
        "mfo": (mfo, dict(uniforms=[u(d, n) for _ in range(calls)], t_max=5,
                          sort_blocks=2)),
    }

    def to_dev(v):
        if isinstance(v, dict):
            return {key: to_dev(x) for key, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(to_dev(x) for x in v)
        return v.to(dev) if torch.is_tensor(v) else v

    for fam, (ops, kw) in cases.items():
        run = getattr(mods[fam], f"fused_{fam}_run")
        to_np = getattr(ops, f"{fam}_state_to_numpy")
        cpu = getattr(ops, f"{fam}_init")(fn, n, d, hw, seed=3, device="cpu")
        gpu = getattr(ops, f"{fam}_state_from_numpy")(to_np(cpu), device=dev)
        a = to_np(run(cpu, "rastrigin", calls, rng="host", tile_n=tile, **kw))
        before = mods[fam].LAUNCHES
        b = to_np(run(gpu, "rastrigin", calls, rng="host", tile_n=tile,
                      **to_dev(kw)))
        check(mods[fam].LAUNCHES == before + calls, "launches not counted")
        devs = {f: float(np.abs(a[f].astype(np.float64)
                                - b[f].astype(np.float64)).max())
                for f in a}
        exact = ({"mem_k", "archive_n", "iteration"} if fam == "shade"
                 else set(a))
        close = all(np.allclose(b[f], a[f], **(ZOO_CPU_BAND["fit"]
                                               if "fit" in f else
                                               ZOO_CPU_BAND["pos"]))
                    for f in a)
        record(phase="cpu_vs_gpu", path=f"fused_{fam}_run", particles=n,
               dim=d, launches=calls,
               band=("0 (bit for bit)" if exact == set(a) else
                     f"{ZOO_CPU_BAND} for all but {sorted(exact)}, exact"),
               max_abs_dev=devs)
        check(all(devs[f] == 0.0 for f in exact) and close,
              f"fused {fam} run differs CPU vs GPU: {devs}")


def rot_bound_ms(fam, n, d, k_steps):
    """Least time for one launch of a rotational family's kernel on this
    card: its operations (``ROT_OPS``) over the f32 peak, against the bytes
    it must move (each input read once, each output written once) over the
    memory rate."""
    per_elem, per_particle = ROT_OPS[fam]
    ops = k_steps * n * (d * per_elem + per_particle)
    nbytes = {"de": 4 * (2 * d + 2) * n,
              "shade": 4 * (3 * d + 4) * n + 4 * 128 * d,
              "ga": 4 * (2 * d + 2) * n,
              "mfo": 4 * (4 * d + 3) * n + 4 * d}[fam]
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def rot_incumbent(fam, state):
    """The family's incumbent best as a tensor: MFO's best flame."""
    return (state.flame_fit[0] if fam == "mfo" else state.best_fit).clone()


def rot_launch_args(mods, fam, state, seed, dev):
    """One full-width launch's (args, keywords) at a family state, with the
    tile of the run (4,096 lanes) and fixed shifts."""
    pos_t = state.pos.T.contiguous()
    fit_t = state.fit[None, :].contiguous()
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    steps, k, t_max = ROT[fam]
    kw = dict(tile_n=4096)
    if fam == "de":
        return ([torch.cat([seed, i32(1, 2, 3, 37, 1000, 4000)]), pos_t,
                 fit_t], dict(kw, k_steps=k, step0=steps))
    if fam == "shade":
        g = torch.Generator(device=dev).manual_seed(11)
        rows = torch.rand((2, 1, ZOO_N), generator=g, device=dev)
        elite = mods["shade"].tile_champion_elite(pos_t, fit_t[0],
                                                  ZOO_N // 4096, 4096)
        return ([torch.cat([seed, i32(1, 2, 3, 37, 1000, 4000, 77, 32768)]),
                 pos_t, fit_t, (0.01 + 0.99 * rows[0]).contiguous(),
                 rows[1].contiguous(), state.archive.T.contiguous(), elite],
                dict(kw, step=steps))
    if fam == "ga":
        return ([torch.cat([seed, i32(1, 2, 37, 1000, 4000)]), pos_t, fit_t],
                dict(kw, k_steps=k, step0=steps, p_mut=1.0 / ZOO_DIM))
    from distributed_swarm_algorithm_tpu_torch.ops.mfo import schedule
    frac, n_flames = schedule(state.iteration, ZOO_N, t_max, torch.float32)
    r_lo = torch.round((-1.0 - frac) * 65536.0).to(torch.int32)
    flames_t = state.flame_pos.T.contiguous()
    last = flames_t.index_select(1, (n_flames - 1).long().reshape(1))
    return ([torch.cat([seed, n_flames.reshape(1), r_lo.reshape(1)]), last,
             pos_t, flames_t, state.flame_fit[None, :].contiguous()],
            dict(kw, k_steps=k, step0=steps))


def rot_full_width(dsa, fam, mods, kernels, smi, t_start, dev):
    """Phase 12 for one family: the model's run at its bench's width after
    a warm-up launch, counted and checked (SHADE's device busy share from a
    trace of more generations); then one launch at the final state against
    its plain version, timed beside it and its bound."""
    steps, k, t_max = ROT[fam]
    mod = mods[fam]
    model = {"de": dsa.DE, "shade": dsa.SHADE, "ga": dsa.GA,
             "mfo": dsa.MFO}[fam]
    kw = dict(seed=0)
    if fam != "shade":
        kw["steps_per_kernel"] = k
    if t_max is not None:
        kw["t_max"] = t_max
    opt = model("rastrigin", n=ZOO_N, dim=ZOO_DIM, **kw)
    check(opt.use_pallas, f"{fam}: the model did not take the fused kernel")
    hw32 = float(np.float32(opt.half_width))
    bests = [rot_incumbent(fam, opt.state)]
    opt.run(k)                                       # warm-up: one launch
    bests.append(rot_incumbent(fam, opt.state))
    reset_launches(kernels)
    _, run_ms = timed(lambda: opt.run(steps))
    launches = {name: m.LAUNCHES for name, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = opt.state
    bests.append(rot_incumbent(fam, state))
    n_launches = steps // k
    max_pos = float(state.pos.abs().max())
    if fam == "mfo":
        max_pos = max(max_pos, float(state.flame_pos.abs().max()))
    rec = dict(
        phase="full_width", model=type(opt).__name__, objective="rastrigin",
        particles=ZOO_N, dim=ZOO_DIM, steps=steps, steps_per_kernel=k,
        t_max=t_max, launches=launches, run_ms=run_ms,
        ms_per_launch_in_run=run_ms / n_launches,
        particle_steps_per_sec=ZOO_N * steps / (run_ms / 1e3),
        best_initial_warm_final=[float(b) for b in bests],
        max_abs_pos=max_pos, iteration=int(state.iteration),
        peak_mem_gib=peak, smi=smi)
    record(**rec)
    hashgrid_launch_check(launches, f"{fam}_fused", n_launches)
    check(bool(bests[0] >= bests[1] and bests[1] >= bests[2]
               and torch.isfinite(bests[2])),
          f"{fam}: the incumbent rose or is not finite: {rec}")
    check(max_pos <= hw32, f"{fam}: a position left the domain")
    check(tuple(state.pos.shape) == (ZOO_N, ZOO_DIM)
          and rec["iteration"] == k + steps, f"{fam}: wrong state")
    if fam == "mfo":
        check(bool((state.flame_fit[1:] >= state.flame_fit[:-1]).all()),
              "mfo: the flames are not in rank order")
    if fam == "shade":
        busy, ops, top = device_time(lambda: opt.run(SHADE_PROFILED),
                                     SHADE_PROFILED)
        ms_per_gen = run_ms / steps
        record(phase="shade_generation_breakdown", particles=ZOO_N,
               profiled_generations=SHADE_PROFILED,
               ms_per_generation=ms_per_gen,
               device_busy_ms_per_generation=busy,
               device_busy_share=(None if busy is None
                                  else busy / ms_per_gen),
               device_idle_share=(None if busy is None
                                  else 1.0 - busy / ms_per_gen),
               device_ops_per_generation=ops, top_device_ops=top, smi=smi)
        state = opt.state

    seed = torch.tensor([2026], dtype=torch.int32, device=dev)
    args, extra = rot_launch_args(mods, fam, state, seed, dev)
    step_kw = dict(objective_name="rastrigin", half_width=opt.half_width,
                   **extra)
    kernel = getattr(mod, f"fused_{fam}_step_cuda")
    got = kernel(*args, **step_kw)
    want, plain_ms = timed(
        lambda: getattr(mod, f"fused_{fam}_step_plain")(*args, **step_kw))
    cmp = compare_family(fam, "rastrigin", "main path, final state", got,
                         want, k)
    del got, want
    ms = cuda_ms(lambda: kernel(*args, **step_kw), 10)
    bound, bound_by, ops, nbytes = rot_bound_ms(fam, ZOO_N, ZOO_DIM, k)
    record(phase=f"{fam}_fused_timing", shape=[ZOO_DIM, ZOO_N], k_steps=k,
           kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
           bound_by=bound_by, operations=ops, bytes=nbytes,
           kernel_share_of_run=ms * launches[f"{fam}_fused"] / run_ms,
           smi=smi, seconds_so_far=time.perf_counter() - t_start)
    return dict(name=f"{fam}_fused", route="cuda",
                source=f"distributed_swarm_algorithm_tpu_torch/csrc/"
                       f"{fam}_fused.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                         + ROT_TPU_KERNELS[fam],
                launches=launches[f"{fam}_fused"],
                max_abs_err=cmp["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=None)


def levy_modules():
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        abc_fused, cuckoo_fused, hho_fused, tempering_fused,
    )
    return {"cuckoo": cuckoo_fused, "hho": hho_fused, "abc": abc_fused,
            "pt": tempering_fused}


def levy_case(mods, pf, fam, name, n, d, k, rng, dev, tile_n, seed=0,
              limit=20, swap_every=5, n_real=None):
    """(kernel step, plain step, positional args, keywords) of one launch of
    the cuckoo, HHO, ABC or PT kernel on numpy-drawn inputs on the card."""
    from distributed_swarm_algorithm_tpu_torch.ops.objectives import (
        get_objective,
    )
    _, hw = get_objective(name)
    g = np.random.default_rng(seed + n + d + k)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    u = lambda *sh: to(g.uniform(size=sh))  # noqa: E731
    normal = lambda *sh: to(g.standard_normal(sh))  # noqa: E731
    pos = to(g.uniform(-hw, hw, (d, n)))
    fit = pf.OBJECTIVES_T[name](pos)
    best = pos[:, int(fit.argmin())][:, None].contiguous()
    n_tiles = n // tile_n
    lanes = lambda m: [int(v) for v in g.integers(0, 3 * tile_n, m)]  # noqa
    tiles = lambda m: [int(v) for v in g.integers(1, n_tiles, m)]  # noqa
    kw = dict(objective_name=name, half_width=hw, rng=rng, tile_n=tile_n,
              k_steps=k, step0=int(g.integers(0, 1000)))
    if fam == "cuckoo":
        args = [i32(seed + 7, *tiles(2), *lanes(3)), best, pos, fit]
        draws = [normal(d, n), normal(d, n), u(1, n), u(d, n)]
    elif fam == "hho":
        args = [i32(seed + 7, *tiles(1), int(g.integers(0, 60)), *lanes(1)),
                best, pos.mean(dim=1, keepdim=True), pos, fit]
        draws = [tuple([u(1, n) for _ in range(4)]
                       + [u(d, n) for _ in range(5)]
                       + [normal(d, n), normal(d, n)])]
        kw.update(t_max=60)
    elif fam == "abc":
        trials = torch.from_numpy(
            g.integers(0, limit + 2, (1, n)).astype(np.int32)).to(dev)
        args = [i32(seed + 7, *tiles(1), *lanes(2)), pos, fit, trials]
        draws = [tuple([u(1, n) for _ in range(5)] + [u(d, n)])]
        kw.update(limit=limit)
    else:
        temps = to(0.01 * 1000.0 ** (np.arange(n) / (n - 1)))[None, :]
        args = [i32(seed + 7, int(g.integers(0, 40)), n_real or n), pos,
                fit, (0.1 * hw) * torch.sqrt(temps), 1.0 / temps]
        draws = [normal(d, n), u(1, n), u(1, n)]
        kw.update(swap_every=swap_every)
    if rng == "host":
        args += draws
    return (getattr(mods[fam], f"fused_{fam}_step_cuda"),
            getattr(mods[fam], f"fused_{fam}_step_plain"), args, kw)


def levy_small_shapes(mods, pf, dev):
    """Phase 3's part for cuckoo, HHO, ABC and PT: each kernel against its
    plain version at ragged shapes with 4 tiles or more and an explicit
    tile, both rng modes, the objectives, and every k from 1 to the
    family's cap; ABC at a small limit (its scouts fire), PT with padded
    lanes (n_real < n) and with the widest halo (swap_every = 1)."""
    cases = [
        ("cuckoo", "rastrigin", 512, 8, 1, "host", 128, {}),
        ("cuckoo", "sphere", 480, 30, 8, "device", 96, {}),
        ("cuckoo", "michalewicz", 640, 1, 8, "device", 160, {}),
        ("cuckoo", "ackley", 4096, 30, 8, "device", 1024, {}),
        ("hho", "rastrigin", 512, 8, 1, "host", 128, {}),
        ("hho", "griewank", 1000, 30, 8, "device", 200, {}),
        ("hho", "levy", 640, 1, 8, "device", 160, {}),
        ("hho", "schwefel", 768, 100, 3, "device", 128, {}),
        ("abc", "rastrigin", 512, 8, 1, "host", 128, dict(limit=2)),
        ("abc", "zakharov", 500, 3, 8, "device", 100, dict(limit=2)),
        ("abc", "ackley", 16384, 30, 8, "device", 4096,
         dict(limit=491520)),
        ("pt", "rastrigin", 512, 8, 1, "host", 128, dict(n_real=500)),
        ("pt", "styblinski_tang", 1000, 30, 16, "device", 200,
         dict(n_real=987)),
        ("pt", "rosenbrock", 640, 3, 16, "device", 320, dict(swap_every=1)),
        ("pt", "ackley", 4096, 30, 16, "device", 4096, {}),
        *(("cuckoo", "rastrigin", 4000, 30, k, "device", 1000, {})
          for k in range(1, 9)),
        *(("hho", "rastrigin", 4000, 30, k, "device", 1000, {})
          for k in range(1, 9)),
        *(("abc", "rastrigin", 4000, 30, k, "device", 1000, dict(limit=2))
          for k in range(1, 9)),
        *(("pt", "rastrigin", 4000, 30, k, "device", 1000,
           dict(n_real=3990)) for k in range(1, 17)),
    ]
    scouts = swaps = 0
    for fam, name, n, d, k, rng, tile_n, extra in cases:
        kernel, plain, args, kw = levy_case(mods, pf, fam, name, n, d, k,
                                            rng, dev, tile_n, **extra)
        before = mods[fam].LAUNCHES
        got = kernel(*args, **kw)
        check(mods[fam].LAUNCHES == before + 1, "launch not counted")
        counts = {}
        want = plain(*args, **kw, counts=counts)
        scouts += int(sum(counts.get("exhausted", [0])))
        swaps += int(sum(counts.get("swapped", [0])))
        compare_family(fam, name, f"n={n} D={d} k={k} rng={rng} "
                       f"tile_n={tile_n} {extra}", got, want, k)
    record(phase="levy_small_shapes", cases=len(cases),
           abc_scouts_fired=scouts, pt_swaps=swaps)
    check(scouts > 0 and swaps > 0, "no scout fired or no chain swapped")


def levy_cpu_vs_gpu(mods, dev):
    """Three launches of each family from one state, one step each with
    the draws handed in, on the CPU (plain version) and on the card
    (kernel), at 4,096 x 30 in 4 tiles of 1,024.  Cuckoo and ABC (at limit
    1, so scouts fire) are equal bit for bit.  HHO's mean over the hawks is
    a sum each device adds in its own order, and PT's proposal scales take
    ``torch.sqrt``, which the card rounds its own way: their floats carry
    ``ZOO_CPU_BAND``, the ladder and the iteration exact."""
    from distributed_swarm_algorithm_tpu_torch.ops import (
        abc, cuckoo, hho, objectives, tempering,
    )
    n, d, calls, tile = 4096, 30, 3, 1024
    fn, hw = objectives.get_objective("rastrigin")
    g = torch.Generator().manual_seed(7)
    u = lambda *sh: torch.rand(sh, generator=g)  # noqa: E731
    nz = lambda *sh: torch.randn(sh, generator=g)  # noqa: E731
    i32 = lambda rows: torch.tensor(rows, dtype=torch.int32)  # noqa: E731
    cases = {
        "cuckoo": (cuckoo, dict(
            uniforms=[(nz(d, n), nz(d, n), u(1, n), u(d, n))
                      for _ in range(calls)],
            shifts=i32([[1, 1, 5, 1000, 7], [3, 2, 0, 1, 2],
                        [2, 3, 9, 9, 1023]]))),
        "hho": (hho, dict(
            uniforms=[tuple([u(1, n) for _ in range(4)]
                            + [u(d, n) for _ in range(5)]
                            + [nz(d, n), nz(d, n)]) for _ in range(calls)],
            shifts=i32([[1, 5], [3, 1000], [2, 1023]]), t_max=4)),
        "abc": (abc, dict(
            uniforms=[tuple([u(1, n) for _ in range(5)] + [u(d, n)])
                      for _ in range(calls)],
            shifts=i32([[1, 5, 1000], [3, 0, 1], [2, 9, 1023]]), limit=1)),
        "pt": (tempering, dict(
            uniforms=[(nz(d, n), u(1, n), u(1, n)) for _ in range(calls)],
            swap_every=1)),
    }

    def to_dev(v):
        if isinstance(v, (list, tuple)):
            return type(v)(to_dev(x) for x in v)
        return v.to(dev) if torch.is_tensor(v) else v

    for fam, (ops, kw) in cases.items():
        run = getattr(mods[fam], f"fused_{fam}_run")
        to_np = getattr(ops, f"{fam}_state_to_numpy")
        cpu = getattr(ops, f"{fam}_init")(fn, n, d, hw, seed=3, device="cpu")
        gpu = getattr(ops, f"{fam}_state_from_numpy")(to_np(cpu), device=dev)
        a = to_np(run(cpu, "rastrigin", calls, rng="host", tile_n=tile, **kw))
        before = mods[fam].LAUNCHES
        b = to_np(run(gpu, "rastrigin", calls, rng="host", tile_n=tile,
                      **{key: to_dev(v) for key, v in kw.items()}))
        check(mods[fam].LAUNCHES == before + calls, "launches not counted")
        devs = {f: float(np.abs(a[f].astype(np.float64)
                                - b[f].astype(np.float64)).max())
                for f in a}
        exact = {"hho": {"iteration"},
                 "pt": {"temps", "iteration"}}.get(fam, set(a))
        close = all(np.allclose(b[f], a[f], **(ZOO_CPU_BAND["fit"]
                                               if "fit" in f else
                                               ZOO_CPU_BAND["pos"]))
                    for f in a)
        record(phase="cpu_vs_gpu", path=f"fused_{fam}_run", particles=n,
               dim=d, launches=calls,
               band=("0 (bit for bit)" if exact == set(a) else
                     f"{ZOO_CPU_BAND} for all but {sorted(exact)}, exact"),
               max_abs_dev=devs)
        check(all(devs[f] == 0.0 for f in exact) and close,
              f"fused {fam} run differs CPU vs GPU: {devs}")


def levy_bound_ms(fam, n, d, k_steps, counts, rounds=0):
    """Least time for one launch of the family's kernel on this card: the
    operations of ``FAM_OPS`` (the data-dependent ones from ``counts``, the
    plain version's tally of the same launch: abandoned, exploring and
    diving, probed and exhausted lanes) over the f32 peak, against the
    bytes it must move (each input read once, each output written once)
    over the memory rate."""
    c = FAM_OPS[fam]
    total = lambda key: int(sum(int(v) for v in counts.get(key, [])))  # noqa
    ops = k_steps * n * (d * c["elem"] + c["lane"])
    if fam == "cuckoo":
        ops += total("abandoned") * (d * c["abandoned"] + c["abandoned_lane"])
    elif fam == "hho":
        explore, dive = total("explore"), total("dive")
        ops += (explore * d * c["explore"]
                + (k_steps * n - explore - dive) * d * c["besiege"]
                + dive * (d * c["dive"] + c["dive_lane"]))
    elif fam == "abc":
        ops += (total("probed") * (d * c["probed"] + c["probed_lane"])
                + total("exhausted") * (d * c["exhausted"]
                                        + c["exhausted_lane"]))
    else:
        ops += rounds * n * c["round_lane"]
    nbytes = {"cuckoo": 4 * (2 * d + 2) * n + 4 * d,
              "hho": 4 * (2 * d + 2) * n + 8 * d,
              "abc": 4 * (2 * d + 4) * n,
              "pt": 4 * (2 * d + 4) * n}[fam]
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def levy_launch_args(fam, opt, seed, dev):
    """One full-width launch's (args, keywords) at a model's state, with the
    run's tile (4,096 lanes) and fixed shifts."""
    state = opt.state
    pos_t = state.pos.T.contiguous()
    fit_t = state.fit[None, :].contiguous()
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    steps, k, t_max = LEVY[fam]
    kw = dict(tile_n=4096, k_steps=k, step0=steps)
    it = state.iteration.reshape(1).to(torch.int32)
    if fam == "cuckoo":
        return ([torch.cat([seed, i32(1, 2, 37, 1000, 4000)]),
                 state.best_pos[:, None].contiguous(), pos_t, fit_t], kw)
    if fam == "hho":
        return ([torch.cat([seed, i32(1), it, i32(37)]),
                 state.best_pos[:, None].contiguous(),
                 pos_t.mean(dim=1, keepdim=True), pos_t, fit_t],
                dict(kw, t_max=t_max))
    if fam == "abc":
        return ([torch.cat([seed, i32(1, 37, 1000)]), pos_t, fit_t,
                 state.trials[None, :].to(torch.int32).contiguous()],
                dict(kw, limit=opt.limit))
    temps = state.temps[None, :].contiguous()
    return ([torch.cat([seed, it, i32(ZOO_N)]), pos_t, fit_t,
             (opt.sigma0 * opt.half_width) * torch.sqrt(temps),
             1.0 / temps], dict(kw, swap_every=opt.swap_every))


def levy_full_width(dsa, fam, mods, kernels, smi, t_start, dev):
    """Phase 13 for one family: the model's run at its bench's width after
    a warm-up launch, counted and checked, the device's busy share from a
    trace of one more launch; then one launch at the final state against
    its plain version, timed beside it and its bound."""
    steps, k, t_max = LEVY[fam]
    mod = mods[fam]
    model = {"cuckoo": dsa.Cuckoo, "hho": dsa.HarrisHawks, "abc": dsa.ABC,
             "pt": dsa.ParallelTempering}[fam]
    kw = dict(seed=0, steps_per_kernel=k)
    if t_max is not None:
        kw["t_max"] = t_max
    opt = model("rastrigin", n=ZOO_N, dim=ZOO_DIM, **kw)
    check(opt.use_pallas, f"{fam}: the model did not take the fused kernel")
    hw32 = float(np.float32(opt.half_width))
    bests = [opt.state.best_fit.clone()]
    opt.run(k)                                       # warm-up: one launch
    bests.append(opt.state.best_fit.clone())
    reset_launches(kernels)
    _, run_ms = timed(lambda: opt.run(steps))
    launches = {name: m.LAUNCHES for name, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = opt.state
    bests.append(state.best_fit.clone())
    n_launches = steps // k
    rec = dict(
        phase="full_width", model=type(opt).__name__, objective="rastrigin",
        particles=ZOO_N, dim=ZOO_DIM, steps=steps, steps_per_kernel=k,
        t_max=t_max, launches=launches, run_ms=run_ms,
        ms_per_launch_in_run=run_ms / n_launches,
        particle_steps_per_sec=ZOO_N * steps / (run_ms / 1e3),
        best_initial_warm_final=[float(b) for b in bests],
        max_abs_pos=float(state.pos.abs().max()),
        iteration=int(state.iteration), peak_mem_gib=peak, smi=smi)
    if fam == "abc":
        rec.update(limit=opt.limit, trials_min_max=[
            int(state.trials.min()), int(state.trials.max())])
    record(**rec)
    hashgrid_launch_check(launches, f"{fam}_fused", n_launches)
    check(bool(bests[0] >= bests[1] and bests[1] >= bests[2]
               and torch.isfinite(bests[2])),
          f"{fam}: the incumbent rose or is not finite: {rec}")
    check(rec["max_abs_pos"] <= hw32, f"{fam}: a position left the domain")
    check(tuple(state.pos.shape) == (ZOO_N, ZOO_DIM)
          and rec["iteration"] == k + steps, f"{fam}: wrong state")
    if fam == "abc":
        check(rec["trials_min_max"][0] >= 0, "abc: a trial counter fell")
    busy, ops_per, top = device_time(lambda: opt.run(k), 1)
    ms_launch = run_ms / n_launches
    record(phase=f"{fam}_launch_breakdown", particles=ZOO_N, steps=k,
           ms_per_launch=ms_launch, device_busy_ms_per_launch=busy,
           device_idle_share=None if busy is None else 1.0 - busy / ms_launch,
           device_ops_per_launch=ops_per, top_device_ops=top, smi=smi)

    seed = torch.tensor([2026], dtype=torch.int32, device=dev)
    args, extra = levy_launch_args(fam, opt, seed, dev)
    step_kw = dict(objective_name="rastrigin", half_width=opt.half_width,
                   **extra)
    kernel = getattr(mod, f"fused_{fam}_step_cuda")
    got = kernel(*args, **step_kw)
    counts = {}
    want, plain_ms = timed(lambda: getattr(mod, f"fused_{fam}_step_plain")(
        *args, **step_kw, counts=counts))
    cmp = compare_family(fam, "rastrigin", "main path, final state", got,
                         want, k)
    del got, want
    ms = cuda_ms(lambda: kernel(*args, **step_kw), 10)
    rounds = 0
    if fam == "pt":
        it0 = int(opt.state.iteration)
        rounds = sum((it0 + s + 1) % opt.swap_every == 0 for s in range(k))
    bound, bound_by, ops, nbytes = levy_bound_ms(fam, ZOO_N, ZOO_DIM, k,
                                                 counts, rounds)
    record(phase=f"{fam}_fused_timing", shape=[ZOO_DIM, ZOO_N], k_steps=k,
           kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
           bound_by=bound_by, operations=ops, bytes=nbytes,
           data_dependent_lanes={key: int(sum(int(v) for v in vals))
                                 for key, vals in counts.items()},
           kernel_share_of_run=ms * launches[f"{fam}_fused"] / run_ms,
           smi=smi, seconds_so_far=time.perf_counter() - t_start)
    return dict(name=f"{fam}_fused", route="cuda",
                source=f"distributed_swarm_algorithm_tpu_torch/csrc/"
                       f"{LEVY_SOURCES[fam]}.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                         + LEVY_TPU_KERNELS[fam],
                launches=launches[f"{fam}_fused"],
                max_abs_err=cmp["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=None)


# --------------------------------------------------------------------------
# Firefly (B19) and ACO (B20, B21)
# --------------------------------------------------------------------------


class LaunchCount:
    """A kernel's launch count kept under another name in its module (the
    ACO module counts its two kernels apart), read and reset as
    ``LAUNCHES``."""

    def __init__(self, mod, attr):
        self.mod, self.attr = mod, attr

    @property
    def LAUNCHES(self):  # noqa: N802
        return getattr(self.mod, self.attr)

    @LAUNCHES.setter
    def LAUNCHES(self, value):  # noqa: N802
        setattr(self.mod, self.attr, value)


def ff_inputs(n, d, seed, dev, scale, ties=False):
    from distributed_swarm_algorithm_tpu_torch.ops import objectives
    g = np.random.default_rng(seed)
    pos = torch.from_numpy((g.uniform(-5.12, 5.12, (n, d)) * scale)
                           .astype(np.float32)).to(dev)
    fit = objectives.rastrigin(pos)
    return pos, (torch.round(fit) if ties else fit).contiguous()


def compare_firefly(ff, got, pos, fit, label, pos_j=None, fit_j=None,
                    counts=None):
    """B19 against its plain version within FF_BAND: the plain version's
    move and time, the error's largest share of the band."""
    want, plain_ms = timed(lambda: ff.firefly_attraction_plain(
        pos, fit, pos_j=pos_j, fit_j=fit_j, counts=counts))
    absum = ff.attraction_abs_sum(pos, fit, pos_j=pos_j, fit_j=fit_j)
    nj = pos.shape[0] if pos_j is None else pos_j.shape[0]
    err = (got.double() - want.double()).abs()
    bound = ff.attraction_band(nj) * absum + FF_ABS_BAND
    out = dict(phase="kernel_vs_plain", kernel="firefly_fused", shape=label,
               max_abs_err=float(err.max()),
               max_err_over_band=float((err / bound).max()),
               band=f"attraction_band(N_j) * sum|terms| + {FF_ABS_BAND}")
    record(**out)
    check(bool((err <= bound).all()), f"firefly kernel off its band: {out}")
    return out, plain_ms


def ff_bound_ms(n, nj, d, counts):
    """Least time for one B19 call: FF_OPS over the f32 peak (brighter and
    weighted pairs from the plain version's tally of the same call) against
    its bytes over the memory rate."""
    total = lambda key: int(sum(int(v) for v in counts.get(key, [])))  # noqa
    c = FF_OPS
    ops = (n * nj * c["pair"] + total("brighter") * (2 * d + c["brighter"])
           + total("weighted") * (2 * d + c["weighted"])
           + (n + nj) * 2 * d + n * 2 * d)
    nbytes = 4 * ((n + nj) * (d + 1) + n * d)
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def aco_case(c, a, seed, dev, flat=False):
    from distributed_swarm_algorithm_tpu_torch.ops import aco
    g = np.random.default_rng(seed)
    coords = torch.from_numpy(g.uniform(0, 100, (c, 2)).astype(np.float32))
    dist = aco.coords_to_dist(coords).to(dev)
    tau = torch.from_numpy(g.uniform(0.5, 2.0, (c, c)).astype(np.float32))
    logits = (torch.zeros((c, c), device=dev) if flat
              else aco.aco_logits(tau.to(dev), dist, 1.0, 2.0))
    start = torch.from_numpy(g.integers(0, c, a).astype(np.int32)).to(dev)
    seed_t = torch.tensor([seed + 11], dtype=torch.int32, device=dev)
    return logits, dist, start, seed_t, g


def compare_aco(af, c, a, q0, host, dev, seed, flat=False):
    """B20 and B21 against their plain versions on one case: tours,
    lengths and D equal (torch.equal), every tour a permutation, the
    lengths the ordered sums."""
    logits, dist, start, seed_t, g = aco_case(c, a, seed, dev, flat)
    draws = (None, None)
    if host:
        draws = (torch.from_numpy(g.uniform(size=(c - 1, c, a))
                                  .astype(np.float32)).to(dev),
                 torch.from_numpy(g.uniform(size=(c - 1, a))
                                  .astype(np.float32)).to(dev))
    tours, lengths = af.construct_tours_cuda(logits, dist, start, seed_t, q0,
                                             *draws)
    want = af.construct_tours_plain(logits, dist, start, seed_t, q0, *draws)
    ok = torch.equal(tours, want[0]) and torch.equal(lengths, want[1])
    perm = bool((torch.sort(tours, 1).values
                 == torch.arange(c, device=dev)).all())
    ordered = torch.equal(lengths, af.tour_lengths_in_order(dist, tours))
    amount = torch.full_like(lengths, 1.0) / lengths
    d = af.deposit_matrix_cuda(tours, amount)
    d_ok = torch.equal(d, af.deposit_matrix_plain(tours, amount))
    check(ok and perm and ordered and d_ok,
          f"ACO kernels differ from plain at C={c} A={a} q0={q0} "
          f"host={host}: tours/lengths {ok}, permutations {perm}, ordered "
          f"{ordered}, deposit {d_ok}")
    return tours


def ff_aco_small_shapes(ff, af, dev):
    """Phase 3's part for B19, B20 and B21: each kernel against its plain
    version at small and ragged shapes."""
    worst = 0.0
    for n in (1, 127, 300, 1000):
        for d in (1, 5, 30, 100):
            pos, fit = ff_inputs(n, d, n + d, dev, 0.2 / d ** 0.5)
            got = ff.firefly_attraction_cuda(pos, fit)
            worst = max(worst, compare_firefly(
                ff, got, pos, fit, f"n={n} D={d}")[0]["max_err_over_band"])
            if n == 1:
                check(not bool(got.abs().any()), "a lone firefly moved")
    pos, fit = ff_inputs(300, 30, 1, dev, 0.05, ties=True)
    pos_j, fit_j = ff_inputs(1000, 30, 2, dev, 0.05, ties=True)
    got = ff.firefly_attraction_cuda(pos, fit, pos_j=pos_j, fit_j=fit_j)
    compare_firefly(ff, got, pos, fit, "rectangular 300 x 1000, D=30, ties",
                    pos_j, fit_j)
    flat = ff.firefly_attraction_cuda(pos, torch.full_like(fit, 2.0))
    check(not bool(flat.abs().any()), "equal fitness attracted")

    cases = 0
    for c in (2, 3, 16, 129, 256, 1024):
        for a in (1, 64, 1000):
            for q0 in (0.0, 0.5, 1.0):
                for host in (True, False):
                    if c == 1024 and (a == 1000) == host or (
                            c == 1024 and a == 64 and q0 == 1.0):
                        continue
                    compare_aco(af, c, a, q0, host, dev, c + a + cases)
                    cases += 1
    # Constant scores: every greedy step a tie, to the lowest open city.
    tours = compare_aco(af, 129, 64, 1.0, False, dev, 5, flat=True)
    start = tours[:, 0].tolist()
    check(all(tours[k, 1:].tolist() == [x for x in range(129)
                                        if x != start[k]]
              for k in range(64)), "a greedy tie did not go to the lowest")
    # B21 alone at the edges of its design, each call twice (D repeats bit
    # for bit from run to run).
    g = np.random.default_rng(1)
    odd = deposit_odd_tours(g)
    for label, tours in odd:
        tours = tours.to(dev)
        amount = torch.from_numpy(g.uniform(0.1, 2.0, tours.shape[0])
                                  .astype(np.float32)).to(dev)
        got = af.deposit_matrix_cuda(tours, amount)
        again = af.deposit_matrix_cuda(tours, amount)
        check(torch.equal(got, af.deposit_matrix_plain(tours, amount))
              and torch.equal(got, again),
              f"deposit kernel differs from plain or itself: {label}")
    record(phase="ff_aco_small_shapes", firefly_cases=18,
           firefly_max_err_over_band=worst, aco_cases=cases + 1,
           deposit_odd_cases=[label for label, _ in odd])


def deposit_odd_tours(g):
    """B21's edge cases: (label, tours [A, C] int32 on the CPU)."""
    def perms(c, a):
        return torch.from_numpy(np.argsort(g.random((a, c)), 1)
                                .astype(np.int32))
    return [
        ("C=1, A=7", torch.zeros((7, 1), dtype=torch.int32)),
        ("C=2, A=5", perms(2, 5)),
        ("C=129 (odd), A=1", perms(129, 1)),
        ("C=2048, A=1", perms(2048, 1)),
        ("C=2048, A=1000", perms(2048, 1000)),
        ("repeated cities and entries outside [0, C)",
         torch.from_numpy(g.integers(-2, 40, (300, 37)).astype(np.int32))),
        ("every ant on one tour", torch.arange(256, dtype=torch.int32)
         .repeat(1024, 1)),
        ("rows of ~10,000 edges (C=5 over {0, 1})",
         torch.from_numpy(g.integers(0, 2, (4000, 5)).astype(np.int32))),
        ("313 chunks (C=16, A=20,000)", perms(16, 20_000)),
    ]


def ff_aco_cpu_vs_gpu(dsa, ff, af, dev):
    """Phase 4's part: three firefly generations and three ACO iterations on
    the CPU (plain versions) and on the card (kernels) with the same draws.
    Firefly within ZOO_CPU_BAND (the attraction's sums over j differ).  ACO:
    each iteration from the CPU's state on both, its tours equal wherever
    the argmax margin exceeds twice the largest difference between the two
    devices' scores (log on each), the ants inside it counted, and the state
    equal where every tour is."""
    from distributed_swarm_algorithm_tpu_torch.ops import aco, firefly
    from distributed_swarm_algorithm_tpu_torch.ops import objectives
    fn, hw = objectives.get_objective("sphere")
    cpu = firefly.firefly_init(fn, 2048, 30, hw, seed=1, device="cpu")
    cpu = cpu.replace(pos=cpu.pos * 0.02, fit=fn(cpu.pos * 0.02))
    gpu = firefly.firefly_state_from_numpy(
        firefly.firefly_state_to_numpy(cpu), device=dev)
    noises = [torch.rand((2048, 30), generator=torch.Generator()
                         .manual_seed(k)) for k in range(3)]
    a = firefly.firefly_state_to_numpy(ff.fused_firefly_run(
        cpu, fn, 3, hw, noises=noises))
    before = ff.LAUNCHES
    b = firefly.firefly_state_to_numpy(ff.fused_firefly_run(
        gpu, fn, 3, hw, noises=[x.to(dev) for x in noises]))
    check(ff.LAUNCHES == before + 3, "firefly launches not counted")
    devs = {f: float(np.abs(a[f].astype(np.float64) - b[f]).max())
            for f in a}
    close = all(np.allclose(b[f], a[f], **ZOO_CPU_BAND[
        "fit" if "fit" in f else "pos"]) for f in a)
    record(phase="cpu_vs_gpu", path="fused_firefly_run", particles=2048,
           dim=30, launches=3, band=str(ZOO_CPU_BAND), max_abs_dev=devs)
    check(close and a["iteration"] == b["iteration"],
          f"fused firefly run differs CPU vs GPU: {devs}")

    c, n_ants = 128, 512
    coords = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 100, (c, 2)).astype(np.float32))
    state = aco.aco_init(aco.coords_to_dist(coords), seed=0)
    flips = 0
    for it in range(3):
        draws = af.host_draws(torch.Generator().manual_seed(it), c, n_ants,
                              "cpu")
        on_gpu = aco.aco_state_from_numpy(aco.aco_state_to_numpy(state),
                                          device=dev)
        lg_cpu = aco.aco_logits(state.tau, state.dist, 1.0, 2.0)
        lg_gpu = aco.aco_logits(on_gpu.tau, on_gpu.dist, 1.0, 2.0)
        band = 2.0 * float((lg_gpu.cpu() - lg_cpu).abs().max())
        t_cpu, _ = af.construct_tours_plain(lg_cpu, state.dist, *draws[:1],
                                            None, 0.3, *draws[1:])
        t_gpu = af.construct_tours_cuda(
            lg_gpu, on_gpu.dist, draws[0].to(dev), None, 0.3,
            *(x.to(dev) for x in draws[1:]))[0].cpu()
        differ = (t_cpu != t_gpu).any(1).nonzero().flatten().tolist()
        for k in differ:       # only inside the band may an ant differ
            s = int((t_cpu[k] != t_gpu[k]).nonzero()[0]) - 1
            cur = int(t_cpu[k, s])
            u = draws[1][s, :, k]
            greedy = float(draws[2][s, k]) < 0.3
            row = lg_cpu[:, cur] + (0.0 if greedy else af.gumbel_fast(u))
            gap = float(row[t_cpu[k, s + 1]] - row[t_gpu[k, s + 1]])
            check(0.0 <= gap <= band + 1e-6 * abs(float(row.max())),
                  f"ACO tour differs CPU vs GPU outside the band: {gap}")
        flips += len(differ)
        nxt_cpu = af.fused_aco_step(state, n_ants, q0=0.3, elite=2.0,
                                    rng="host", draws=draws)
        nxt_gpu = af.fused_aco_step(on_gpu, n_ants, q0=0.3, elite=2.0,
                                    rng="host",
                                    draws=tuple(x.to(dev) for x in draws))
        if not differ:
            x, y = (aco.aco_state_to_numpy(s) for s in (nxt_cpu, nxt_gpu))
            check(all(np.array_equal(x[f], y[f]) for f in x),
                  "ACO step differs CPU vs GPU with equal tours")
        state = nxt_cpu
    record(phase="cpu_vs_gpu", path="fused_aco_step", cities=c, ants=n_ants,
           iterations=3, ants_inside_margin_band=flips,
           band="twice the largest score difference between the devices")


def aco_tours_bound_ms(tours):
    """Least time for one B20 call of the sampling rule that made
    ``tours`` [A, C] (ACO_OPS).  Step s leaves C - 1 - s cities open; a
    block of four cities holds one until the step that visits its last, so
    its Philox call is needed at that many steps, which the tours give."""
    o = ACO_OPS
    a, c = tours.shape
    at = torch.zeros((a, -(-c // 4) * 4), dtype=torch.int64,
                     device=tours.device)
    at.scatter_(1, tours.long(), torch.arange(c, device=tours.device)
                .expand(a, c))
    block_steps = int(at.view(a, -1, 4).amax(2).sum())
    ops = (a * (c - 1) * o["step"] + a * c * (c - 1) // 2 * o["open_city"]
           + block_steps * o["open_block"])
    nbytes = 4 * (2 * c * c + a + a * c + a)
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def aco_deposit_bound_ms(c, a):
    ops = a * c * ACO_OPS["deposit_edge"]
    nbytes = 4 * (a * c + a + c * c)
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def firefly_full_width(dsa, ff, kernels, smi, t_start, dev):
    """Phase 14's firefly part: bench_firefly_64k.py's two rows through
    ``Firefly`` after a warm-up run each, counted and checked; then B19 at
    the 65,536 final state against its plain version, timed beside it and
    its bound."""
    runs = {}
    for n, steps in ((FF_N, FF_STEPS), (FF_N2, FF_STEPS2)):
        opt = dsa.Firefly("rastrigin", n=n, dim=FF_DIM, seed=0)
        check(opt.use_pallas, "Firefly did not take the kernel on the card")
        hw32 = float(np.float32(opt.half_width))
        bests = [opt.state.best_fit.clone()]
        opt.run(steps)                                    # warm-up run
        bests.append(opt.state.best_fit.clone())
        reset_launches(kernels)
        _, run_ms = timed(lambda: opt.run(steps))
        launches = {name: m.LAUNCHES for name, m in kernels.items()}
        bests.append(opt.state.best_fit.clone())
        state = opt.state
        rec = dict(phase="full_width", model="Firefly", objective="rastrigin",
                   particles=n, dim=FF_DIM, steps=steps, launches=launches,
                   run_ms=run_ms, ms_per_generation=run_ms / steps,
                   particle_steps_per_sec=n * steps / (run_ms / 1e3),
                   best_initial_warm_final=[float(b) for b in bests],
                   max_abs_pos=float(state.pos.abs().max()),
                   iteration=int(state.iteration),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   smi=smi)
        record(**rec)
        hashgrid_launch_check(launches, "firefly_fused", steps)
        check(bool(bests[0] >= bests[1] and bests[1] >= bests[2]
                   and torch.isfinite(bests[2])),
              f"firefly: the best rose or is not finite: {rec}")
        check(rec["max_abs_pos"] <= hw32, "firefly: a position left the domain")
        runs[n] = (opt, launches["firefly_fused"], run_ms)
    opt, n_launches, run_ms = runs[FF_N]
    pos, fit = opt.state.pos, opt.state.fit
    got = ff.firefly_attraction_cuda(pos, fit)
    counts = {}
    cmp, plain_ms = compare_firefly(ff, got, pos, fit,
                                    "main path, 65,536 final state",
                                    counts=counts)
    del got
    ms = cuda_ms(lambda: ff.firefly_attraction_cuda(pos, fit), 5)
    bound, bound_by, ops, nbytes = ff_bound_ms(FF_N, FF_N, FF_DIM, counts)
    record(phase="firefly_fused_timing", shape=[FF_N, FF_DIM], kernel_ms=ms,
           plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
           operations=ops, bytes=nbytes,
           brighter_pairs=int(sum(int(v) for v in counts["brighter"])),
           weighted_pairs=int(sum(int(v) for v in counts["weighted"])),
           kernel_share_of_run=ms * n_launches / run_ms, smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    # At the bench's spread almost no pair attracts, so the sums over j stay
    # empty: the same swarm drawn 50 times closer, where about half the
    # pairs attract, holds the accumulation at full width.
    pos = pos * 0.02
    fit = opt.objective(pos).contiguous()
    got = ff.firefly_attraction_cuda(pos, fit)
    counts = {}
    close, close_plain_ms = compare_firefly(
        ff, got, pos, fit, "65,536 final state x 0.02", counts=counts)
    del got
    close_ms = cuda_ms(lambda: ff.firefly_attraction_cuda(pos, fit), 5)
    c_bound, c_by, c_ops, _ = ff_bound_ms(FF_N, FF_N, FF_DIM, counts)
    weighted = int(sum(int(v) for v in counts["weighted"]))
    record(phase="firefly_fused_timing_attracting", shape=[FF_N, FF_DIM],
           scale=0.02, kernel_ms=close_ms, plain_ms=close_plain_ms,
           bound_ms=c_bound, bound_by=c_by, operations=c_ops,
           brighter_pairs=int(sum(int(v) for v in counts["brighter"])),
           weighted_pairs=weighted, max_abs_err=close["max_abs_err"],
           max_err_over_band=close["max_err_over_band"], smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    check(weighted > FF_N * FF_N // 4,
          f"the close swarm attracts too few pairs: {weighted}")
    return dict(name="firefly_fused", route="cuda",
                source="distributed_swarm_algorithm_tpu_torch/csrc/"
                       "firefly_fused.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                         "firefly_fused.py:126",
                launches=n_launches, max_abs_err=cmp["max_abs_err"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def aco_run_checked(dsa, af, kernels, coords, iters, smi, label, warm=5,
                    **kw):
    """One ``ACO`` run on the card after ``warm`` iterations: timed, counted
    (one launch of each kernel an iteration, no other kernel), the best
    never rising, every tour of the last iteration a permutation with its
    in-kernel lengths the ordered sums, tau symmetric and finite."""
    colony = dsa.ACO(coords=coords, seed=0, **kw)
    check(colony.use_pallas, "ACO did not take the kernels on the card")
    bests = [colony.state.best_len.clone()]
    colony.run(warm)
    bests.append(colony.state.best_len.clone())
    last = {}
    reset_launches(kernels)
    _, run_ms = timed(lambda: colony.run(iters, out=last))
    launches = {name: m.LAUNCHES for name, m in kernels.items()}
    bests.append(colony.state.best_len.clone())
    state = colony.state
    c = coords.shape[0]
    tours, lengths = last["tours"], last["lengths"]
    perm = bool((torch.sort(tours, 1).values
                 == torch.arange(c, device=tours.device)).all())
    ordered = torch.equal(lengths, af.tour_lengths_in_order(state.dist,
                                                            tours))
    rec = dict(phase="full_width", model="ACO", instance=label, cities=c,
               ants=colony.n_ants, iterations=iters, q0=colony.q0,
               elite=colony.elite, launches=launches, run_ms=run_ms,
               ms_per_iteration=run_ms / iters,
               tours_per_sec=colony.n_ants * iters / (run_ms / 1e3),
               best_initial_warm_final=[float(b) for b in bests],
               last_tours_permutations=perm, lengths_in_kernel_order=ordered,
               # (1 - rho) tau + D + D^T adds the two directions in turn,
               # as does the elitist deposit, each rounding apart, and
               # evaporation keeps 1 - rho of the earlier asymmetry:
               # symmetric within 4 ulps / rho.
               tau_max_asymmetry=float(((state.tau - state.tau.T).abs()
                                        / state.tau.abs()).max()),
               tau_finite=bool(torch.isfinite(state.tau).all()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               smi=smi)
    want = {name: 0 for name in launches}
    want.update(aco_tours=iters, aco_deposit=iters)
    check(launches == want, f"unexpected launches {launches}")
    check(bool(bests[1] >= bests[2] and torch.isfinite(bests[2])),
          f"ACO: the best rose or is not finite: {rec}")
    check(perm and ordered and rec["tau_max_asymmetry"] <= 2.0 ** -22 / colony.rho
          and rec["tau_finite"],
          f"ACO: a wrong tour, length or pheromone: {rec}")
    return colony, rec, run_ms, last


def aco_full_width(dsa, af, kernels, smi, t_start, dev):
    """Phase 14's ACO part: bench_aco.py's instance (C = 256, A = 1,024, 400
    iterations), the device's busy share from a trace of 16 more, B20 and
    B21 at the final pheromone against their plain versions, timed beside
    them, their bounds and index_add_; then bench_aco_sweep.py's C = 512
    and 1,024 and its circle-1,024 known optimum."""
    from distributed_swarm_algorithm_tpu_torch.ops import aco
    coords = np.random.default_rng(0).uniform(0, 100, (ACO_C, 2)).astype(
        np.float32)
    colony, rec, run_ms, _ = aco_run_checked(dsa, af, kernels, coords,
                                          ACO_ITERS, smi, "uniform-256",
                                          n_ants=ACO_A)
    record(**rec)
    launches = rec["launches"]
    busy, ops_per, top = device_time(lambda: colony.run(ACO_PROFILED),
                                     ACO_PROFILED)
    ms_it = run_ms / ACO_ITERS
    record(phase="aco_iteration_breakdown", cities=ACO_C, ants=ACO_A,
           profiled_iterations=ACO_PROFILED, ms_per_iteration=ms_it,
           device_busy_ms_per_iteration=busy,
           device_busy_share=None if busy is None else busy / ms_it,
           device_idle_share=None if busy is None else 1.0 - busy / ms_it,
           device_ops_per_iteration=ops_per, top_device_ops=top, smi=smi)

    state = colony.state
    logits = aco.aco_logits(state.tau, state.dist, 1.0, 2.0)
    start = torch.randint(0, ACO_C, (ACO_A,), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    seed = torch.tensor([2026], dtype=torch.int32, device=dev)
    tours, lengths = af.construct_tours_cuda(logits, state.dist, start, seed)
    want, tours_plain_ms = timed(lambda: af.construct_tours_plain(
        logits, state.dist, start, seed))
    check(torch.equal(tours, want[0]) and torch.equal(lengths, want[1]),
          "B20 differs from its plain version at the main path's state")
    tours_err = float((lengths - want[1]).abs().max())
    tours_ms = cuda_ms(lambda: af.construct_tours_cuda(
        logits, state.dist, start, seed), 20)
    t_bound, t_by, t_ops, t_bytes = aco_tours_bound_ms(tours)
    record(phase="aco_tours_timing", shape=[ACO_A, ACO_C], kernel_ms=tours_ms,
           plain_ms=tours_plain_ms, bound_ms=t_bound, bound_by=t_by,
           operations=t_ops, bytes=t_bytes, chain_steps=ACO_C - 1,
           kernel_share_of_run=tours_ms * launches["aco_tours"] / run_ms,
           max_abs_err=tours_err, smi=smi)
    amount = torch.full_like(lengths, 1.0) / lengths
    d = af.deposit_matrix_cuda(tours, amount)
    want_d, dep_plain_ms = timed(lambda: af.deposit_matrix_plain(tours,
                                                                 amount))
    check(torch.equal(d, want_d), "B21 differs from its plain version")
    dep_err = float((d - want_d).abs().max())
    flat = (tours.long() * ACO_C + torch.roll(tours.long(), -1, 1)).flatten()
    rep = amount[:, None].expand(tours.shape).flatten()
    lib = torch.zeros(ACO_C * ACO_C, device=dev).index_add_(0, flat, rep)
    d_bound, d_by, d_ops, d_bytes = aco_deposit_bound_ms(ACO_C, ACO_A)
    # B21 is two short kernels: called back to back, a call of it or of
    # index_add_ is paced by the host (the wrapper's checks, allocations
    # and ctypes, or PyTorch's dispatch), so both are timed replayed from a
    # CUDA graph, the device's time alone, and back to back beside it.
    dep_ms = graph_ms(lambda: af.deposit_matrix_cuda(tours, amount), 50)
    lib_ms = graph_ms(lambda: torch.zeros(ACO_C * ACO_C, device=dev)
                      .index_add_(0, flat, rep), 50)
    dep_loop_ms = cuda_ms(lambda: af.deposit_matrix_cuda(tours, amount), 50)
    lib_loop_ms = cuda_ms(lambda: torch.zeros(ACO_C * ACO_C, device=dev)
                          .index_add_(0, flat, rep), 50)
    record(phase="aco_deposit_timing", shape=[ACO_A, ACO_C], kernel_ms=dep_ms,
           plain_ms=dep_plain_ms, library_ms=lib_ms,
           kernel_back_to_back_ms=dep_loop_ms,
           library_back_to_back_ms=lib_loop_ms,
           library="torch.Tensor.index_add_ (atomics; its sums change order)",
           library_max_abs_dev=float((lib.view(ACO_C, ACO_C) - d).abs()
                                     .max()),
           bound_ms=d_bound, bound_by=d_by, operations=d_ops, bytes=d_bytes,
           kernel_share_of_run=dep_ms * launches["aco_deposit"] / run_ms,
           smi=smi, seconds_so_far=time.perf_counter() - t_start)
    rows = [
        dict(name="aco_tours", route="cuda",
             source="distributed_swarm_algorithm_tpu_torch/csrc/aco_fused.cu",
             replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                      "aco_fused.py:217",
             launches=launches["aco_tours"], max_abs_err=tours_err,
             ms=tours_ms,
             plain_ms=tours_plain_ms, bound_ms=t_bound, bound_by=t_by,
             library_ms=None),
        dict(name="aco_deposit", route="cuda",
             source="distributed_swarm_algorithm_tpu_torch/csrc/aco_fused.cu",
             replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                      "aco_fused.py:371",
             launches=launches["aco_deposit"], max_abs_err=dep_err,
             ms=dep_ms,
             plain_ms=dep_plain_ms, bound_ms=d_bound, bound_by=d_by,
             library_ms=lib_ms),
    ]
    del colony, state, tours, lengths, want, d, want_d

    for c, iters in ACO_SWEEP:
        coords = np.random.default_rng(0).uniform(0, 100, (c, 2)).astype(
            np.float32)
        _, rec, run_ms, last = aco_run_checked(
            dsa, af, kernels, coords, iters, smi, f"uniform-{c}", n_ants=ACO_A)
        record(**rec, seconds_so_far=time.perf_counter() - t_start)
        tours, lengths = last["tours"], last["lengths"]
        amount = torch.full_like(lengths, 1.0) / lengths
        d = af.deposit_matrix_cuda(tours, amount)
        check(torch.equal(d, af.deposit_matrix_plain(tours, amount)),
              f"B21 differs from its plain version at C = {c}")
        ms = graph_ms(lambda: af.deposit_matrix_cuda(tours, amount), 50)
        record(phase="aco_deposit_timing", shape=[ACO_A, c], kernel_ms=ms,
               kernel_back_to_back_ms=cuda_ms(
                   lambda: af.deposit_matrix_cuda(tours, amount), 50),
               bound_ms=aco_deposit_bound_ms(c, ACO_A)[0],
               kernel_share_of_run=ms * iters / run_ms, smi=smi)
    th = 2 * np.pi * np.arange(ACO_CIRCLE) / ACO_CIRCLE
    coords = np.stack([100 * np.cos(th), 100 * np.sin(th)], 1).astype(
        np.float32)
    colony, rec, _, _ = aco_run_checked(dsa, af, kernels, coords,
                                     ACO_CIRCLE_ITERS, smi, "circle-1024",
                                     warm=1, n_ants=ACO_A, q0=0.1, elite=4.0)
    # The circle order's length summed as the kernel sums a tour.  The
    # colony's best may be the same cycle from another start or the other
    # way round, summed in another order: it lies no more than C ulps
    # below.
    opt = float(af.tour_lengths_in_order(colony.state.dist, torch.arange(
        ACO_CIRCLE, device=dev)[None, :])[0])
    gap = colony.best_length / opt - 1.0
    perm = sorted(colony.best_tour.tolist()) == list(range(ACO_CIRCLE))
    record(**rec, known_optimum=opt, gap_pct=100.0 * gap,
           best_tour_permutation=perm,
           seconds_so_far=time.perf_counter() - t_start)
    check(np.isfinite(gap) and gap >= -ACO_CIRCLE * 2.0 ** -24 and perm,
          f"circle gap {gap}, best tour a permutation {perm}")
    return rows


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
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        pso_fused as pf,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        islands_fused as isl,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        aco_fused as af,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        firefly_fused as ff,
    )
    from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as hp
    from distributed_swarm_algorithm_tpu_torch.ops import objectives
    from distributed_swarm_algorithm_tpu_torch.parallel import islands
    from distributed_swarm_algorithm_tpu_torch.state import AGENT_AXIS_FIELDS

    # Launch counters by kernel; the two PSO kernels share one source.
    zoo = zoo_modules()
    rot = rot_modules()
    levy = levy_modules()
    kernels = {"separation": sep, "window_separation": win,
               "grid_separation": grid, "candidate_sweep": cand,
               "pso_fused": pf, "islands_fused": isl,
               **{f"{fam}_fused": mod for fam, mod in zoo.items()},
               **{f"{fam}_fused": mod for fam, mod in rot.items()},
               **{f"{fam}_fused": mod for fam, mod in levy.items()},
               "firefly_fused": ff,
               "aco_tours": LaunchCount(af, "TOURS_LAUNCHES"),
               "aco_deposit": LaunchCount(af, "DEPOSIT_LAUNCHES")}
    sources = ["separation", "window_separation", "grid_separation",
               "candidate_sweep", "pso_fused",
               *(f"{fam}_fused" for fam in zoo),
               *(f"{fam}_fused" for fam in rot),
               *LEVY_SOURCES.values(), "firefly_fused", "aco_fused"]
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
    per_source = _build.build(sources)
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name in sources}
    record(phase="build", seconds=time.perf_counter() - t0,
           per_source=per_source, ptxas=ptxas)

    # 3. kernels vs plain on the card ---------------------------------------
    separation_small_shapes(sep, dev)
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
    pso_small_shapes(pf, isl, dev)
    zoo_small_shapes(zoo, pf, dev)
    rot_small_shapes(rot, pf, dev)
    levy_small_shapes(levy, pf, dev)
    ff_aco_small_shapes(ff, af, dev)

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

    pso_cpu_vs_gpu(dsa, pf, dev)
    zoo_cpu_vs_gpu(dsa, zoo, dev)
    rot_cpu_vs_gpu(rot, dev)
    levy_cpu_vs_gpu(levy, dev)
    ff_aco_cpu_vs_gpu(dsa, ff, af, dev)

    # 5. the main path at full width, "pallas" ------------------------------
    # A warm-up swarm first: a process's first ticks at this size pay the
    # allocator's growth and first-use costs on the host, which B1's first
    # version (4.25 ms a tick on the device) hid and which the host-bound
    # tick would now count.
    warm = dsa.VectorSwarm(BENCH_N, spread=BENCH_SPREAD, config=cfg, seed=1)
    warm.step(8)
    torch.cuda.synchronize()
    del warm
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
    # The design's worst case, reported and not gated: the same number of
    # agents inside +-5 m, where about 12% of all pairs are near and every
    # warp takes the force branch on every group of senders.
    pos, alive = random_swarm(BENCH_N, 2, 7, 5.0, 0.0, False, dev)
    _, crowd_cmp = compare_separation(sep, pos, alive, "65,536 in +-5 m")
    crowd_ms = cuda_ms(
        lambda: sep.separation_cuda(pos, alive, K_SEP, R, EPS), 10)
    crowd_bound_ms, crowd_bound_by = separation_bound_ms(pos, alive)
    record(phase="separation_timing_crowded", shape=[BENCH_N, 2], box_m=5.0,
           kernel_ms=crowd_ms, bound_ms=crowd_bound_ms,
           bound_by=crowd_bound_by, near_pairs=near_pairs(pos, alive),
           worst_share_of_band=crowd_cmp["worst_share_of_band"], smi=smi)
    # Where the tick's time goes now that B1 is short: the device's busy
    # time per tick from a trace of 16 more ticks, against the tick.
    busy, ops, top = device_breakdown(sw, 16)
    ms_tick = total_ms / BENCH_TICKS
    record(phase="pallas_tick_breakdown", agents=BENCH_N, ms_per_tick=ms_tick,
           profiled_ticks=16, device_busy_ms_per_tick=busy,
           device_idle_share=None if busy is None else 1.0 - busy / ms_tick,
           device_ops_per_tick=ops, top_device_ops=top, smi=smi)
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

    del state, plan, args

    # 8. the PSO headline run at full width ---------------------------------
    opt = dsa.PSO("rastrigin", n=PSO_N, dim=PSO_DIM, seed=0,
                  steps_per_kernel=PSO_K)
    check(opt.use_pallas, "PSO did not take the fused kernel on the card")
    hw32 = float(np.float32(opt.half_width))
    bests = [opt.best]
    opt.run(PSO_K)                                   # warm-up: one launch
    bests.append(opt.best)
    reset_launches(kernels)
    _, pso_run_ms = timed(lambda: opt.run(PSO_STEPS))
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    bests.append(opt.best)
    state = opt.state
    record(
        phase="full_width", model="PSO", objective="rastrigin",
        particles=PSO_N, dim=PSO_DIM, steps=PSO_STEPS, steps_per_kernel=PSO_K,
        launches=launches, run_ms=pso_run_ms,
        ms_per_launch_in_run=pso_run_ms / (PSO_STEPS // PSO_K),
        particle_steps_per_sec=PSO_N * PSO_STEPS / (pso_run_ms / 1e3),
        gbest_initial_warm_final=bests,
        max_abs_pos=float(state.pos.abs().max()),
        iteration=int(state.iteration),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, smi=smi,
    )
    hashgrid_launch_check(launches, "pso_fused", PSO_STEPS // PSO_K)
    pso_launches = launches["pso_fused"]
    check(bests[0] >= bests[1] >= bests[2] and np.isfinite(bests).all(),
          f"gbest rose or is not finite: {bests}")
    check(float(state.pos.abs().max()) <= hw32, "a position left the domain")
    check(tuple(state.pos.shape) == (PSO_N, PSO_DIM)
          and int(state.iteration) == PSO_K + PSO_STEPS, "wrong state")
    check(bool((state.pbest_fit >= state.gbest_fit).all()),
          "gbest is not the least pbest seen")

    # One step's uniforms read back from the kernel at full width: with
    # w = 0, c2 = 0 and pbest = pos + 1 the new velocity is r1 itself.
    seed = torch.tensor([2024], dtype=torch.int32, device=dev)
    zeros = torch.zeros((PSO_DIM, PSO_N), device=dev)
    drawn = pf.fused_pso_step_cuda(
        seed, zeros[:, :1].contiguous(), zeros, zeros, zeros + 1.0,
        torch.zeros((1, PSO_N), device=dev), objective_name="sphere",
        w=0.0, c1=1.0, c2=0.0, half_width=100.0, k_steps=1, step0=77,
        track_best=False)[1]
    expected = pf.philox_uniforms(seed, PSO_N, PSO_DIM, 77, 0)
    u_mean, u_var = float(drawn.mean()), float(drawn.var())
    record(phase="kernel_uniforms", samples=drawn.numel(), mean=u_mean,
           variance=u_var, min=float(drawn.min()), max=float(drawn.max()),
           equal_to_plain=bool(torch.equal(drawn, expected)),
           band="|mean - 1/2| < 1e-3, |variance - 1/12| < 1e-3")
    check(abs(u_mean - 0.5) < 1e-3 and abs(u_var - 1 / 12) < 1e-3
          and 0.0 <= float(drawn.min()) and float(drawn.max()) < 1.0,
          "the kernel's uniforms are not uniform on [0, 1)")
    check(torch.equal(drawn, expected),
          "the kernel's uniforms are not the plain version's")
    del zeros, drawn, expected

    # The kernel at the main path's shape: one 64-step launch from the
    # final state against its plain version, timed beside it and the bound.
    pos_t, vel_t, bpos_t, bfit_t = pf.prep_padded_t(state, PSO_N)
    step_args = (seed, state.gbest_pos[:, None].contiguous(), pos_t, vel_t,
                 bpos_t, bfit_t)
    step_kw = dict(objective_name="rastrigin", half_width=opt.half_width,
                   k_steps=PSO_K, track_best=False, step0=PSO_STEPS)
    got = pf.fused_pso_step_cuda(*step_args, **step_kw)
    want, pso_plain_ms = timed(
        lambda: pf.fused_pso_step_plain(*step_args, **step_kw))
    pso_cmp = compare_pso(pf, "pso_fused", "rastrigin",
                          "main path, final state", got, want, bfit_t, PSO_K)
    del got, want
    pso_ms = cuda_ms(lambda: pf.fused_pso_step_cuda(*step_args, **step_kw), 5)
    pso_ms_k8 = cuda_ms(lambda: pf.fused_pso_step_cuda(
        *step_args, **dict(step_kw, k_steps=8)), 5)
    pso_bound, pso_bound_by, ops, nbytes = pso_bound_ms(PSO_N, PSO_DIM,
                                                        PSO_K, 1)
    record(phase="pso_fused_timing", shape=[PSO_DIM, PSO_N], k_steps=PSO_K,
           kernel_ms=pso_ms, plain_ms=pso_plain_ms, bound_ms=pso_bound,
           bound_by=pso_bound_by, operations=ops, bytes=nbytes,
           kernel_ms_at_k8=pso_ms_k8,
           bound_ms_at_k8=pso_bound_ms(PSO_N, PSO_DIM, 8, 1)[:2],
           kernel_share_of_run=pso_ms * pso_launches / pso_run_ms, smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    del opt, state, pos_t, vel_t, bpos_t, bfit_t, step_args

    # 9. the island run at full width ---------------------------------------
    fn, hw = objectives.get_objective("rastrigin")
    ist = islands.island_init(fn, ISL_I, ISL_N, PSO_DIM, hw, seed=0)
    run_kw = dict(migrate_every=ISL_EVERY, migrate_k=ISL_MIGRANTS,
                  half_width=hw, steps_per_kernel=PSO_K)
    island_bests = [ist.pso.gbest_fit.clone()]
    ist = isl.fused_island_run(ist, "rastrigin", PSO_K, **run_kw)  # warm-up
    island_bests.append(ist.pso.gbest_fit.clone())
    reset_launches(kernels)
    ist, isl_run_ms = timed(lambda: isl.fused_island_run(
        ist, "rastrigin", ISL_STEPS, **run_kw))
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    island_bests.append(ist.pso.gbest_fit.clone())
    best_fit, best_pos = islands.global_best(ist)
    record(
        phase="full_width", model="islands", objective="rastrigin",
        islands=ISL_I, particles_per_island=ISL_N, dim=PSO_DIM,
        steps=ISL_STEPS, migrate_every=ISL_EVERY, migrate_k=ISL_MIGRANTS,
        steps_per_kernel=PSO_K, launches=launches, run_ms=isl_run_ms,
        ms_per_launch_in_run=isl_run_ms / (ISL_STEPS // PSO_K),
        particle_steps_per_sec=ISL_I * ISL_N * ISL_STEPS / (isl_run_ms / 1e3),
        global_best=float(best_fit),
        island_gbest_min_median_max=[
            float(q) for q in torch.quantile(
                ist.pso.gbest_fit, torch.tensor([0.0, 0.5, 1.0],
                                                device=dev))],
        max_abs_pos=float(ist.pso.pos.abs().max()),
        iteration=int(ist.iteration),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, smi=smi,
    )
    hashgrid_launch_check(launches, "islands_fused", ISL_STEPS // PSO_K)
    isl_launches = launches["islands_fused"]
    check(bool((island_bests[0] >= island_bests[1]).all()
               and (island_bests[1] >= island_bests[2]).all()
               and torch.isfinite(island_bests[2]).all()),
          "an island's gbest rose or is not finite")
    check(float(best_fit) == float(ist.pso.gbest_fit.min())
          and tuple(best_pos.shape) == (PSO_DIM,), "wrong global best")
    check(float(ist.pso.pos.abs().max()) <= hw32
          and tuple(ist.pso.pos.shape) == (ISL_I, ISL_N, PSO_DIM)
          and int(ist.iteration) == PSO_K + ISL_STEPS, "wrong island state")
    check(bool((ist.pso.pbest_fit.min(1).values >= ist.pso.gbest_fit).all()),
          "an island's gbest is not the least pbest it has seen")

    flat = lambda x: x.reshape(ISL_I * ISL_N, PSO_DIM).T.contiguous()  # noqa
    step_args = (seed, ist.pso.gbest_pos.T.contiguous(), flat(ist.pso.pos),
                 flat(ist.pso.vel), flat(ist.pso.pbest_pos),
                 ist.pso.pbest_fit.reshape(1, -1).contiguous())
    step_kw = dict(objective_name="rastrigin", half_width=hw,
                   lanes_per_island=ISL_N, k_steps=PSO_K, step0=ISL_STEPS)
    got = isl.islands_step_cuda(*step_args, **step_kw)
    want, isl_plain_ms = timed(
        lambda: isl.islands_step_plain(*step_args, **step_kw))
    isl_cmp = compare_pso(pf, "islands_fused", "rastrigin",
                          "main path, final state", got, want, step_args[5],
                          PSO_K)
    del got, want
    isl_ms = cuda_ms(lambda: isl.islands_step_cuda(*step_args, **step_kw), 5)
    isl_bound, isl_bound_by, ops, nbytes = pso_bound_ms(
        ISL_I * ISL_N, PSO_DIM, PSO_K, ISL_I)
    record(phase="islands_fused_timing", shape=[PSO_DIM, ISL_I * ISL_N],
           islands=ISL_I, k_steps=PSO_K, kernel_ms=isl_ms,
           plain_ms=isl_plain_ms, bound_ms=isl_bound, bound_by=isl_bound_by,
           operations=ops, bytes=nbytes,
           kernel_share_of_run=isl_ms * isl_launches / isl_run_ms, smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    del ist, step_args

    # 10. a short memetic run at full width ---------------------------------
    mem = dsa.MemeticPSO("rastrigin", n=PSO_N, dim=PSO_DIM, seed=0)
    check(mem.use_pallas, "MemeticPSO did not take the fused kernel")
    before_fit, before_best = mem.state.pbest_fit.clone(), mem.best
    reset_launches(kernels)
    _, mem_ms = timed(lambda: mem.run(MEM_STEPS))
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    blocks_per_chunk = -(-mem.refine_every // min(mem.steps_per_kernel,
                                                 mem.refine_every))
    record(
        phase="full_width", model="MemeticPSO", objective="rastrigin",
        particles=PSO_N, dim=PSO_DIM, steps=MEM_STEPS,
        refine_every=mem.refine_every, refine_steps=mem.refine_steps,
        steps_per_kernel=mem.steps_per_kernel, launches=launches,
        run_ms=mem_ms,
        particle_steps_per_sec=PSO_N * MEM_STEPS / (mem_ms / 1e3),
        gbest_before_after=[before_best, mem.best],
        pbest_improved=int((mem.state.pbest_fit < before_fit).sum()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, smi=smi,
        seconds_so_far=time.perf_counter() - t_start,
    )
    hashgrid_launch_check(
        launches, "pso_fused",
        (MEM_STEPS // mem.refine_every) * blocks_per_chunk)
    check(bool((mem.state.pbest_fit <= before_fit).all())
          and mem.best <= before_best and np.isfinite(mem.best),
          "a personal best worsened in the memetic run")
    check(float(mem.state.pos.abs().max()) <= hw32
          and int(mem.state.iteration) == MEM_STEPS, "wrong memetic state")
    del mem

    # 11. the bat, grey-wolf, salp and whale optimizers at full width -------
    zoo_rows = [zoo_full_width(dsa, fam, mod, kernels, smi, t_start, dev)
                for fam, mod in zoo.items()]

    # 12. DE, SHADE, GA and moth-flame optimization at full width ----------
    rot_rows = [rot_full_width(dsa, fam, rot, kernels, smi, t_start, dev)
                for fam in rot]

    # 13. cuckoo, Harris hawks, ABC and parallel tempering at full width ----
    levy_rows = [levy_full_width(dsa, fam, levy, kernels, smi, t_start, dev)
                 for fam in levy]

    # 14. firefly and ACO at full width ---------------------------------------
    ff_row = firefly_full_width(dsa, ff, kernels, smi, t_start, dev)
    aco_rows = aco_full_width(dsa, af, kernels, smi, t_start, dev)

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
        {
            "name": "pso_fused",
            "route": "cuda",
            "source": "distributed_swarm_algorithm_tpu_torch/csrc/"
                      "pso_fused.cu",
            "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                        "pso_fused.py:379",
            "launches": pso_launches,
            "max_abs_err": pso_cmp["max_abs_err"],
            "ms": pso_ms,
            "plain_ms": pso_plain_ms,
            "bound_ms": pso_bound,
            "bound_by": pso_bound_by,
            "library_ms": None,
        },
        {
            "name": "islands_fused",
            "route": "cuda",
            "source": "distributed_swarm_algorithm_tpu_torch/csrc/"
                      "pso_fused.cu",
            "replaces": "distributed_swarm_algorithm_tpu/ops/pallas/"
                        "islands_fused.py:48",
            "launches": isl_launches,
            "max_abs_err": isl_cmp["max_abs_err"],
            "ms": isl_ms,
            "plain_ms": isl_plain_ms,
            "bound_ms": isl_bound,
            "bound_by": isl_bound_by,
            "library_ms": None,
        },
        *zoo_rows,
        *rot_rows,
        *levy_rows,
        ff_row,
        *aco_rows,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
