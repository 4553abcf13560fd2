#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX.  Phases, each of which must pass:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, one nvcc per source, started
   together, into build/kernels/; the registers and spills of every
   kernel, those of the redesigned B19 and B8 apart, and the opcode census
   of B8's D = 30 kernel (``cuobjdump -sass``); the opcode and loop census
   of the redesigned B20's main kernel (one block of four cities a lane,
   sampling, device draws; and two blocks a lane, for C = 1,024) and of
   B5's and B6's (D mod 4 = 2, rastrigin, device draws), whose step loops
   give the issue floors of phases 8, 9 and 14; and of B10's and B12's
   main kernels (the staged DE windows, the cuckoo tile on chip across a
   cluster; D mod 4 = 2, rastrigin, device draws) with their registers
   and spills, beside their second variants (the first versions, kept),
   whose step loops give the issue floors of phases 12 and 13; and so for
   B7's and B17's (the bat step with no candidate tile, the ABC tile on
   chip across a cluster), whose loops give the issue floors of phases 11
   and 13, B18's and B13's, and B15's (the GA tile on chip across a
   cluster), whose loops give the issue floor of phase 12, B9's and
   B11's (the salp chain in one staged buffer, the whale's lanes regrouped
   by branch), whose loops give the issue floors of phase 11, and B14's
   and B4's (the SHADE generation with x and the trial on chip, the window
   pass with a square-root-free cut and a warp queue of near pairs, its
   first version's global-memory kernel beside it), whose loops give the
   issue floors of phases 12 and 6, and B2's and B3's (the hashgrid sweep
   off the plan's cell runs with its rescue, the candidate sweep over
   several cells a warp), whose loops give the issue floors of phase 7
   (``redesigned_census``, records ``redesigned_builds_de_cuckoo``,
   ``redesigned_builds_bat_abc``, ``redesigned_builds_pt_hho``,
   ``redesigned_builds_ga``, ``redesigned_builds_salp_woa``,
   ``redesigned_builds_shade_window`` and ``redesigned_builds_grid_cand``);
   and N1, NSGA-II's ranks (``csrc/nsga2_ranks.cu``), and N2, the
   auction's bidding loop (``csrc/auction.cu``), with the others;
3. kernel vs plain: the separation kernel against its plain PyTorch
   version on the card at eight shapes (N below a warp, N one past a
   block's 256 receivers, all dead, a dead receiver among live ones, D = 3,
   a co-located trio, a crowded swarm, N = 65,536), the window-separation
   kernel against its own, bit for bit, at eleven (W = 600, 1,500 and 3,000,
   every shift near, 90% and all dead, W = 40, a partial warp), the hashgrid
   slot kernel at six (R = 1, R = 2, past the cap, a stale skinned plan,
   crowds past the rescue budget at R = 1 and 2) and the candidate kernel
   at five (skin 0, stale, after partial refreshes, truncated tables,
   cells of more than 32 receivers); the fused PSO kernel at N not a multiple
   of its block, D = 1, 8, 30 and 100, one step and eight, uniforms handed
   in and drawn in the kernel, with and without the best candidate, every
   objective at least once, and the island kernel at 3 ragged islands;
   N1 against its plain version under ``torch.equal``, with its front
   count, at P = 1, 31, 1,024, 1,025, 2,049 and 4,096 by M = 1, 2, 3 on
   random points, single chains of P fronts (P up to 4,096, past the bits
   that fit in shared memory), all points equal, duplicates, +-0 and
   +-inf, and feasible, infeasible and tied violations; N2 against its
   plain version under ``torch.equal`` on all four outputs (agent_task,
   task_agent, prices, rounds) at S = 1, 2, 3, 31, 33, 1,000, 1,023 and
   1,025, all ties, an infeasible agent and task, N != T squared, a third
   of the agents with zero rows (+0 and -0, S not a multiple of 4),
   virtual zero rows, the round cap (also mid-war), warm prices, the run
   flag off, both schedules the entry chooses at the edge between them
   (S = 7,792, a cluster of 16 with its state in shared memory, and
   7,793, one block on the global scratch, both with zero rows), and
   S = 9,800 with zero rows and 10,000 (one block, its state in global
   scratch);
4. CPU vs GPU: the port's tick on the CPU and on the card, 100 ticks with
   the same injected jitter and a leader kill, ends in equal discrete
   state, in "pallas" mode, in "window" mode with a re-sort every 8 ticks
   (compared in agent-id order), and in "hashgrid" mode with the slot
   kernel and with the candidate kernel on a partially refreshed plan;
   and three fused PSO blocks from one state with the same injected
   uniforms on the CPU (plain version) and on the card (kernel);
   three NSGA-II generations (ZDT1, 512 x 30) with handed draws, each from
   the card's state on both devices: the children within the band of pow,
   the survivors, ranks and crowding from the card's parents and children
   equal (N1 on the card, the plain loop on the CPU);
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
   killed after tick 400, its chunks (a re-sort and 8 ticks) replayed from
   one captured CUDA graph; the window kernel must launch once per tick,
   the leader go 1048575 -> 1048574; the span before the kill pays the
   capture, the span after replays it alone (``window_replay``); a
   ``torch.profiler`` trace of 16 more ticks gives the device's busy time
   per tick and its heaviest kernels; from the final state the replayed
   rollout and the eager one (16 ticks, the leader killed, 21 more) must
   end equal in every field (``window_replay_vs_eager``); then the window
   kernel is timed beside its plain version at the final state, back to
   back and from a CUDA graph, with its bound, its warps' queue counts and
   its issue floor;
7. full width, "hashgrid": the JAX package's bounded-arena rows
   (benchmarks/bench_swarm_tpu.py:43 and :49, 65,536 agents spawned in
   +-250 m on the torus [-256, 256)^2, cap 16, rescue budget 1024, no
   formation), each for 1,000 ticks with the leader killed after tick 500,
   every full chunk of ``HASHGRID_CHUNK`` ticks replayed from one captured
   CUDA graph (the span before the kill pays the capture, the span after
   replays it alone):
   (a) station keeping (every agent holds its spawn position) through
   ``VectorSwarm``, with a ``torch.profiler`` trace of two more replayed
   chunks and the plan build's share of the tick (its own events and
   trace);
   (b) converging on [50, 0], which crowds cells past the cap, so the
   final state must show ``cap_overflow > 0`` and the rescue engaged for
   the whole budget;
   (c) the fast-mover regime of benchmarks/decompose_rebuild.py:222-233
   (``max_speed=5``, the candidates kernel on a Verlet plan, skin 1.5, cap
   24, neighbor cap 48, the partial refresh decided on the device, one
   flag read a chunk) through ``swarm_rollout(..., return_plan=True)``
   from the station scenario settled for 48 ticks, reporting the plan's
   rebuilds, rows rebuilt, cap overflow and the chunks rerun eagerly,
   with a trace of two more replayed chunks; the station's and the fast
   movers' capture is also timed alone in the warm process
   (``hashgrid_capture``).  Each run must launch its
   kernel once per tick and no other kernel, and the leader must go
   65535 -> 65534.  Then the slot kernel, its rescue included (at the
   station and converge final states), and the candidate kernel (at its
   final state, bit for bit) are held against their plain versions and
   timed beside them, back to back and from a CUDA graph (the slot kernel
   also without its rescue, and with its operands' gather: the whole
   function), with their bounds and their issue floors from the census
   of phase 2 (``grid_issue_floor``, ``candidate_issue_floor``).

8. full width, PSO: the JAX package's headline run (bench.py:27-29,158),
   ``PSO("rastrigin", n=1_048_576, dim=30, steps_per_kernel=64)`` for 2,560
   steps after a warm-up run of 64, timed with CUDA events: 40 launches of
   the fused kernel and of no other, gbest never rising from run to run,
   every position inside the domain; the kernel's uniforms of one step
   read back at full width (mean, variance, equal to the plain version's);
   then the kernel at the final state against its plain version over a
   whole 64-step launch, timed beside it, its bound and its issue floor;
9. full width, islands: 64 islands of 16,384 particles, Rastrigin-30D,
   1,280 steps, migration of 4 every 64 (benchmarks/bench_islands.py:18-39)
   through ``fused_island_run``: 20 launches of the island kernel, no
   island's gbest rising, the global best reported; then the island kernel
   against its plain version, timed beside it, its bound and its issue
   floor;
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
   version, timed beside it and its bound (B7, B9 and B11 also beside
   their issue floors; B7 in both its variants at the final state and at
   the initial one, where the pulse is 0 and every bat walks, the second
   variant held against the plain version at both; B9 with blocks of 512
   and 256 lanes; B11 in both its variants at the final state and with
   the iteration at 0, where the peers are read, its bound charging A's
   and C's draws to the contracting elements the plain version tallies,
   beside the bound charging every element).  Phase 3 holds the four
   kernels at small ragged shapes (several tiles for salp and whale, 1
   and k steps, draws handed in and made in the kernel; B7 at every D mod
   4 and in both variants; B9 at every block size, at D = 452 and with its
   winner at a block's first lane; B11 in both variants at their edges)
   and phase 4 three launches of each on the CPU and on the card;
12. full width, differential evolution, SHADE, the genetic algorithm and
   moth-flame optimization, each at its JAX bench's configuration,
   Rastrigin-30D at 1,048,576 in 256 tiles of 4,096 lanes
   (benchmarks/bench_de_1m.py:16-22, bench_shade_1m.py:16-22,
   bench_ga_1m.py:16-22, bench_mfo_1m.py:17-23 with t_max = 1,000): ``DE``
   for 1,024 steps in launches of 32, ``SHADE`` for 256 generations, one a
   launch, ``GA`` and ``MFO`` for 256 in launches of 8 (MFO re-sorting its
   flames every 8 launches and at the end), each after a warm-up launch,
   timed with CUDA events: the launch count, no incumbent (MFO: no best
   flame) rising, every position inside the domain; SHADE's generations
   replayed two at a time from one captured CUDA graph (the run pays the
   capture; 64 more replay it alone), its device busy share from a trace of
   16 more, and 9 generations replayed and eager from the final state equal
   in every field (``shade_replay_vs_eager``); then one launch of the kernel
   at the final state against its plain version, timed beside it and its
   bound (B14 also beside its issue floor, its four-stream floor, its time
   from a CUDA graph and with the generation read from the device; B10
   also beside its issue floor, and in both its variants at CR
   = 0.9 and at CR = 0, where no gene crosses and the first version reads
   no donor, the second variant held against the plain version too; B15
   beside its issue floor and in both its variants at the final state, with
   the clusters the card holds at once and its bound both ways: delta
   charged to the mutating elements, which its kernel skips elsewhere, and
   to every element; B16 also at a launch chained on that one's outputs,
   each beside its bound restated by what the function needs (the moving
   moth-steps and the moths stopped at the start, from the plain version's
   tallies) and the old one, its issue floor from the warps' steps on the
   data, and in its first version; and the MFO run replayed from its start
   under a trace: the kernel's device time a launch and the run's idle
   share).
   Phase 3 holds the four kernels at small ragged shapes (4 tiles or more,
   1 and k steps, GA at every k from 1 to 8, draws handed in and made in
   the kernel; DE past 32 genes, in its second variant at D = 200, and with
   windows longer than the tile; GA in clusters of 1, 4 and 16 blocks, of
   256 and 512 lanes, and in its second variant at a tile of 16,384) and
   phase 4 three launches of each on the CPU and on the card;
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
   version on the same inputs; B12 also beside its issue floor, and in
   both its variants at pa = 0.25 and at pa = 0, where no lane walks, the
   second variant held against the plain version too; B17 likewise at the
   final state and where every lane is probed, every fitness set to -1).
   Phase 3 holds the
   four kernels at small ragged shapes (4 tiles or more, an explicit tile,
   every k from 1 to the family's cap, draws handed in and made in the
   kernel, ABC at a small limit so that its scouts fire, PT with padded
   lanes and with the widest halo; cuckoo in clusters of 4 and 16 blocks,
   of 256 and 512 lanes, and in its second variant at a tile of 16,384;
   ABC at every D mod 4, with its lane shifts at the tile's edge, in
   clusters of 4 and 16 and in its second variant at a tile of 16,384 and
   at D = 227) and phase 4 three launches of each on the CPU and on the
   card.
14. full width, firefly and ACO at their JAX benches: ``Firefly("rastrigin",
   n=65_536, dim=30)`` for 8 generations and ``n=16_384`` for 32
   (benchmarks/bench_firefly_64k.py:17-24), each after a warm-up run: one
   launch of B19 a generation and no other kernel, the best never rising,
   every position inside the domain, then B19 at the 65,536 final state
   against its plain version within its band, each call twice and equal,
   timed beside it and its bound, with the row-tile visits of its
   fitness-sorted schedule against N ceil(N / 64), and again on that swarm
   drawn 50 times closer, where about half the pairs attract, and at the
   16,384 final state, where the source range splits to fill the card;
   ``ACO`` on 256 cities uniform in [0, 100)^2 with 1,024 ants for
   400 iterations (benchmarks/bench_aco.py:28-36) after a warm-up, the
   iterations replayed from the CUDA graph the warm-up captured (a
   colony's runs share one capture): one launch each of B20
   and B21 an iteration and no other kernel, the best never rising, every
   tour of the last iteration a permutation with its in-kernel lengths the
   ordered sums, tau symmetric (within 4 ulps / rho) and finite, the
   device's busy share from a trace of 16 more; runs of 1 and 5
   iterations (the capture included, and replayed) against the eager loop
   of as many steps; B20 and B21 at the final
   pheromone equal to their plain versions, timed beside them, their
   bounds, B20's issue floor and ``index_add_`` (B20, B21 and
   ``index_add_`` replayed from a CUDA graph, the device's time alone, and
   back to back, where the host paces them); then C = 512 and 1,024 for 50
   iterations (B20 and B21 timed at each) and the circle of 1,024 for 100
   (q0 = 0.1, elite = 4) with its gap to the known optimum
   (benchmarks/bench_aco_sweep.py:35-86).
   Phase 3 holds B19 at N = 1, 127, 300, 1,000 by D = 1, 5, 30, 100, in the
   rectangular form and with equal fitness, and its schedule's edges
   (fitness sorted, reversed, shuffled, ties across tiles, NaN and +-inf,
   signed zeros, each call twice and equal), and B20 and B21 at C = 2 to
   2,048 (past every edge of B20's team), A = 1 to 1,000, q0 = 0, 0.5 and
   1, draws handed in and made in the kernel, constant scores (every
   greedy step a tie), and B21 alone at
   C = 1, 2, 129 and 2,048, A = 1 to 20,000, on tours that are not
   permutations, one tour for every ant, rows of ~10,000 edges and 313
   bucketing chunks, each call twice and equal; phase 4 three firefly
   generations and three ACO iterations on the CPU and on the card with the
   same draws.

15. full width, the four families the JAX package runs with no kernel of
   its own: ``NSGA2("zdt1", n=512, dim=30)`` for 1,000 generations
   (benchmarks/bench_nsga2.py:14-16) after a warm-up of 50, timed with
   CUDA events: one N1 launch a generation and no other kernel (and one
   at the model's construction), generations/s, HV@(1.1, 1.1), IGD
   against the 256-point front and the front's size; every position in
   [0, 1] and every rank-0 member undominated; the device's busy share
   from a trace of 16 more generations; N1 at the first generation's
   parents and children and at the final ones', against its plain
   version, timed back to back and from a CUDA graph, beside the plain
   version and its bound.  Then ``CMAES("rosenbrock", dim=30)`` at the
   CLI's lambda 14 and at 64 (examples/optimizer_zoo.py:44), 500
   generations each; ``ES("rastrigin", n=256, dim=30)``, 500; and
   ``MAPElites("rastrigin", dim=6, bins=24, batch=512)``
   (examples/quality_diversity.py:44-45), 300; each after a warm-up run,
   timed with CUDA events in five chunks, no kernel of the port launched,
   the best never rising across the chunks (CMA-ES, ES), no cell's
   fitness rising and the coverage never falling (MAP-Elites).
16. full width, the protocol tick's last two options (Queue A items 9 and
   10): BASELINE config 4 (benchmarks/bench_allocation.py:22-32, 4,096
   agents from make_swarm(seed=0, spread=50), 4,096 tasks uniform in
   [-50, 50]^2) as an auction tick (``allocation_mode="auction"``,
   ``auction_every`` 10, the "pallas" separation) through ``swarm_tick``,
   100 ticks with an awarded winner killed at tick 60, each tick timed
   with CUDA events and split into re-solve ticks and the others, one N2
   launch a tick, one task per agent, every winner alive; N2 at the final
   tick's own values and at bench_auction.py's instances (uniform at
   1024^2 and 4096^2, its price war at 1024^2; 141, 314 and 398 rounds)
   against its plain version, timed back to back and from a CUDA graph,
   beside the plain version and its bound (the value rows the function
   needs: every row once, then the unseated agents' rows that are not all
   zero), with its rounds, zero rows, needed rows, cluster size and ms a
   round; every re-solve tick under the 100 ms period; the same tick in
   "window" separation (a re-sort every 10 ticks), 100 ticks with an
   awarded winner killed at tick 60, replayed from CUDA graphs and eager,
   every state field equal bit for bit, N2 once a tick; phase 4 the auction tick at 256 x 256 for
   20 ticks on the CPU and on the card, discrete state equal.  Then the field tick at
   decompose_rebuild.py:67-94, 287-294's station (65,536 agents, k_align
   0.3, k_coh 0.1) on the slots kernel in both deposits beside the field
   off: B2 once a tick, two runs bit for bit equal, the replayed rollout
   equal to the eager one across a kill, a trace of two replayed chunks,
   the deposit twice equal and within the band of the CPU's.

Each main-path run sets every kernel's launch count to 0 just before it
and reads the counts just after.

Earlier lines are JSON records of each phase.  The line before the last
holds ``{"kernels": [...]}``; the last is the ``{"ok": true, ...}`` line.
Any failure raises, so the script exits non-zero and prints no ok line.
It exits non-zero at once where no CUDA device is available.
"""

import contextlib
import functools
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
#   salp  27 = the follower (2), the clip (2), rastrigin (23); 3 = the
#         running best's test, the fit select, the offset (the best
#         position is needed for the launch's winner alone, so no select of
#         it is charged);
#   whale what every whale needs: 2 = the clip; 107 = the row call and two
#         uniforms (106), the branch test (1); then rastrigin once (23 and
#         1); the rest by branch (WOA_BRANCH_OPS), at the contracting
#         elements from the plain version's tally on the same inputs and
#         the spiralling ones (the rest), and the schedule a once a step.
ZOO_OPS = {"bat": (64, 134, 0, 0), "gwo": (198, 6, 23, 1),
           "salp": (27, 3, 0, 0), "woa": (2, 107, 23, 1)}
# The whale's branches: (per element, per whale) and step.  Contracting: A
# and C (3), the explore test and select (3), the contraction (5), A's and
# C's draws (56: two quarter calls and their uniforms); the peer's lane
# (5).  Spiralling: the spiral (5); l (2), e^{b l} (11), cos 2 pi l (17).
WOA_BRANCH_OPS = {"contract": (67, 5), "spiral": (5, 30)}
WOA_SCHEDULE_OPS = 6
# The whale's operations as counted before its kernel ran one branch a
# lane, both branches charged to every whale, A's and C's draws (56) at the
# contracting elements or at every one: the bounds recorded beside its own.
WOA_BOTH_BRANCHES_OPS, WOA_DRAW_OPS = (19, 147), 56
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
#         reductions (30), rastrigin's offset.  GA's bound charges the
#         work that depends on the data only where the function needs it,
#         from the plain version's tallies on the same inputs: delta and
#         stream 1's uniform (GA_DELTA_OPS, GA_UNIFORM_OPS) at the mutating
#         elements, stream 1's quarter call (GA_QUARTER_CALL_OPS) at the
#         elements of a group of four dimensions that holds one, and
#         stream 0's draw, beta and c1 or c2 (GA_CROSS_OPS) in the crossing
#         lanes (a draw of 28 is a quarter of a call of 100 and a uniform
#         of 3, as the gate's 103 is a call and its bits);
#   mfo   101 = the draw (28), l (3), the flame select (1), |flame - x| (2),
#         2^(b l log2 e) (20), cos 2 pi l (17), the spiral and the clip (5),
#         rastrigin (23), the flame update (2); 3 = the own test, the flame
#         fitness test and its select.  MFO's bound charges them at the
#         moving moth-steps the plain version tallies, less the flame
#         select (MFO_SELECT_OPS: a moth's flame is fixed over a launch, so
#         the function chooses it once a moth), and each moth at the fixed
#         point at the launch's start (MFO_STOPPED_OPS) its evaluation
#         (rastrigin, 23) and test (x == flame, |flame| <= hw: 2) an
#         element, the own test and the flame fitness test and select.
ROT_OPS = {"de": (58, 12), "shade": (63, 128), "ga": (207, 150),
           "mfo": (101, 3)}
MFO_SELECT_OPS = 1
MFO_STOPPED_OPS = (25, 3)
GA_DELTA_OPS = 43
GA_UNIFORM_OPS = 3
GA_QUARTER_CALL_OPS = 25
GA_CROSS_OPS = 28 + 44 + 6
# SHADE's generations profiled for the device's busy share.
SHADE_PROFILED = 16
SHADE_REPLAYED = 64     # generations replayed alone, after the run
SHADE_COMPARED = 9      # generations of the replayed and eager runs compared
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
#   hho     elem 26 = the final clip (3) and rastrigin (23), charged to
#           every lane but a diving one, whose new position is y or z (their
#           clips and evaluations are the dive's) or its x kept (whose
#           fitness the step before computed), save a diving lane that keeps
#           x at a launch's first step (an x and fitness from the caller);
#           lane 126 = the
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
# Short ACO runs timed against the eager loop, each on REPS new colonies.
ACO_SHORT, ACO_SHORT_REPS = (1, 5), 5
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
# The main kernels of the redesigned B20 and B5/B6, by their template
# arguments in the mangled name: the tours at one block of four cities a
# lane (C <= 512), sampling only, device draws; the PSO step at D mod 4 = 2
# (D = 30), rastrigin (objective 1), device draws.
TOURS_MAIN = "tours_kernelILi1ELi0ELb0E"
TOURS_MAIN_K2 = "tours_kernelILi2ELi0ELb0E"
PSO_MAIN = "pso_fused_kernelILi2ELi1ELb0E"
# The main kernels of the redesigned B10 and B12 (PR 12): D mod 4 = 2,
# rastrigin, device draws; and their second variants, the first versions.
DE_MAIN = "de_staged_kernelILi2ELi1ELb0E"
CUCKOO_MAIN = "cuckoo_cluster_kernelILi2ELi1ELb0E"
# The main kernels of the redesigned B7 and B17: D mod 4 = 2, rastrigin,
# device draws.
BAT_MAIN = "bat_step_kernelILi2ELi1ELb0E"
ABC_MAIN = "abc_cluster_kernelILi2ELi1ELb0E"
# The main kernels of the redesigned B18 and B13: D mod 4 = 2, rastrigin,
# device draws.
PT_MAIN = "pt_step_kernelILi2ELi1ELb0E"
HHO_MAIN = "hho_sorted_kernelILi2ELi1ELb0E"
# The main kernel of the redesigned B15: D mod 4 = 2, rastrigin, device
# draws.
GA_MAIN = "ga_cluster_kernelILi2ELi1ELb0E"
# The main kernel of the redesigned B16: D mod 4 = 2, rastrigin, device
# draws.
MFO_MAIN = "mfo_sorted_kernelILi2ELi1ELb0E"
# The main kernels of the redesigned B9 and B11: D mod 4 = 2, rastrigin,
# device draws.  B9 has no second variant (its design covers D <= 452).
SALP_MAIN = "salp_chain_kernelILi2ELi1ELb0E"
WOA_MAIN = "woa_sorted_kernelILi2ELi1ELb0E"
# The main kernels of the redesigned B14 (D mod 4 = 2, rastrigin, device
# draws) and B4 (the staged halo; the first version's global-memory kernel,
# kept for halos past the shared-memory budget, is its second variant).
SHADE_MAIN = "shade_staged_kernelILi2ELi1ELb0E"
WINDOW_MAIN = "window_staged_kernel"
# The main kernels of the redesigned B2 (R = 1, the 3x3 stencil of every
# hashgrid run here) and B3.
GRID_MAIN = "grid_sweep_kernelILi1E"
CAND_MAIN = "candidate_sweep_kernel"
# The redesigns with a second variant, a pair at a time: (family, source,
# main kernel); the second variants (the first versions, kept) and the
# geometry functions that reach them.
REDESIGNED = ((("de", "de_fused", DE_MAIN),
               ("cuckoo", "cuckoo_fused", CUCKOO_MAIN)),
              (("bat", "bat_fused", BAT_MAIN),
               ("abc", "abc_fused", ABC_MAIN)),
              (("pt", "tempering_fused", PT_MAIN),
               ("hho", "hho_fused", HHO_MAIN)),
              (("ga", "ga_fused", GA_MAIN),),
              (("salp", "salp_fused", SALP_MAIN),
               ("woa", "woa_fused", WOA_MAIN)),
              (("shade", "shade_fused", SHADE_MAIN),
               ("window", "window_separation", WINDOW_MAIN)),
              (("grid", "grid_separation", GRID_MAIN),
               ("cand", "candidate_sweep", CAND_MAIN)),
              (("mfo", "mfo_fused", MFO_MAIN),))
SECOND_VARIANTS = {"de": "de_global_kernel", "cuckoo": "cuckoo_global_kernel",
                   "bat": "bat_cand_tile_kernel", "abc": "abc_global_kernel",
                   "pt": "pt_cand_tile_kernel",
                   "hho": "hho_trial_tile_kernel",
                   "ga": "ga_global_kernel", "woa": "woa_lane_kernel",
                   "window": "window_global_kernel",
                   "mfo": "mfo_lane_kernel"}
SECOND_GEOMETRY = {"de": "global_geometry", "cuckoo": "global_geometry",
                   "bat": "candidate_tile_geometry",
                   "abc": "global_geometry",
                   "pt": "candidate_tile_geometry",
                   "hho": "trial_tile_geometry",
                   "ga": "global_geometry", "woa": "lane_geometry",
                   "mfo": "lane_geometry"}
H100_SMS = 132

# The auction: bench_auction.py's instances at flat eps 0.25 and
# BASELINE config 4 (bench_allocation.py:22-32, 4,096 agents x 4,096
# tasks) as an auction tick, auction_every 10, 100 ticks, an awarded
# winner killed at tick 60; the CPU comparison at 256 x 256, 20 ticks.
AUC_N, AUC_TICKS, AUC_EVERY, AUC_KILL_AT = 4096, 100, 10, 60
AUC_CMP_N, AUC_CMP_TICKS = 256, 20
AUC_EPS, AUC_MAX_ROUNDS = 0.25, 100_000
AUC_CFG = dict(allocation_mode="auction", auction_every=AUC_EVERY,
               auction_eps=AUC_EPS, separation_mode="pallas")
# The field tick: decompose_rebuild.py:67-94, 287-294 (65,536 agents at the
# station, hw 256, skin 0, cap 16, rescue 1,024, max_speed 1, sort_every 1,
# four tasks; k_align 0.3, k_coh 0.1), on the slots kernel (the auto
# backend on the card); the replay compared across a kill.
FIELD_TICKS, FIELD_CMP_TICKS = 200, (20, 13)
FIELD_CFG = dict(HG_BASE, max_speed=1.0, sort_every=1, k_align=0.3,
                 k_coh=0.1)
# Published peaks of one H100 SXM (NVIDIA's data sheet), at 700 W.
# NSGA-II at benchmarks/bench_nsga2.py:14-16 (ZDT1, population 512, D =
# 30, 1,000 generations); CMA-ES on Rosenbrock-30D at the CLI's lambda (4 +
# 3 ln 30 = 14) and at examples/optimizer_zoo.py:44's 64, 500 generations
# each; ES on Rastrigin-30D at the CLI's n = 256, 500; MAP-Elites at
# examples/quality_diversity.py:44-45 (Rastrigin-6D, 24 bins, batch 512),
# 300.  Each after a warm-up run.
MOO_N, MOO_DIM, MOO_STEPS, MOO_WARM = 512, 30, 1000, 50
N1_FEAS_TOL = 1e-4
CMA_DIM, CMA_LAMBDAS, CMA_STEPS, CMA_WARM = 30, (None, 64), 500, 20
ES_N, ES_DIM, ES_STEPS, ES_WARM = 256, 30, 500, 20
ME_DIM, ME_BINS, ME_BATCH, ME_STEPS, ME_WARM = 6, 24, 512, 300, 20
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
    """Least time for one window-kernel call on this card, by the work the
    function needs: each tested pair's cut (two differences, two products,
    a sum and the comparison with the squared cut: 6 operations) and, for a
    near pair only, the square root, the clamp and the force (dc^2, a
    division for k/dc^2, per axis a product, a division and a sum: 10),
    over the f32 peak; against positions and alive flags read once and the
    force written once over the memory rate."""
    n = pos.shape[0]
    tests, near = window_pair_counts(pos, alive)
    ops = tests * 6 + near * 10
    nbytes = n * (8 + 1) + n * 8
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), tests, near


def window_queue_counts(pos, alive):
    """Per warp of 32 receivers, the staged kernel's work on a Morton-sorted
    state at W = 16 (one group of 32 tests), as ``near_pair_queue`` counts
    it, on the card: ``(total, most, crowded, rounds, sums)`` int64 [warps]
    (near pairs, the most one lane holds, whether the warp adds lane by
    lane, the queue's rounds, the receivers' add-loop iterations)."""
    from distributed_swarm_algorithm_tpu_torch.ops.cuda.window_separation \
        import cut_threshold
    n = pos.shape[0]
    warps = -(-n // 32)
    cut = cut_threshold(R)
    nan = torch.full_like(pos, float("nan"))
    staged = torch.where(alive.bool()[:, None], pos, nan)
    count = torch.zeros(warps * 32, dtype=torch.int64, device=pos.device)
    ids = torch.arange(n, device=pos.device)
    for k in range(32):
        shift = k // 2 + 1
        j = ids + (shift if k & 1 else -shift)
        inside = (j >= 0) & (j < n)
        partner = staged[j.clamp(0, n - 1)]
        d = staged - partner
        s = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        count[:n] += (inside & (s < cut)).long()
    count = count.reshape(warps, 32)
    total, most = count.sum(1), count.max(1).values
    rounds = -(-total // 32)
    crowded = (total > 0) & (rounds >= most)
    off = torch.cumsum(count, 1) - count
    sums = torch.zeros_like(total)
    for r in range(32):
        lo = torch.clamp(off, min=32 * r)
        hi = torch.clamp(off + count, max=32 * r + 32)
        sums += torch.where(r < rounds, (hi - lo).clamp(min=0).max(1).values,
                            0)
    rounds = torch.where(crowded, 0, rounds)
    sums = torch.where(crowded, 0, sums)
    return total, most, crowded.long(), rounds, sums


def window_issue_floor(census, counts, span, clock_mhz):
    """B4's issue floor on one call from the staged kernel's SASS census and
    the warps' queue counts (``window_queue_counts``): per warp, what lies
    outside the group loop in the function's body (the prologue and the
    stores; the staging loop, ceil(span / 256) times), the group loop's own
    instructions (the 32 tests, the prefix sum, the choice) once, and its
    inner loops as often as the warp runs
    them: a crowded warp its own-pairs loop ``most`` times; a queued warp
    the queue's write loop ``most`` times, the rounds loop ``rounds`` times
    and the receivers' add loop ``sums`` times.  The inner loops are read
    in address order (own pairs, writes, rounds with the adds inside);
    None where the census does not show that shape."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if not loops:
        return None, None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = sorted((lp for lp in loops if lp is not outer
                    and outer[0] <= lp[0] and lp[1] <= outer[1]),
                   key=lambda lp: lp[0])
    before = [lp for lp in loops if lp[1] < outer[0]]
    if len(inner) != 4 or not (inner[2][0] <= inner[3][0]
                               and inner[3][1] <= inner[2][1]) or not before:
        return None, None
    own, writes, rounds_lp, adds = (lp[2] for lp in inner)
    staging = max(before, key=lambda lp: lp[2])[2]
    outside = body_instructions(census) - outer[2] - staging
    group = outer[2] - own - writes - rounds_lp
    total, most, crowded, rounds, sums = counts
    per_warp = (outside + staging * -(-span // 256) + group
                + crowded * most * own
                + (1 - crowded) * (most * writes + rounds * (rounds_lp - adds)
                                   + sums * adds))
    lanes = 32 * int(per_warp.sum())
    return (dict(outside=outside, staging=staging, group=group, own=own,
                 writes=writes, rounds=rounds_lp - adds, adds=adds,
                 instructions_per_receiver=lanes / (32 * total.numel())),
            issue_floor_ms(lanes, clock_mhz))


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
    check(out["bitwise_equal"], f"{label}: kernel differs from plain")
    check(bool((got[~alive.bool()] == 0).all()), f"{label}: dead agent moved")
    return got, out


@contextlib.contextmanager
def replaying(module, replay):
    """``module``'s runs replayed from CUDA graphs on the card (its own
    choice) or, with ``replay`` false, eager: the module's
    ``replays_graphs`` refusing every device for the block."""
    chosen = module.replays_graphs
    if not replay:
        module.replays_graphs = lambda device: False
    try:
        yield
    finally:
        module.replays_graphs = chosen


def window_replay_vs_eager(dsa, state, cfg, dev, ticks=(16, 21)):
    """The replayed window rollout against the eager one from the same
    full-width state, each on its own copy of the generator: ``ticks[0]``
    ticks, the leader killed, ``ticks[1]`` more; every state field equal
    bit for bit (the leaders included)."""
    from distributed_swarm_algorithm_tpu_torch.models import swarm
    from distributed_swarm_algorithm_tpu_torch.state import TENSOR_FIELDS
    outs, leaders = {}, {}
    for replay in (False, True):
        gen = torch.Generator(device=dev)
        gen.set_state(state.gen.get_state())
        st = state.replace(gen=gen)
        with replaying(swarm, replay):
            st = dsa.swarm_rollout(st, None, cfg, ticks[0])
            lid = int(dsa.current_leader(st)[0])
            st = dsa.kill(st, [lid])
            st = dsa.swarm_rollout(st, None, cfg, ticks[1])
        outs[replay] = st
        leaders[replay] = [lid, int(dsa.current_leader(st)[0])]
    unequal = [f for f in TENSOR_FIELDS
               if not torch.equal(getattr(outs[False], f),
                                  getattr(outs[True], f))]
    record(phase="window_replay_vs_eager", agents=state.n_agents,
           ticks=list(ticks), leaders=leaders[True],
           unequal_fields=unequal)
    check(not unequal and leaders[True] == leaders[False],
          f"the replayed window rollout differs from the eager one: "
          f"{unequal}")


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


def compare_grid_sweep(grid, pos, plan, budget, label):
    """Hold the slot kernel (its rescue included) against its plain version
    on the operands of ``plan`` at ``pos``.  Returns (record, sweep
    args)."""
    g, k = plan.g, plan.max_per_cell
    r = grid._stencil_radius(plan.cell_eff, R + plan.skin)
    ops = grid.sweep_operands(pos, plan)
    args = (ops, g, k, r, budget, K_SEP, R, EPS, plan.torus_hw)
    before = grid.LAUNCHES
    got = grid.grid_sweep_cuda(*args)
    torch.cuda.synchronize()
    check(grid.LAUNCHES == before + 1, f"{label}: launch not counted")
    want = grid.grid_sweep_plain(*args)
    scale = grid.grid_sweep_plain(*args, absolute=True)
    err = (got - want).abs()
    ratio = float((err / (REL_BAND * scale + ABS_BAND)).max())
    in_grid, rescued = grid._receivers(ops, g, k, budget)
    seen = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    seen[ops.order[in_grid | rescued].long()] = True
    out = dict(
        phase="kernel_vs_plain", kernel="grid_separation", shape=label,
        g=g, K=k, R=r, budget=budget, in_grid=int(in_grid.sum()),
        rescued=int(rescued.sum()), cap_overflow=int(plan.cap_overflow),
        max_abs_err=float(err.max()),
        bitwise_equal=bool(torch.equal(got, want)),
        max_abs_force=float(want.abs().max()),
        band=f"|kernel-plain| <= {REL_BAND}*sum|terms| + {ABS_BAND}",
        worst_share_of_band=ratio,
    )
    record(**out)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite force")
    check(ratio <= 1.0, f"{label}: kernel outside its band of plain")
    check(bool((got[~seen] == 0).all()),
          f"{label}: an agent outside the grid and the rescue got force")
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
    for label, cell, k, crowd, skin, budget in (
        ("n=600 R=1", 2.0, 8, 0, 0.0, 64),
        ("n=600 R=2 half cells", 1.0, 8, 0, 0.0, 64),
        ("n=600 R=1, 40 past the cap", 2.0, 8, 40, 0.0, 64),
        ("n=600 stale plan, skin 0.5", 1.5, 16, 0, 0.5, 64),
        ("n=600 R=1, 150 crowded past the budget", 2.0, 8, 150, 0.0, 16),
        ("n=600 R=2, 150 crowded past the budget", 1.0, 8, 150, 0.0, 16),
    ):
        pos, alive = hashgrid_swarm(600, 3, hw, crowd, dev)
        g = (int(2 * hw / (cell + skin)) // 16) * 16
        plan = hp.build_hashgrid_plan(pos, alive, hw, cell, k, g=g, skin=skin)
        if skin:
            gen = torch.Generator(device=dev).manual_seed(0)
            pos = pos + 0.34 * (torch.rand(pos.shape, generator=gen,
                                           device=dev) - 0.5)
        compare_grid_sweep(grid, pos, plan, budget, label)
    for label, crowd, k, skin, w, rk, refreshes in (
        ("n=800 skin 0", 0, 24, 0.0, 128, 48, 0),
        ("n=800 stale plan, skin 0.5", 0, 24, 0.5, 128, 48, 0),
        ("n=800 after 3 partial refreshes", 0, 24, 0.5, 128, 48, 3),
        ("n=800, truncated rows and receivers", 60, 8, 0.0, 32, 8, 0),
        ("n=800, cells of more than 32 receivers", 150, 64, 0.0, 384, 96,
         0),
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


def grid_bound_ms(grid, args):
    """Least time for one slot-kernel call: the sorted positions, keys,
    ranks and order, the two cell tables read once and the force written
    once (bytes), against each pair the sweep tests (two differences, two
    wraps, a product, a multiply-add, the cut: 8 operations) and each near
    pair's force (the clamp, rsqrt, three products, two products and two
    sums: 9).  Also the first version's bound, its slot planes (four g*g*K
    planes and the slot index) in place of the operands.  Returns (ms, by,
    tests, near, planes' ms)."""
    ops, g, k, r, budget = args[:5]
    n = ops.spos.shape[0]
    in_grid, rescued = grid._receivers(ops, g, k, budget)
    recv = torch.nonzero(in_grid | rescued).flatten()
    tx, ty = grid._sweep_terms(ops, *args[1:4], *args[5:], recv)
    _, pairs, rx, ry = grid._overflow_rescue_local(ops, *args[1:], recv,
                                                   in_grid)
    cells = grid._stencil_cells(ops.skey[recv].long(), g, r)
    cnt = (ops.bounds[cells + 1] - ops.bounds[cells]).clamp(max=k)
    tests = int(cnt.sum() - in_grid.sum()) + int(pairs.sum())
    near = int(((tx != 0) | (ty != 0)).sum() + ((rx != 0) | (ry != 0)).sum())
    ops_count = tests * 8 + near * 9
    nbytes = 8 * n + 3 * 4 * n + 4 * (2 * g * g + 1) + 8 * n
    planes = (4 * g * g * k * 4 + 4 * n) / PEAK_HBM_BYTES
    by_ops, by_bytes = ops_count / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes", tests, near,
            1e3 * planes)


def warp_max(values, warp, n_warps):
    """[n_warps] the most of ``values`` (int64) over each warp's lanes."""
    out = torch.zeros(n_warps, dtype=torch.int64, device=values.device)
    return out.scatter_reduce(0, warp, values, reduce="amax")


def issue_rate(clock_mhz):
    """Warp-instructions a millisecond: 132 SMs x 4 schedulers at the max
    SM clock."""
    return H100_SMS * 4 * clock_mhz * 1e3


def grid_issue_floor(grid, census, args, clock_mhz):
    """B2's issue floor from its SASS census (``grid_sweep_kernel<1>``):
    each warp of 32 sorted agents issues the body outside its loops once,
    each stencil cell's pass-1 loop (four partners a trip) as many times as
    its lane with the most in-grid partners there needs, and pass 2's loops
    likewise over the rescued runs of the crowded cells.  None where the
    census does not show the 9 + 2 loops expected."""
    ops, g, k, r, budget = args[:5]
    loops = sorted(census.get("loops") or [], key=lambda lp: lp[0])
    cells_n = (2 * r + 1) ** 2
    if r != 1 or len(loops) != cells_n + 2:
        return None
    pass1 = [lp[2] for lp in loops[:cells_n]]
    outer2, inner2 = max(loops[cells_n:], key=lambda lp: lp[2]), min(
        loops[cells_n:], key=lambda lp: lp[2])
    outside = body_instructions(census) - sum(pass1) - outer2[2]
    n = ops.spos.shape[0]
    n_warps = (n + 31) // 32
    in_grid, rescued = grid._receivers(ops, g, k, budget)
    seen = in_grid | rescued
    key = ops.skey.clamp(max=g * g - 1).long()
    cells = grid._stencil_cells(key, g, r)                      # [N, 9]
    cnt = ops.bounds[cells + 1] - ops.bounds[cells]
    trips1 = torch.where(seen[:, None], (cnt.clamp(max=k) + 3) // 4, 0)
    nres = torch.minimum(cnt - k, budget - ops.ovf_before[cells]).clamp(
        min=0)
    crowded = seen[:, None] & (cnt > k)
    trips2 = torch.where(crowded, (nres + 3) // 4, 0)
    warp = torch.arange(n, device=cnt.device) // 32
    instr = int(warp_max(seen.long(), warp, n_warps).sum()) * outside
    for t in range(cells_n):
        instr += int(warp_max(trips1[:, t].long(), warp, n_warps).sum()
                     ) * pass1[t]
        instr += int(warp_max(trips2[:, t].long(), warp, n_warps).sum()
                     ) * inner2[2]
        instr += int(warp_max(crowded[:, t].long(), warp, n_warps).sum()
                     ) * (outer2[2] - inner2[2])
    return dict(outside=outside, pass1_loops=pass1,
                pass2_loops=[outer2[2], inner2[2]],
                warp_instructions=instr,
                issue_floor_ms=instr / issue_rate(clock_mhz))


def candidate_work(cand, pos, plan):
    """Per receiver slot of the tables (cell, valid candidates, near pairs)
    and the totals (tests, near pairs, valid entries)."""
    n = pos.shape[0]
    valid_c = (plan.cand < n).sum(1)
    valid_r = (plan.recv < n).sum(1)
    agents = plan.recv.reshape(-1)
    cells = torch.arange(plan.recv.shape[0], device=pos.device
                         ).repeat_interleave(plan.recv.shape[1])
    keep = agents < n
    rows = plan.cand[cells[keep]]
    npos = pos[rows.clamp(max=n - 1).long()]
    d = pos[agents[keep].long()][:, None, :] - npos
    d = torch.where(d >= plan.torus_hw, d - 2 * plan.torus_hw,
                    torch.where(d < -plan.torus_hw, d + 2 * plan.torus_hw, d))
    near = ((rows < n) & (d.norm(dim=-1) < R)
            & (rows != agents[keep][:, None])).sum(1)
    tests = int((valid_r * (valid_c - 1).clamp(min=0)).sum())
    entries = int(valid_c[valid_r > 0].sum() + valid_r.sum())
    return cells[keep], valid_c, valid_r, near, tests, int(near.sum()), \
        entries


def candidate_bound_ms(cand, pos, plan):
    """Least time for one candidate-kernel call: the valid entries of the
    tables that this data needs (the candidate rows of cells with
    receivers, the receivers), the positions read and the force written
    once (bytes), against each (receiver, candidate) test (two
    differences, two wraps, a product, a multiply-add, the cut: 8
    operations; the square root of the first version's test is no longer
    needed) and each near pair's force (the square root, the clamp, two
    products, a division, two products, two sums: 9).  Also the first
    version's bound, the whole padded tables once.  Returns (ms, by,
    tests, near, tables' ms)."""
    n = pos.shape[0]
    _, _, _, _, tests, near, entries = candidate_work(cand, pos, plan)
    ops = tests * 8 + near * 9
    nbytes = 4 * entries + 8 * n + 8 * n
    tables = (4 * (plan.cand.numel() + plan.recv.numel()) + 16 * n
              ) / PEAK_HBM_BYTES
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), tests, near, \
        1e3 * tables


def candidate_issue_floor(cand, census, pos, plan, clock_mhz):
    """B3's issue floor from its SASS census: each warp (a block of G
    cells) issues the body outside its loops once, and per round of 32
    receivers its sweep: the test loop (four candidates a trip) as often
    as its lane with the most candidates needs, the near loop as often as
    its lane with the most near pairs.  None where the census does not
    show the sweep's two innermost loops."""
    loops = sorted(census.get("loops") or [], key=lambda lp: lp[0])
    if not loops:
        return None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inside = [lp for lp in loops if outer[0] <= lp[0] and lp[1] <= outer[1]
              and lp is not outer]
    innermost = [lp for lp in inside if not any(
        o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in inside)]
    if len(innermost) != 2:
        return None
    test, near_loop = innermost
    seg = [lp for lp in inside if lp not in innermost]
    seg_len = seg[0][2] if seg else test[2] + near_loop[2]
    outside = body_instructions(census) - sum(lp[2] for lp in loops
                                              if lp[1] < outer[0]
                                              or lp[0] > outer[1]) - outer[2]
    G = cand.cells_per_warp(plan.cand.shape[1])
    cells, valid_c, valid_r, near, _, _, _ = candidate_work(cand, pos, plan)
    m = valid_c[cells]
    warp = cells // G
    # A receiver's place in its warp's flattened list: the receivers of
    # the warp's earlier cells, then its slot in its own cell.
    first_cell = warp * G
    before = torch.cumsum(valid_r, 0) - valid_r
    slot = torch.arange(cells.shape[0], device=pos.device) - (
        torch.cumsum(valid_r, 0)[cells] - valid_r[cells])
    place = before[cells] - before[first_cell] + slot
    n_warps = (plan.cand.shape[0] + G - 1) // G
    rounds = int(place.max()) // 32 + 1
    key = warp * rounds + place // 32
    trips = warp_max(((m + 3) // 4).long(), key, n_warps * rounds)
    nears = warp_max(near.long(), key, n_warps * rounds)
    busy = warp_max(torch.ones_like(key), key, n_warps * rounds)
    warps_busy = int(warp_max(torch.ones_like(warp), warp, n_warps).sum())
    instr = (warps_busy * outside + int(busy.sum()) * (
        outer[2] - seg_len + seg_len - test[2] - near_loop[2])
        + int(trips.sum()) * test[2] + int(nears.sum()) * near_loop[2])
    return dict(outside=outside, test_loop=test[2], near_loop=near_loop[2],
                round_overhead=outer[2] - test[2] - near_loop[2],
                warp_instructions=instr,
                issue_floor_ms=instr / issue_rate(clock_mhz))


def capture_cost_ms(dsa, swm, state, cfg, chunk):
    """(ms of a rollout of one chunk that captures it, ms of the same
    rollout replaying the kept capture) in this warm process: their
    difference is the capture's own cost, apart from a process's
    first-use costs."""
    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        dsa.swarm_rollout(state, None, cfg, chunk)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    swm._chunk = None
    return once(), once()


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


@functools.lru_cache(maxsize=None)
def sass_dump(tool, library):
    """(return code, stdout, stderr) of ``cuobjdump -sass`` on a library,
    once a library: a redesign's census reads its main kernel and its
    second variant from one dump."""
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=120)
    return out.returncode, out.stdout, out.stderr


def sass_census(build, name, function):
    """Opcode counts of the SASS of the first function of ``name``'s library
    whose mangled name holds ``function`` (``cuobjdump -sass``), and its
    loops: each backward branch's [target, branch] address range with the
    number of instructions in it (16 bytes an instruction), of its 32-bit
    products (``IMAD.HI``, ``IMAD.WIDE``: the Philox rounds') and whether
    its branch is predicated (an unconditional branch back is a divergence
    handler's return into a loop, not a loop), outermost first; the
    addresses of its barriers (``BAR``); and its jumps, each [address,
    target or None, whether predicated] (``BRA``, ``BRX``, ``JMP``,
    ``EXIT``, ``RET``); or why there are none."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {"error": "cuobjdump not found"}
    returncode, stdout, stderr = sass_dump(tool,
                                           str(build.library_path(name)))
    if returncode != 0:
        return {"error": stderr[-300:]}
    return parse_sass(stdout, name, function)


def parse_sass(stdout, name, function):
    """``sass_census`` of ``function`` in ``cuobjdump -sass`` output."""
    import re
    counts, inside, loops, products, barriers = {}, False, [], [], []
    jumps, exits = [], []
    for line in stdout.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = function in line
            continue
        if not inside:
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(2)
            key = next((k for k in ("IMAD.WIDE", "IMAD.HI", "IMAD.MOV",
                                    "IMAD.SHL", "IMAD")
                        if op.startswith(k)), op.split(".")[0])
            counts[key] = counts.get(key, 0) + 1
            at = int(m.group(1), 16)
            if key in ("IMAD.HI", "IMAD.WIDE"):
                products.append(at)
            if key == "BAR":
                barriers.append(at)
            if key == "EXIT":
                exits.append(at)
            predicated = int(bool(re.search(r"\*/\s+@", line)))
            b = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", line)
            if key in ("BRA", "BRX", "JMP", "EXIT", "RET"):
                jumps.append([at, int(b.group(1), 16) if b else None,
                              predicated])
            if b and int(b.group(1), 16) < at:
                start = int(b.group(1), 16)
                loops.append([start, at, (at - start) // 16 + 1,
                              predicated])
    if not counts:
        return {"error": f"no function {function} in {name}"}
    for lp in loops:
        lp.insert(3, sum(lp[0] <= at <= lp[1] for at in products))
    loops.sort(key=lambda lp: (lp[0], -lp[1]))
    return dict(function=function, total=sum(counts.values()),
                opcodes=dict(sorted(counts.items(), key=lambda kv: -kv[1])),
                loops=loops, barriers=barriers, jumps=jumps, exits=exits)


def body_instructions(census):
    """Instructions of a census's function up to its last ``EXIT``: what
    follows are the subroutines of the IEEE division's and square root's
    slow paths, which in-range operands never call (all of them where
    the census lists no ``EXIT``)."""
    exits = census.get("exits") or []
    return exits[-1] // 16 + 1 if exits else census["total"]


def exclusive_code(census, loop, head):
    """The instructions of ``loop`` (a census loop) that only the path
    through address ``head`` runs: in the loop's control flow, entered at
    its start (each instruction to the next unless it is an unconditional
    jump, each branch to its target inside the loop, no edge back to the
    start), the instructions dominated by that path's first one, the
    earliest instruction that dominates ``head`` and not the branch back;
    or None."""
    start, end = loop[0], loop[1]
    jumps = {j[0]: j for j in census.get("jumps") or []}

    def successors(at):
        j = jumps.get(at)
        out = [at + 16] if j is None or j[2] else []
        if j is not None and j[1] is not None:
            out.append(j[1])
        return [b for b in out if start < b <= end]

    def reached(without):
        seen, todo = {start}, [start]
        while todo:
            for b in successors(todo.pop()):
                if b != without and b not in seen:
                    seen.add(b)
                    todo.append(b)
        return seen

    every = reached(None)
    cut = {x: every - reached(x) for x in every if x != start}
    first = [x for x, lost in cut.items()
             if head in lost and end not in lost and x != head]
    first.append(head)
    best = max(first, key=lambda x: len(cut[x]))
    return len(cut[best])


def step_loop(census):
    """(instructions of the outermost loop, instructions of the largest
    loop inside it, the other inner loops' instructions) of a census: a
    step loop and its chunk loop."""
    loops = census.get("loops") or []
    if not loops:
        return None, None, None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp is not outer
             and outer[0] <= lp[0] and lp[1] <= outer[1]]
    top = max(inner, key=lambda lp: lp[2]) if inner else None
    rest = sum(lp[2] for lp in inner if lp is not top)
    return outer[2], None if top is None else top[2], rest


def issue_floor_ms(lane_instructions, clock_mhz):
    """Least time to issue ``lane_instructions`` (a warp issues 32 lanes'
    instruction at once; each of an SM's 4 schedulers one warp-instruction
    a clock) on H100_SMS SMs at ``clock_mhz``."""
    return 1e3 * lane_instructions / (H100_SMS * 128 * clock_mhz * 1e6)


def tours_issue_floor(census, tours_shape, lanes, clock_mhz):
    """B20's issue floor on one call: the step loop's instructions (the
    main kernel's SASS, all of a step's work: the next step's draws, the
    scores, the reductions, the exchange) a lane-step, times the team's
    ``lanes``, the ants and the C - 1 steps."""
    a, c = tours_shape
    per_step, _, _ = step_loop(census)
    if per_step is None:
        return None, None
    return per_step, issue_floor_ms(per_step * lanes * a * (c - 1),
                                    clock_mhz)


def pso_issue_floor(census, n, d, k_steps, clock_mhz):
    """B5's (and B6's) issue floor on one launch: the chunk loop's
    instructions (four dimensions: the Philox pair, the uniforms, the
    updates, the folded objective terms) D // 4 times a step, plus what
    the step loop holds outside its inner loops (the last D mod 4
    dimensions, the objective's close and the pbest test; the pbest copy,
    taken only where a particle improves, left out), over N particles and
    k steps."""
    outer, chunk, rest = step_loop(census)
    if chunk is None:
        return None, None
    per_step = (d // 4) * chunk + (outer - chunk - rest)
    return per_step / d, issue_floor_ms(per_step * n * k_steps, clock_mhz)


def ptxas_of(log, function):
    """The lines ptxas wrote for the kernel whose mangled name holds
    ``function`` (its registers and spills) in a build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and function in line:
            return [ln.strip() for ln in lines[i + 1:i + 4]
                    if "registers" in ln or "spill" in ln]
    return []


def inner_loops(census):
    """(instructions of the outermost loop, the instructions of each loop
    inside it, largest first) of a census."""
    loops = census.get("loops") or []
    if not loops:
        return None, []
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    return outer[2], sorted((lp[2] for lp in loops if lp is not outer
                             and outer[0] <= lp[0] and lp[1] <= outer[1]),
                            reverse=True)


# B10's issue floor on one launch, counted as B5's: the gene chunk loop D //
# 4 times a step and the rest of the step loop (the last D mod 4 genes, the
# objective's close, the acceptance test), the acceptance's rewrite left
# out.
de_issue_floor = pso_issue_floor


def cuckoo_issue_floor(census, n, d, k_steps, clock_mhz):
    """B12's issue floor on one launch: a generation's two chunk loops
    (the candidate's and the walk's, four dimensions each; every warp walks,
    since nearly every warp holds an abandoned lane) D // 4 times, plus
    what the generation loop holds outside its inner loops (the last D mod
    4 dimensions, the objective's close, the egg's and the abandonment's
    tests), the egg's copy (taken only where an egg wins) left out."""
    outer, inner = inner_loops(census)
    if len(inner) < 2:
        return None, None
    per_step = (d // 4) * (inner[0] + inner[1]) + outer - sum(inner)
    return per_step / d, issue_floor_ms(per_step * n * k_steps, clock_mhz)


def ga_issue_floor(census, n, d, k_steps, clock_mhz):
    """B15's issue floor on one launch: the chunk loop (unrolled twice:
    eight dimensions, each the parents' loads, the Philox pair and stream
    2, the uniforms, beta and delta, SBX, the mutation and the clip, the
    folded term; the loop inside the generation loop with the most 32-bit
    products) (D // 4) // 2 times a generation, plus what the generation
    loop holds outside its inner loops (an odd chunk, the last D mod 4
    dimensions, the gate, the tournaments, the objective's close, the
    reductions and the barriers), the elite's copy (one warp a cluster)
    left out; delta counted at every warp-element, though a warp with no
    mutating lane skips it.  Only predicated branches back make loops, as
    in ``abc_issue_floor``."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if not loops:
        return None, None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp is not outer
             and outer[0] <= lp[0] and lp[1] <= outer[1]]
    if not inner:
        return None, None
    chunk = max(inner, key=lambda lp: (lp[3], lp[2]))[2]
    per_step = (d // 4) // 2 * chunk + outer[2] - sum(lp[2] for lp in inner)
    return per_step / d, issue_floor_ms(per_step * n * k_steps, clock_mhz)


def bat_issue_floor(census, n, d, k_steps, clock_mhz):
    """B7's issue floor on one launch: the chunk loop's instructions (four
    dimensions: a Philox group, the walk and the flight, the folded
    objective terms) D // 4 - 1 times a step (the first chunk, drawn with
    the row by the Philox pair, lies outside the loop), plus what the step
    loop holds outside its inner loops (the first and the last D mod 4
    dimensions, the row's draw, the objective's close, the acceptance test
    and its updates), the acceptance's rewrite loop (taken only where a bat
    is accepted) left out, over N bats and k steps."""
    outer, chunk, rest = step_loop(census)
    if chunk is None:
        return None, None
    per_step = (d // 4 - 1) * chunk + (outer - chunk - rest)
    return per_step / d, issue_floor_ms(per_step * n * k_steps, clock_mhz)


def abc_issue_floor(census, n, d, k_steps, clock_mhz):
    """B17's issue floor on one launch: a cycle's two evaluation chunk
    loops (the employed and the onlooker candidate, four dimensions each,
    the two largest loops inside the cycle loop with no 32-bit product;
    every warp runs the onlooker's, since nearly every warp holds a probed
    lane) D // 4 times, plus what the cycle loop holds outside its inner
    loops (the row draws, the partner's coordinate, the last D mod 4
    dimensions, the closes, the tests, the reductions and the barriers),
    the scout's loop (its Philox groups; taken only where a lane is
    exhausted) left out.  Only predicated branches back make loops: the
    cluster barriers' and shuffles' divergence handlers jump back
    unconditionally."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if not loops:
        return None, None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp is not outer
             and outer[0] <= lp[0] and lp[1] <= outer[1]]
    chunks = sorted((lp[2] for lp in inner if lp[3] == 0), reverse=True)
    if len(chunks) < 2:
        return None, None
    per_step = ((d // 4) * (chunks[0] + chunks[1]) + outer[2]
                - sum(lp[2] for lp in inner))
    return per_step / d, issue_floor_ms(per_step * n * k_steps, clock_mhz)


# B18's issue floor on one launch, counted as B5's: the chunk loop (four
# dimensions: the Philox pair, the cosine halves, the moves, the folded
# terms) D // 4 times a step and the rest of the step loop (the last D mod
# 4 dimensions, the row, the acceptance, the warp's running best, a round's
# test, counted at every step), the rounds' swap loop and the running
# best's copy left out; over the threads of the launch, halos included.
pt_issue_floor = pso_issue_floor


def pt_threads(n, d, k_steps, swap_every, tile_n):
    """Threads of one B18 launch as its geometry places them: a window a
    block, ceil(tile_n / own) blocks a tile."""
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        tempering_fused,
    )
    geo = tempering_fused.pt_geometry(
        d, tempering_fused.halo(k_steps, swap_every))
    return (n // tile_n) * -(-tile_n // geo.own) * geo.window


def hho_issue_floor(census, n, d, k_steps, clock_mhz, counts):
    """B13's issue floor on one launch, every lane advanced in a warp of
    its own branch (the class boundaries' divergence left out).  A lane
    issues its branch's chunk loop (four dimensions) D / 4 times, its last
    D mod 4 dimensions counted at the loop's rate: the dive's loop is the
    one inside the step loop with the most 32-bit products, the exploring
    lanes' the mean of the two with fewer (at a perch, below the mean), the
    besiege's the largest with none; the lanes of each branch come from the
    plain version's tally of the launch (exploring and diving lanes; the
    rest besiege).  Every lane also issues what the step loop holds outside
    its inner loops (the row, the class, the sort, the closes, the dive's
    pick) less the four branches' last D mod 4 dimensions, (D mod 4) / 4
    of each chunk loop; the dive's rewrites of y or z and the first step's
    evaluation of a kept x are left out."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if not loops:
        return None, None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp is not outer
             and outer[0] <= lp[0] and lp[1] <= outer[1]]
    drawing = sorted((lp for lp in inner if lp[3] > 0),
                     key=lambda lp: -lp[3])
    plain = [lp[2] for lp in inner if lp[3] == 0]
    if len(drawing) < 3 or not plain:
        return None, None
    dive, explore = drawing[0][2], (drawing[1][2] + drawing[2][2]) / 2
    besiege = max(plain)
    total = lambda key: int(sum(int(v) for v in counts.get(key, [])))  # noqa
    lanes_explore, lanes_dive = total("explore"), total("dive")
    lanes_besiege = k_steps * n - lanes_explore - lanes_dive
    tails = (d % 4) / 4 * (dive + 2 * explore + besiege)
    common = outer[2] - sum(lp[2] for lp in inner) - tails
    instructions = (k_steps * n * common + d / 4 * (
        lanes_explore * explore + lanes_besiege * besiege
        + lanes_dive * dive))
    return (instructions / (k_steps * n * d),
            issue_floor_ms(instructions, clock_mhz))


def salp_issue_floor(census, n, d, k_steps, clock_mhz, lanes):
    """B9's issue floor on one launch.  The step loop (the outermost loop
    that holds a barrier) branches to one of two paths: every warp's but
    the leader's, whose chunk loop (four dimensions: the column's loads,
    the shuffles, the published slot, the means and clips, the stores, the
    folded terms) is the step loop's largest inner loop with no 32-bit
    product, and the leader warp's, whose chunk loop (its Philox) has the
    most.  A warp issues its own path's chunk loop D // 4 times a step and
    the rest of the step loop less the other path's own code
    (``exclusive_code``): its last D mod 4 dimensions, the close, the
    running best, the barrier.  The other warps are counted over their
    lanes, halo threads and the half warp included (n / lanes blocks of
    ceil((lanes + 16) / 32) warps), the leader's once; k steps.  The
    winner's replay after the step loop is left out.  Only predicated
    branches back make loops, as in ``abc_issue_floor``."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    bars = census.get("barriers") or []
    holding = [lp for lp in loops
               if any(lp[0] <= at <= lp[1] for at in bars)]
    steps = [lp for lp in holding
             if not any(o is not lp and o[0] <= lp[0] and lp[1] <= o[1]
                        for o in holding)]
    if len(steps) != 1:
        return None, None
    step = steps[0]
    inner = [lp for lp in loops if lp is not step
             and step[0] <= lp[0] and lp[1] <= step[1]]
    plain = [lp for lp in inner if lp[3] == 0]
    drawing = [lp for lp in inner if lp[3] > 0]
    if not plain or not drawing:
        return None, None
    plain = max(plain, key=lambda lp: lp[2])
    lead = max(drawing, key=lambda lp: lp[3])
    only_plain = exclusive_code(census, step, plain[0])
    only_lead = exclusive_code(census, step, lead[0])
    per_other = (d // 4 - 1) * plain[2] + step[2] - only_lead
    per_lead = (d // 4 - 1) * lead[2] + step[2] - only_plain
    threads = (n // lanes) * 32 * -(-(lanes + 16) // 32)
    instructions = k_steps * (per_other * (threads - 32) + per_lead * 32)
    return (instructions / (n * d * k_steps),
            issue_floor_ms(instructions, clock_mhz),
            dict(step_loop=step[2], chunk_loops=[plain[2], lead[2]],
                 only_other=only_plain, only_leader=only_lead,
                 per_warp_step=[per_other, per_lead]))


def woa_issue_floor(census, n, d, k_steps, clock_mhz, contracting):
    """B11's issue floor on one launch, every lane advanced in a warp of
    its own branch (the class boundary's divergence left out).  A lane
    issues its branch's chunk loop (four dimensions) D / 4 times, its last
    D mod 4 dimensions counted at the loop's rate: the contracting lanes'
    loop is the one inside the step loop with the most 32-bit products
    (the Philox pair), the spiralling lanes' the largest with none; the
    contracting lane-steps come from the plain version's tally
    (``contracting`` elements over D), the rest spiral.  Every lane also
    issues what the step loop holds outside its inner loops (the row, the
    class, the sort, the spiral's e^{b l} and cos 2 pi l, the Philox pair's
    lane and step products) less the two branches' last D mod 4 dimensions,
    and once a launch the last pass (the loop after the step loop: the
    positions written out, the folded terms) D // 4 times."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if not loops:
        return None, None
    outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp is not outer
             and outer[0] <= lp[0] and lp[1] <= outer[1]]
    drawing = [lp for lp in inner if lp[3] > 0]
    plain = [lp[2] for lp in inner if lp[3] == 0]
    after = [lp[2] for lp in loops if lp[0] > outer[1]]
    if not drawing or not plain or not after:
        return None, None
    contract = max(drawing, key=lambda lp: lp[3])[2]
    spiral = max(plain)
    lanes_contract = contracting / d
    lanes_spiral = k_steps * n - lanes_contract
    tails = (d % 4) / 4 * (contract + spiral)
    common = outer[2] - sum(lp[2] for lp in inner) - tails
    instructions = (k_steps * n * common + d / 4 * (
        lanes_contract * contract + lanes_spiral * spiral)
        + n * (d // 4) * max(after))
    return (instructions / (k_steps * n * d),
            issue_floor_ms(instructions, clock_mhz))


@contextlib.contextmanager
def geometry(mod, name, fn):
    """``mod``'s wrapper with ``fn`` in place of its geometry function
    ``name``: how a kernel's second variant is run at the main path's
    shape."""
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def variant_times(fam, mod, kernel, settings, k_steps, smi, knob=None):
    """A redesigned kernel at the main path's shape in both variants (the
    second, the first version, reached with the module's second-variant
    geometry function in place of its geometry function): device
    milliseconds at each setting ``(label, args, keywords, want)``, and the
    second variant against the plain version where ``want`` is given.
    B10 and B12 at the run's CR or pa and at 0 (no gene crosses, no lane
    walks); B15 at the final state; B7 at the final state and at the
    initial one (pulse 0: every bat walks); B17 at the final state and
    where every lane is probed; B18
    at the final state and at swap_every = 1 (the widest halo); B13 at the
    final state (besiege and dive) and at the first launch's t0 = 0 (three
    classes)."""
    name = f"{fam}_geometry"
    fn = getattr(mod, SECOND_GEOMETRY[fam])
    out = dict(phase=f"{fam}_variants", shape=[ZOO_DIM, ZOO_N],
               k_steps=k_steps, knob=knob, smi=smi, second_variant_vs_plain={})
    for variant, ctx in ((0, contextlib.nullcontext()),
                         (1, geometry(mod, name, fn))):
        with ctx:
            for label, args, kw, want in settings:
                if variant == 1 and want is not None:
                    out["second_variant_vs_plain"][label] = compare_family(
                        fam, "rastrigin", f"main path, {label}, second "
                        "variant", kernel(*args, **kw), want, k_steps)
                out[f"variant{variant}_{label}_ms"] = cuda_ms(
                    lambda: kernel(*args, **kw), 10)
    record(**out)


def knob_settings(fam, args, step_kw, want):
    """B10's and B12's settings for ``variant_times``: the run's CR or pa,
    held against the plain version, and 0."""
    knob, run_value = {"de": ("cr", 0.9), "cuckoo": ("pa", 0.25)}[fam]
    return knob, [(f"{knob}{run_value}", args,
                   dict(step_kw, **{knob: run_value}), want),
                  (f"{knob}0.0", args, dict(step_kw, **{knob: 0.0}), None)]


def redesigned_census(build, census, group):
    """A pair of rule 2's redesigns (``REDESIGNED``): the census of each
    main kernel, whose step loop gives its issue floor in the timing phases
    (into ``census``), with its registers and spills, and of its second
    variant."""
    phase = "redesigned_builds_" + "_".join(fam for fam, _, _ in group)
    for fam, source, function in group:
        census[fam] = sass_census(build, source, function)
        log = build.build_log(source)
        census[f"{fam}_ptxas"] = ptxas_of(log, function)
        second = SECOND_VARIANTS.get(fam)
        record(phase=phase, kernel=function,
               ptxas=census[f"{fam}_ptxas"], census=census[fam],
               loops_inside_the_step_loop=inner_loops(census[fam]),
               second_variant=second,
               second_variant_ptxas=second and ptxas_of(log, second),
               second_variant_census=second and sass_census(build, source,
                                                            second))


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
    ragged shapes, 1 and k steps, both rng modes, several tiles; B7 at
    every D mod 4, with no chunk of four, at the widest main variant, in its
    first version past it and, by its geometry, at D = 30; B9 at every
    block size and its envelope's edge, its winner at a block's first lane;
    B11's variants at their edges."""
    cases = [
        ("bat", "rastrigin", 300, 8, 1, "host", None),
        ("bat", "sphere", 1000, 30, 8, "device", None),
        ("bat", "michalewicz", 77, 1, 8, "device", None),
        ("bat", "ackley", 515, 30, 8, "device", None),
        # B7 at every D mod 4, without a chunk of four, at its widest main
        # variant and in its first version past it (D = 227, 605).
        ("bat", "rastrigin", 3000, 4, 8, "device", None),
        ("bat", "griewank", 3000, 5, 8, "device", None),
        ("bat", "schwefel", 3000, 31, 8, "device", None),
        ("bat", "levy", 700, 2, 8, "device", None),
        ("bat", "styblinski_tang", 300, 226, 3, "device", None),
        ("bat", "rastrigin", 300, 227, 3, "device", None),
        ("bat", "zakharov", 100, 605, 2, "device", None),
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
        # B9's blocks of 512, 256 and 128 lanes over several tiles, every D
        # mod 4, and its envelope's edge (D = 452, 64 lanes); B11's sorted
        # variant with a half-empty block, at its last D (224) and the first
        # version past it.
        ("salp", "rastrigin", 8192, 30, 16, "device", 4096),
        ("salp", "sphere", 2048, 30, 1, "host", 512),
        ("salp", "levy", 1024, 31, 16, "device", 256),
        ("salp", "griewank", 1024, 5, 16, "device", 1024),
        ("salp", "michalewicz", 512, 4, 16, "device", 128),
        ("salp", "schwefel", 2048, 452, 16, "device", 512),
        ("woa", "rastrigin", 4096, 30, 8, "device", 1024),
        ("woa", "griewank", 4096, 4, 1, "host", 1024),
        ("woa", "rosenbrock", 384, 31, 8, "device", 128),
        ("woa", "schwefel", 1024, 224, 8, "device", 256),
        ("woa", "styblinski_tang", 1024, 225, 8, "device", 256),
    ]
    for fam, name, n, d, k, rng, tile_n in cases:
        kernel, plain, args, kw = zoo_case(mods, pf, fam, name, n, d, k, rng,
                                           dev, tile_n)
        before = mods[fam].LAUNCHES
        got = kernel(*args, **kw)
        check(mods[fam].LAUNCHES == before + 1, "launch not counted")
        compare_family(fam, name, f"n={n} D={d} k={k} rng={rng} "
                       f"tile_n={tile_n}", got, plain(*args, **kw), k)
    # B9's winner at a block's first lane with its best at the launch's
    # start (its window in the block before): the replay of 0 steps.
    kernel, plain, args, kw = zoo_case(mods, pf, "salp", "rastrigin", 4096,
                                       30, 16, "device", dev, 1024)
    args[3] = args[3].clone()
    args[3][0, 1536] = -1.0
    compare_family("salp", "rastrigin", "n=4096 D=30 k=16, the winner at a "
                   "block's first lane, step 0", kernel(*args, **kw),
                   plain(*args, **kw), 16)
    # B7's first version at the main path's width, reached by its geometry.
    mod = mods["bat"]
    with geometry(mod, "bat_geometry", mod.candidate_tile_geometry):
        for name in ("rastrigin", "ackley"):
            kernel, plain, args, kw = zoo_case(mods, pf, "bat", name, 3000,
                                               30, 8, "device", dev)
            compare_family("bat", name, "n=3000 D=30 k=8, second variant",
                           kernel(*args, **kw), plain(*args, **kw), 8)


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


def zoo_operations(fam, n, d, k_steps):
    """A family launch's operations from ``ZOO_OPS`` (the whale's common
    part)."""
    per_elem, per_particle, elem_once, particle_once = ZOO_OPS[fam]
    return (k_steps * n * (d * per_elem + per_particle)
            + n * (d * elem_once + particle_once))


def woa_operations(n, d, k_steps, contracting):
    """B11's operations on one launch that its function needs: the common
    part, each branch's (``WOA_BRANCH_OPS``) at its elements and whales
    (``contracting`` elements from the plain version's tally, the rest
    spiralling) and the schedule once a step."""
    spiralling = k_steps * n * d - contracting
    ops = zoo_operations("woa", n, d, k_steps) + WOA_SCHEDULE_OPS * k_steps
    for elements, key in ((contracting, "contract"), (spiralling, "spiral")):
        per_elem, per_whale = WOA_BRANCH_OPS[key]
        ops += elements * per_elem + elements // d * per_whale
    return ops


def woa_operations_both_branches(n, d, k_steps, drawing):
    """B11's operations as counted before its kernel ran one branch a lane:
    both branches at every whale, A's and C's draws at ``drawing``
    elements."""
    per_elem, per_whale = WOA_BOTH_BRANCHES_OPS
    return (k_steps * n * (d * per_elem + per_whale) + n * (23 * d + 1)
            + WOA_DRAW_OPS * drawing)


def zoo_bound_ms(fam, n, d, k_steps, ops=None):
    """Least time for one launch of a family kernel on this card: its
    operations (``zoo_operations``, or ``ops`` where they depend on the
    data, as the whale's) over the f32 peak, against the bytes it must
    move (each state array read once and each output written once) over
    the memory rate."""
    if ops is None:
        ops = zoo_operations(fam, n, d, k_steps)
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


def zoo_full_width(dsa, fam, mod, kernels, smi, t_start, dev, census):
    """Phase 11 for one family: the model's run at its bench's width after
    a warm-up launch, counted and checked; then one launch at the final
    state against its plain version, timed beside it and its bound (bat,
    salp and whale also beside their issue floors; bat in both variants at
    the final and at the initial state, the whale in both at the final
    state and with the iteration at 0)."""
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
    seed = torch.tensor([2025], dtype=torch.int32, device=dev)
    # Bat's launch at the initial state (pulse 0: every bat walks), kept on
    # the host while the run's peak memory is taken.
    initial = None
    if fam == "bat":
        initial = [t.cpu() for t in
                   zoo_launch_args(fam, opt.state, seed, dev)[0]]
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

    args, extra = zoo_launch_args(fam, state, seed, dev)
    step_kw = dict(objective_name="rastrigin", half_width=opt.half_width,
                   k_steps=k, step0=steps, **extra)
    kernel = getattr(mod, f"fused_{fam}_step_cuda")
    got = kernel(*args, **step_kw)
    want, plain_ms = timed(
        lambda: getattr(mod, f"fused_{fam}_step_plain")(*args, **step_kw))
    cmp = compare_family(fam, "rastrigin", "main path, final state", got,
                         want, k)
    counts, extra = {}, {}
    if fam == "woa":
        # The contracting elements, which alone draw A and C; and B11 in
        # both variants at the final state (a = 0) and with the launch's
        # iteration at 0, where |A| >= 1 at about half of them.
        mod.fused_woa_step_plain(*args, **step_kw, counts=counts)
        args0 = [args[0].clone(), *args[1:]]
        args0[0][2] = 0
        variant_times(fam, mod, kernel, [
            ("final_state", args, step_kw, want),
            ("t0_0", args0, step_kw,
             mod.fused_woa_step_plain(*args0, **step_kw))], k, smi)
        del args0
    if fam == "bat":
        args0 = [t.to(dev) for t in initial]
        check(bool((args0[7] == 0).all()), "bat: an initial pulse > 0")
        variant_times(fam, mod, kernel, [
            ("final_state", args, step_kw, want),
            ("initial_state", args0, step_kw,
             getattr(mod, f"fused_{fam}_step_plain")(*args0, **step_kw))],
            k, smi)
        del args0
    del got, want, initial
    ms = cuda_ms(lambda: kernel(*args, **step_kw), 10)
    clock = census["clock_mhz"]
    ops, contracting = None, 0
    if fam == "woa":
        contracting = int(sum(int(c) for c in counts["contract"]))
        ops = woa_operations(ZOO_N, ZOO_DIM, k, contracting)
        extra.update(contracting_elements=contracting, **{
            f"bound_ms_both_branches_{name}": zoo_bound_ms(
                fam, ZOO_N, ZOO_DIM, k, woa_operations_both_branches(
                    ZOO_N, ZOO_DIM, k, drawing))[0]
            for name, drawing in (("draws_contracting", contracting),
                                  ("draws_everywhere",
                                   k * ZOO_N * ZOO_DIM))})
    bound, bound_by, ops, nbytes = zoo_bound_ms(fam, ZOO_N, ZOO_DIM, k, ops)
    floor = (bat_issue_floor(census["bat"], ZOO_N, ZOO_DIM, k, clock)
             if fam == "bat" else
             salp_issue_floor(census["salp"], ZOO_N, ZOO_DIM, k, clock,
                              mod.salp_geometry(ZOO_DIM, 4096).lanes)
             if fam == "salp" else
             woa_issue_floor(census["woa"], ZOO_N, ZOO_DIM, k, clock,
                             contracting)
             if fam == "woa" else (None, None))
    if len(floor) > 2:
        extra["issue_floor_count"] = floor[2]
    record(phase=f"{fam}_fused_timing", shape=[ZOO_DIM, ZOO_N], k_steps=k,
           kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
           bound_by=bound_by, operations=ops, bytes=nbytes,
           instructions_per_element_step=floor[0], issue_floor_ms=floor[1],
           ptxas=census.get(f"{fam}_ptxas"), **extra,
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
        mfo_fixed_moths(g, pos, flames, hw)
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


def mfo_fixed_moths(g, pos, flames, hw):
    """About half the moths set equal to their flames (those below
    n_flames start at B16's fixed point): one with a flame component of -0
    beside its +0, one at a flame outside the domain, which must move."""
    d, n = pos.shape
    same = torch.from_numpy(np.nonzero(g.uniform(size=n) < 0.5)[0]).to(
        pos.device)
    pos[:, same] = flames[:, same]
    flames[0, same[0]], pos[0, same[0]] = -0.0, 0.0
    flames[min(1, d - 1), same[1]] = pos[min(1, d - 1), same[1]] = 2 * hw


def rot_small_shapes(mods, pf, dev):
    """Phase 3's part for DE, SHADE, GA and MFO: each kernel against its
    plain version at ragged shapes, with 4 or more tiles, 1 and k steps,
    both rng modes; GA at every k from 1 to 8 (the tile kept in step), in
    clusters of 1, 4 and 16 blocks (of 256 and 512 lanes) and in its second
    variant (a tile of 16,384); DE at the main path's tile, past 32 genes
    (a mask word in shared memory), in its second variant (D = 200) and
    with windows longer than the tile (96 lanes)."""
    cases = [
        ("de", "rastrigin", 512, 8, 1, "host", 128),
        ("de", "sphere", 480, 30, 32, "device", 96),
        ("de", "michalewicz", 640, 1, 8, "device", 160),
        ("de", "ackley", 4096, 30, 32, "device", 1024),
        ("de", "rastrigin", 16384, 30, 32, "device", 4096),
        ("de", "levy", 2048, 70, 4, "device", 512),
        ("de", "griewank", 4000, 33, 8, "device", 1000),
        ("de", "rosenbrock", 1024, 200, 2, "device", 256),
        ("de", "schwefel", 384, 31, 32, "device", 96),
        ("shade", "rastrigin", 512, 8, 1, "host", 128),
        ("shade", "griewank", 1280, 30, 1, "device", 256),
        ("shade", "levy", 512, 1, 1, "device", 128),
        ("shade", "schwefel", 768, 100, 1, "device", 128),
        ("shade", "rastrigin", 16384, 30, 1, "device", 4096),
        ("shade", "sphere", 640, 4, 1, "device", 128),
        ("shade", "zakharov", 1024, 3, 1, "host", 256),
        ("shade", "ackley", 2048, 31, 1, "device", 512),
        ("shade", "michalewicz", 512, 10, 1, "device", 128),
        ("shade", "rosenbrock", 384, 363, 1, "device", 128),
        ("ga", "rastrigin", 512, 8, 1, "host", 128),
        ("ga", "zakharov", 500, 3, 8, "device", 100),
        ("ga", "ackley", 16384, 30, 8, "device", 4096),
        *(("ga", "rastrigin", 16384, 30, k, "device", 4096)
          for k in range(1, 9)),
        ("ga", "sphere", 4096, 30, 8, "device", 1024),       # 4 x 256
        ("ga", "levy", 32768, 30, 8, "device", 8192),        # 16 x 512
        ("ga", "griewank", 32768, 30, 3, "device", 16384),   # no cluster
        ("mfo", "rastrigin", 512, 8, 1, "host", 128),
        ("mfo", "styblinski_tang", 1000, 30, 8, "device", 200),
        ("mfo", "rosenbrock", 77, 1, 32, "device", 77),
        ("mfo", "ackley", 640, 30, 8, "device", 128),
        ("mfo", "rastrigin", 4096, 30, 8, "device", 1024),
        ("mfo", "sphere", 1024, 28, 8, "device", 256),
        ("mfo", "schwefel", 1000, 29, 5, "device", 200),
        ("mfo", "griewank", 512, 31, 3, "device", 128),
        ("mfo", "rastrigin", 256, 908, 2, "device", 128),
    ]
    for fam, name, n, d, k, rng, tile_n in cases:
        kernel, plain, args, kw = rot_case(mods, pf, fam, name, n, d, k, rng,
                                           dev, tile_n)
        before = mods[fam].LAUNCHES
        got = kernel(*args, **kw)
        check(mods[fam].LAUNCHES == before + 1, "launch not counted")
        geo = (f" geometry={tuple(mods[fam].ga_geometry(d, tile_n))}"
               if fam == "ga" else "")
        compare_family(fam, name, f"n={n} D={d} k={k} rng={rng} "
                       f"tile_n={tile_n}{geo}", got, plain(*args, **kw), k)


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


def rot_bound_ms(fam, n, d, k_steps, needed=None):
    """Least time for one launch of a rotational family's kernel on this
    card: its operations (``ROT_OPS``) over the f32 peak, against the bytes
    it must move (each input read once, each output written once) over the
    memory rate.  ``needed`` (GA: the plain version's tallies, summed over
    the launch) charges the work that depends on the data only where the
    function needs it; a tally it lacks charges that work at every
    element.  MFO's ``needed`` (its tallies summed over the launch):
    ``moving`` moth-steps charged in full but for the flame select,
    ``stopped_at_start`` moths one evaluation and the test each
    (``MFO_STOPPED_OPS``)."""
    per_elem, per_particle = ROT_OPS[fam]
    ops = k_steps * n * (d * per_elem + per_particle)
    if needed is not None and fam == "mfo":
        ops = (needed["moving"] * (d * (per_elem - MFO_SELECT_OPS)
                                   + per_particle)
               + needed["stopped_at_start"] * (d * MFO_STOPPED_OPS[0]
                                               + MFO_STOPPED_OPS[1]))
    elif needed is not None:
        elems = k_steps * n * d
        skipped = lambda key: elems - needed.get(key, elems)  # noqa: E731
        ops -= (GA_DELTA_OPS + GA_UNIFORM_OPS) * skipped("mutated")
        ops -= GA_QUARTER_CALL_OPS * skipped("mutating_group_elements")
        ops -= GA_CROSS_OPS * skipped("crossing_elements")
    nbytes = {"de": 4 * (2 * d + 2) * n,
              "shade": 4 * (3 * d + 4) * n + 4 * 128 * d,
              "ga": 4 * (2 * d + 2) * n,
              "mfo": 4 * (4 * d + 3) * n + 4 * d}[fam]
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(by_ops, by_bytes), (
        "operations" if by_ops >= by_bytes else "bytes"), ops, nbytes


def shade_issue_floor(census, n, d, k_steps, clock_mhz):
    """B14's issue floor on one launch: the gene chunk loop (four genes:
    the loads, the Philox group, the mutants, the selects, the tiles'
    stores, the folded terms; the loop with the 32-bit products) and the
    write loop (four genes from a tile) D // 4 times a lane, plus the
    kernel's instructions outside its loops (the lane's setup and source
    draw, the last D mod 4 genes, the close, the acceptance; the
    function's body, ``body_instructions``), over N lanes."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if len(loops) < 2:
        return None, None
    chunk = max(loops, key=lambda lp: (lp[3], lp[2]))
    rest = [lp for lp in loops if lp is not chunk]
    write = max(rest, key=lambda lp: lp[2])
    outside = body_instructions(census) - sum(lp[2] for lp in loops)
    per_lane = (d // 4) * (chunk[2] + write[2]) + outside
    return per_lane / d, issue_floor_ms(per_lane * n * k_steps, clock_mhz)


def shade_replay_vs_eager(mod, state, half_width, dev, steps=SHADE_COMPARED):
    """The replayed SHADE run against the eager loop from the same
    full-width state, each on its own copy of the generator: every state
    field equal bit for bit."""
    from distributed_swarm_algorithm_tpu_torch.ops.shade import (
        SHADE_TENSOR_FIELDS,
    )
    outs = {}
    for replay in (False, True):
        gen = torch.Generator(device=dev)
        gen.set_state(state.gen.get_state())
        with replaying(mod, replay):
            outs[replay] = mod.fused_shade_run(state.replace(gen=gen),
                                               "rastrigin", steps,
                                               half_width=half_width)
    unequal = [f for f in SHADE_TENSOR_FIELDS
               if not torch.equal(getattr(outs[False], f),
                                  getattr(outs[True], f))]
    record(phase="shade_replay_vs_eager", particles=ZOO_N,
           generations=steps, unequal_fields=unequal,
           best=float(outs[True].best_fit))
    check(not unequal, f"the replayed SHADE run differs from the eager "
                       f"loop: {unequal}")


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


def mfo_warp_steps(lane_steps, k_steps, lanes=128):
    """(warps, warps holding a moth stopped at the start, warp-steps) of a
    B16 launch from the steps each moth takes (the plain version's
    ``lane_steps``): a block sorts its moving moths to the front before
    every step, so it runs ceil(m / 32) warps at a step where m moths
    move."""
    pad = (-lane_steps.numel()) % lanes
    ls = torch.cat([lane_steps.long(), lane_steps.new_full((pad,), -1)])
    blocks = ls.reshape(-1, lanes)
    warps = int((blocks >= 0).reshape(-1, 32).any(1).sum())
    holding = int((blocks == 0).reshape(-1, 32).any(1).sum())
    steps = sum(int((((blocks > s).sum(1) + 31) // 32).sum())
                for s in range(k_steps))
    return warps, holding, steps


def mfo_issue_floor(census, lane_steps, d, k_steps, clock_mhz):
    """B16's issue floor on one launch, from its SASS and the warps' steps
    on the data (``mfo_warp_steps``).  The step loop is the widest loop; a
    warp-step issues its chunk loop (four dimensions: the Philox group, the
    spirals, the folded terms; an inner loop with the most 32-bit
    products, own moths and the others having one each) D // 4 times and
    the rest of its path through the step loop (the sort, the last D mod 4
    dimensions, the close, the test) once, the flame's copy at an
    improvement left out.  A warp holding a moth stopped at the start also
    issues its evaluation's loop (four terms; the last loop before the step
    loop with no 32-bit product, the staging's loops coming before it)
    D // 4 times.  The staging and the write-out, which wait on memory,
    are left out.  Only predicated branches back make loops, as in
    ``abc_issue_floor``."""
    loops = [lp for lp in census.get("loops") or [] if lp[4]]
    if not loops:
        return None, None, None
    step = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp is not step
             and step[0] <= lp[0] and lp[1] <= step[1]]
    plain = [lp for lp in loops if lp[1] < step[0] and lp[3] == 0]
    if not inner or not plain:
        return None, None, None
    # Own moths and the others run separate instances of the chunk loop
    # (the two with the most 32-bit products); a warp-step issues one, and
    # of the other path its last D mod 4 dimensions neither, counted as
    # (D mod 4) / 4 of its chunk loop.
    chunk, *other = sorted(inner, key=lambda lp: (-lp[3], -lp[2], lp[0]))
    other = [lp for lp in other if lp[3] == chunk[3]]
    skipped = (d % 4) / 4 * sum(lp[2] for lp in other)
    evaluate = max(plain, key=lambda lp: lp[0])
    per_step = ((d // 4) * chunk[2] + step[2] - skipped
                - sum(lp[2] for lp in inner))
    warps, holding_fixed, warp_steps = mfo_warp_steps(lane_steps, k_steps)
    instructions = 32 * (holding_fixed * (d // 4) * evaluate[2]
                         + warp_steps * per_step)
    return (instructions / (lane_steps.numel() * d * k_steps),
            issue_floor_ms(instructions, clock_mhz),
            dict(chunk_loop=chunk[2], step_loop=step[2],
                 other_path=skipped, per_warp_step=per_step,
                 evaluation_loop=evaluate[2], warps=warps,
                 warps_holding_a_stopped_moth=holding_fixed,
                 warp_steps=warp_steps))


def mfo_run_trace(opt, start, steps, run_ms, n_launches, smi):
    """The timed MFO run replayed from its start (its state and its
    generator's) under a ``torch.profiler`` trace, which must end where the
    run ended: the kernel's device time a launch, the run's device busy
    time and idle share (against the unprofiled run)."""
    end = opt.state
    opt.state = start[0]
    opt.state.gen.set_state(start[1])
    busy, ops, top = device_time(lambda: opt.run(steps), 1)
    from distributed_swarm_algorithm_tpu_torch.ops.mfo import (
        MFO_TENSOR_FIELDS,
    )
    unequal = [f for f in MFO_TENSOR_FIELDS
               if not torch.equal(getattr(opt.state, f), getattr(end, f))]
    check(not unequal, f"mfo: the traced replay of the run differs in "
                       f"{unequal}")
    kernel_ms = sum(r["ms_per_tick"] for r in top
                    if "mfo_sorted_kernel" in r["kernel"]
                    or "mfo_lane_kernel" in r["kernel"])
    out = dict(run_device_busy_ms=busy,
               run_device_idle_share=(None if busy is None
                                      else 1.0 - busy / run_ms),
               kernel_device_ms_per_launch_in_run=kernel_ms / n_launches,
               kernel_device_share_of_run=kernel_ms / run_ms)
    record(phase="mfo_run_trace", steps=steps, run_ms=run_ms,
           device_ops_per_run=ops, top_device_ops=top, smi=smi, **out)
    return out


def mfo_chained_args(args, step_kw, out, iteration, dev):
    """The launch the run makes after the one at ``args`` when no re-sort
    falls between: its outputs ``out`` in, the schedule of ``iteration``,
    the clamp flame taken again, the next steps' draws."""
    from distributed_swarm_algorithm_tpu_torch.ops.mfo import schedule
    steps, k, t_max = ROT["mfo"]
    frac, n_flames = schedule(iteration, ZOO_N, t_max, torch.float32)
    r_lo = torch.round((-1.0 - frac) * 65536.0).to(torch.int32)
    last = out[2].index_select(1, (n_flames - 1).long().reshape(1))
    scalars = torch.cat([args[0][:1], n_flames.reshape(1).to(torch.int32),
                         r_lo.reshape(1)])
    return ([scalars, last, out[0], out[2], out[3]],
            dict(step_kw, step0=step_kw["step0"] + k))


def mfo_launches(mod, kernel, args, step_kw, got, counts, state, census,
                 smi, dev):
    """B16 at the final state and at the launch chained on its outputs:
    each against its plain version, timed in its geometry and in its first
    version, twice in turn, beside its bound restated from the plain
    version's tallies, the bound charging every element-step, and its
    issue floor."""
    steps, k, t_max = ROT["mfo"]
    args2, kw2 = mfo_chained_args(args, step_kw, got, state.iteration + k,
                                  dev)
    counts2 = {}
    want2 = mod.fused_mfo_step_plain(*args2, **kw2, counts=counts2)
    compare_family("mfo", "rastrigin", "main path, chained launch",
                   kernel(*args2, **kw2), want2, k)
    settings = {"default": mod.mfo_geometry,
                "first_version": mod.lane_geometry}
    times = {}
    for rep in range(2):
        for name, fn in settings.items():
            with geometry(mod, "mfo_geometry", fn):
                for label, a, kw in (("final_state", args, step_kw),
                                     ("chained", args2, kw2)):
                    times.setdefault(f"{name}_{label}_ms", []).append(
                        cuda_ms(lambda: kernel(*a, **kw), 10))
    out = dict(times_ms=times)
    clock = census["clock_mhz"]
    for label, c in (("final_state", counts), ("chained", counts2)):
        needed = {key: int(sum(int(v) for v in c[key]))
                  for key in ("moving", "stopped_at_start")}
        out[label] = dict(
            needed=needed,
            moving_by_step=[int(v) for v in c["moving"]],
            share_of_lane_steps=needed["moving"] / (ZOO_N * k),
            bound_ms=rot_bound_ms("mfo", ZOO_N, ZOO_DIM, k, needed)[0],
            bound_ms_every_element=rot_bound_ms("mfo", ZOO_N, ZOO_DIM,
                                                k)[0],
            issue_floor=mfo_issue_floor(census["mfo"], c["lane_steps"][0],
                                        ZOO_DIM, k, clock))
    out["final_state_floor"] = out["final_state"]["issue_floor"][:2]
    out["chained_ms"] = min(times["default_chained_ms"])
    out["geometry"] = tuple(mod.mfo_geometry(ZOO_DIM))
    return out


def rot_full_width(dsa, fam, mods, kernels, smi, t_start, dev, census):
    """Phase 12 for one family: the model's run at its bench's width after
    a warm-up launch, counted and checked (SHADE's device busy share from a
    trace of more generations); then one launch at the final state against
    its plain version, timed beside it and its bound (DE and GA also beside
    their issue floors, and in both variants)."""
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
    start = (opt.state, opt.state.gen.get_state())
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
    trace = {}
    if fam == "mfo":
        check(bool((state.flame_fit[1:] >= state.flame_fit[:-1]).all()),
              "mfo: the flames are not in rank order")
        trace = mfo_run_trace(opt, start, steps, run_ms, n_launches, smi)
    if fam == "shade":
        # The run above paid the capture of two generations; these replay
        # it alone.
        _, replay_ms = timed(lambda: opt.run(SHADE_REPLAYED))
        # CUPTI reports each kernel a graph launches as its own kernel
        # activity, so the trace's sums are the device's busy time.
        busy, ops, top = device_time(lambda: opt.run(SHADE_PROFILED),
                                     SHADE_PROFILED)
        ms_per_gen = run_ms / steps
        replay_per_gen = replay_ms / SHADE_REPLAYED
        record(phase="shade_generation_breakdown", particles=ZOO_N,
               profiled_generations=SHADE_PROFILED,
               ms_per_generation=ms_per_gen,
               ms_per_generation_replays_alone=replay_per_gen,
               particle_steps_per_sec_replays_alone=ZOO_N / (
                   replay_per_gen / 1e3),
               device_busy_ms_per_generation=busy,
               device_busy_share=(None if busy is None
                                  else busy / ms_per_gen),
               device_idle_share=(None if busy is None
                                  else 1.0 - busy / ms_per_gen),
               device_idle_share_replays_alone=(
                   None if busy is None else 1.0 - busy / replay_per_gen),
               device_ops_per_generation=ops, top_device_ops=top, smi=smi)
        state = opt.state
        shade_replay_vs_eager(mod, state, opt.half_width, dev)

    seed = torch.tensor([2026], dtype=torch.int32, device=dev)
    args, extra = rot_launch_args(mods, fam, state, seed, dev)
    step_kw = dict(objective_name="rastrigin", half_width=opt.half_width,
                   **extra)
    kernel = getattr(mod, f"fused_{fam}_step_cuda")
    got = kernel(*args, **step_kw)
    counts = {}
    plain_kw = (dict(step_kw, counts=counts) if fam in ("ga", "mfo")
                else step_kw)
    want, plain_ms = timed(
        lambda: getattr(mod, f"fused_{fam}_step_plain")(*args, **plain_kw))
    needed = ({key: int(sum(int(v) for v in vals))
               for key, vals in counts.items() if key != "lane_steps"}
              if fam in ("ga", "mfo") else None)
    cmp = compare_family(fam, "rastrigin", "main path, final state", got,
                         want, k)
    if fam == "de":
        knob, settings = knob_settings(fam, args, step_kw, want)
        variant_times(fam, mod, kernel, settings, k, smi, knob)
    elif fam == "ga":
        variant_times(fam, mod, kernel,
                      [("final_state", args, step_kw, want)], k, smi)
    extra = {}
    if fam == "mfo":
        extra = mfo_launches(mod, kernel, args, step_kw, got, counts, state,
                             census, smi, dev)
    if fam == "shade":
        # The generation from a counter on the device, as a replayed run
        # hands it, draws what the int does.
        step_t = torch.tensor([step_kw["step"]], dtype=torch.int32,
                              device=dev)
        again = kernel(*args, **dict(step_kw, step=step_t))
        check(all(torch.equal(a, b) for a, b in zip(again, got)),
              "shade: the step from the device draws other numbers")
        extra = dict(
            kernel_graph_ms=graph_ms(lambda: kernel(*args, **step_kw), 10),
            four_stream_floor_ms=1e3 * 4 * 4 * ZOO_DIM * ZOO_N
            / PEAK_HBM_BYTES)
    del got, want
    ms = cuda_ms(lambda: kernel(*args, **step_kw), 10)
    bound, bound_by, ops, nbytes = rot_bound_ms(fam, ZOO_N, ZOO_DIM, k,
                                                needed)
    if fam == "mfo":
        extra.update(trace, bound_ms_every_element=rot_bound_ms(
            fam, ZOO_N, ZOO_DIM, k)[0], needed=needed)
    if fam == "ga":
        extra = dict(needed_elements=needed,
                     bound_ms_every_element=rot_bound_ms(
                         fam, ZOO_N, ZOO_DIM, k)[0],
                     geometry=tuple(mod.ga_geometry(ZOO_DIM, 4096)))
    floors = {"de": de_issue_floor, "ga": ga_issue_floor,
              "shade": shade_issue_floor}
    floor = (floors[fam](census[fam], ZOO_N, ZOO_DIM, k, census["clock_mhz"])
             if fam in floors else (None, None))
    # MFO's launches differ in work, so its share comes from the trace.
    share = ms * launches[f"{fam}_fused"] / run_ms
    if fam == "mfo":
        floor = extra.pop("final_state_floor")
        share = extra.pop("kernel_device_share_of_run")
    record(phase=f"{fam}_fused_timing", shape=[ZOO_DIM, ZOO_N], k_steps=k,
           kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
           bound_by=bound_by, operations=ops, bytes=nbytes,
           instructions_per_element_step=floor[0], issue_floor_ms=floor[1],
           ptxas=census.get(f"{fam}_ptxas"), kernel_share_of_run=share,
           smi=smi, seconds_so_far=time.perf_counter() - t_start, **extra)
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
    family's cap; cuckoo in clusters of 16 blocks (of 256 lanes: the main
    path's tile; of 512: a tile of 8,192) and of 4, and in its second
    variant (a tile of 16,384); ABC at a small limit (its scouts fire), at
    every D mod 4, with its lane shifts at the tile's edge, in clusters of
    4 and 16 and in its second variant (a tile of 16,384, D = 227); PT
    with padded lanes (n_real < n) and with the widest halo (swap_every =
    1); B18 and B13 at every D mod 4 with a tile's last block partial (PT:
    17 windows a tile of 4,096, the last owning 128 chains; HHO: blocks of
    256 hawks across tiles of 1,000) and at each variant's widest D (PT 109
    the main variant, 360 the first version, which takes over at 110; HHO
    111 regrouped, 605 the first version)."""
    cases = [
        ("cuckoo", "rastrigin", 512, 8, 1, "host", 128, {}),
        ("cuckoo", "sphere", 480, 30, 8, "device", 96, {}),
        ("cuckoo", "michalewicz", 640, 1, 8, "device", 160, {}),
        ("cuckoo", "ackley", 4096, 30, 8, "device", 1024, {}),
        ("cuckoo", "rastrigin", 16384, 30, 8, "device", 4096, {}),
        ("cuckoo", "rastrigin", 32768, 8, 8, "device", 8192, {}),
        ("cuckoo", "zakharov", 4000, 33, 8, "device", 1000, {}),
        ("cuckoo", "griewank", 65536, 30, 3, "device", 16384, {}),
        ("hho", "rastrigin", 512, 8, 1, "host", 128, {}),
        ("hho", "griewank", 1000, 30, 8, "device", 200, {}),
        ("hho", "levy", 640, 1, 8, "device", 160, {}),
        ("hho", "schwefel", 768, 100, 3, "device", 128, {}),
        ("abc", "rastrigin", 512, 8, 1, "host", 128, dict(limit=2)),
        ("abc", "zakharov", 500, 3, 8, "device", 100, dict(limit=2)),
        ("abc", "ackley", 16384, 30, 8, "device", 4096,
         dict(limit=491520)),
        # B17 at every D mod 4, both lane shifts at the tile's edge, in
        # clusters of 4 and 16 blocks, and in its second variant at a tile
        # no cluster holds (16,384) and past 227 KB a block (D = 227).
        ("abc", "rastrigin", 16384, 4, 8, "device", 4096, dict(limit=2)),
        ("abc", "sphere", 16384, 5, 8, "device", 4096, dict(limit=2)),
        ("abc", "michalewicz", 4096, 31, 8, "device", 1024, dict(limit=2)),
        ("abc", "rastrigin", 16384, 30, 8, "device", 4096,
         dict(limit=2, lanes=(4095, 4095))),
        ("abc", "griewank", 4000, 33, 8, "device", 1000,
         dict(limit=2, lanes=(1999, 0))),
        ("abc", "rastrigin", 32768, 30, 8, "device", 16384, dict(limit=2)),
        ("abc", "schwefel", 8192, 227, 2, "device", 4096, dict(limit=2)),
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
        *(("pt", "rastrigin", 8192, d, 16, "device", 4096,
           dict(n_real=8190)) for d in (4, 5, 6, 7)),
        ("pt", "sphere", 4096, 109, 16, "device", 4096, dict(swap_every=1)),
        ("pt", "levy", 4096, 110, 16, "device", 4096, dict(swap_every=1)),
        ("pt", "griewank", 1024, 360, 16, "device", 512,
         dict(swap_every=1)),
        *(("hho", "rastrigin", 3000, d, 8, "device", 1000, {})
          for d in (4, 5, 6, 7)),
        ("hho", "schwefel", 2048, 111, 8, "device", 1024, {}),
        ("hho", "zakharov", 1024, 605, 2, "device", 512, {}),
    ]
    scouts = swaps = 0
    for fam, name, n, d, k, rng, tile_n, extra in cases:
        extra = dict(extra)
        lanes = extra.pop("lanes", None)
        kernel, plain, args, kw = levy_case(mods, pf, fam, name, n, d, k,
                                            rng, dev, tile_n, **extra)
        if lanes is not None:   # ABC's two lane shifts, at the tile's edge
            args[0][-2:] = torch.tensor(lanes, dtype=torch.int32)
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
    plain version's tally of the same launch: abandoned, exploring,
    diving and kept, probed and exhausted lanes) over the f32 peak, against
    the bytes it must move (each input read once, each output written
    once) over the memory rate."""
    c = FAM_OPS[fam]
    total = lambda key: int(sum(int(v) for v in counts.get(key, [])))  # noqa
    ops = k_steps * n * (d * c["elem"] + c["lane"])
    if fam == "cuckoo":
        ops += total("abandoned") * (d * c["abandoned"] + c["abandoned_lane"])
    elif fam == "hho":
        explore, dive = total("explore"), total("dive")
        kept_first = int(counts["kept"][0])
        ops += (explore * d * c["explore"]
                + (k_steps * n - explore - dive) * d * c["besiege"]
                + dive * (d * c["dive"] + c["dive_lane"])
                - (dive - kept_first) * d * c["elem"])
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


def levy_full_width(dsa, fam, mods, kernels, smi, t_start, dev, census):
    """Phase 13 for one family: the model's run at its bench's width after
    a warm-up launch, counted and checked, the device's busy share from a
    trace of one more launch; then one launch at the final state against
    its plain version, timed beside it and its bound (cuckoo and ABC also
    beside their issue floors, and in both variants)."""
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
    if fam == "cuckoo":
        knob, settings = knob_settings(fam, args, step_kw, want)
        variant_times(fam, mod, kernel, settings, k, smi, knob)
    elif fam == "abc":
        probed = list(args)
        probed[2] = torch.full_like(args[2], -1.0)    # no candidate beats it
        probed[3] = torch.zeros_like(args[3])
        every = {}
        want_probed = getattr(mod, f"fused_{fam}_step_plain")(
            *probed, **step_kw, counts=every)
        check(all(int(p) == ZOO_N for p in every["probed"]),
              "abc: a lane was not probed")
        variant_times(fam, mod, kernel, [
            ("final_state", args, step_kw, want),
            ("every_lane_probed", probed, step_kw, want_probed)], k, smi)
        del want_probed
    elif fam == "pt":
        wide = dict(step_kw, swap_every=1)
        want_wide = getattr(mod, f"fused_{fam}_step_plain")(*args, **wide)
        variant_times(fam, mod, kernel, [
            ("final_state", args, step_kw, want),
            ("swap_every_1", args, wide, want_wide)], k, smi)
        del want_wide
    elif fam == "hho":
        first = list(args)
        first[0] = args[0].clone()
        first[0][2] = 0                  # t0 = 0: |E| up to 2, three classes
        first_counts = {}
        want_first = getattr(mod, f"fused_{fam}_step_plain")(
            *first, **step_kw, counts=first_counts)
        record(phase="hho_first_launch_lanes",
               explore=[int(v) for v in first_counts["explore"]],
               dive=[int(v) for v in first_counts["dive"]], particles=ZOO_N)
        variant_times(fam, mod, kernel, [
            ("final_state", args, step_kw, want),
            ("first_launch", first, step_kw, want_first)], k, smi)
        del want_first
    del got, want
    ms = cuda_ms(lambda: kernel(*args, **step_kw), 10)
    issue_floor = {"cuckoo": cuckoo_issue_floor,
                   "abc": abc_issue_floor}.get(fam)
    floor = (issue_floor(census[fam], ZOO_N, ZOO_DIM, k, census["clock_mhz"])
             if issue_floor else (None, None))
    if fam == "pt":
        floor = pt_issue_floor(census[fam], pt_threads(
            ZOO_N, ZOO_DIM, k, opt.swap_every, 4096), ZOO_DIM, k,
            census["clock_mhz"])
    elif fam == "hho":
        floor = hho_issue_floor(census[fam], ZOO_N, ZOO_DIM, k,
                                census["clock_mhz"], counts)
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
           instructions_per_element_step=floor[0], issue_floor_ms=floor[1],
           ptxas=census.get(f"{fam}_ptxas"),
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
    # The fitness-sorted schedule at its edges: rows in sorted, reverse and
    # shuffled order of fitness, runs of equal fitness across the tiles of
    # 64, NaN and +-inf, signed zeros; each call twice and equal.
    g = np.random.default_rng(3)
    pos, fit = ff_inputs(3000, 30, 4, dev, 0.05)
    n = pos.shape[0]
    edges = {
        "sorted": fit.sort().values,
        "reverse": fit.sort(descending=True).values,
        "shuffled": fit,
        "ties across tiles": torch.floor(torch.from_numpy(
            g.permutation(n).astype(np.float32)).to(dev) / 50.0),
        "NaN and +-inf": torch.from_numpy(np.where(
            g.random(n) < 0.1, np.nan, np.where(
                g.random(n) < 0.1, np.inf, np.where(
                    g.random(n) < 0.1, -np.inf, g.standard_normal(n))))
            .astype(np.float32)).to(dev),
        "signed zeros": torch.from_numpy(g.choice(
            [-0.0, 0.0, -1.0, 1.0], n).astype(np.float32)).to(dev),
    }
    for label, f in edges.items():
        got = ff.firefly_attraction_cuda(pos, f)
        check(torch.equal(got, ff.firefly_attraction_cuda(pos, f)),
              f"firefly kernel repeats other bits: {label}")
        worst = max(worst, compare_firefly(
            ff, got, pos, f, f"n=3000 D=30, {label}")[0]["max_err_over_band"])

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
    # The redesigned B20 past the edges of its team: one warp an ant (127),
    # two and four (257), two and four blocks of four cities a lane (1,025
    # and 2,048), with ants that do not fill a block.
    for c in (127, 257, 513, 1025, 2048):
        for q0, host, a in ((0.0, False, 37), (0.5, True, 5)):
            compare_aco(af, c, a, q0, host, dev, c + a)
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
    record(phase="ff_aco_small_shapes", firefly_cases=18 + len(edges),
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
    rec, cmp = ff_timed(ff, pos, fit, "main path, 65,536 final state", smi,
                        t_start)
    record(phase="firefly_fused_timing", **rec,
           kernel_share_of_run=rec["kernel_ms"] * n_launches / run_ms)
    ms, plain_ms = rec["kernel_ms"], rec["plain_ms"]
    bound, bound_by = rec["bound_ms"], rec["bound_by"]
    # At the bench's spread almost no pair attracts, so the sums over j stay
    # empty: the same swarm drawn 50 times closer, where about half the
    # pairs attract, holds the accumulation at full width.
    close = pos * 0.02
    rec, _ = ff_timed(ff, close, opt.objective(close).contiguous(),
                      "65,536 final state x 0.02", smi, t_start)
    record(phase="firefly_fused_timing_attracting", scale=0.02, **rec)
    check(rec["weighted_pairs"] > FF_N * FF_N // 4,
          f"the close swarm attracts too few pairs: {rec['weighted_pairs']}")
    # The second row, where 256 row blocks alone would underfill the card.
    opt2, n_launches2, run_ms2 = runs[FF_N2]
    rec, _ = ff_timed(ff, opt2.state.pos, opt2.state.fit,
                      "16,384 final state", smi, t_start)
    record(phase="firefly_fused_timing_16384", **rec,
           kernel_share_of_run=rec["kernel_ms"] * n_launches2 / run_ms2)
    return dict(name="firefly_fused", route="cuda",
                source="distributed_swarm_algorithm_tpu_torch/csrc/"
                       "firefly_fused.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/pallas/"
                         "firefly_fused.py:126",
                launches=n_launches, max_abs_err=cmp["max_abs_err"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def ff_timed(ff, pos, fit, label, smi, t_start):
    """B19 on one square state: twice and equal, against its plain version
    within its band, timed beside it and its bound, with the row-tile
    visits of its fitness-sorted schedule against all of them (N
    ceil(N / 64), what the first version visited)."""
    n = pos.shape[0]
    got = ff.firefly_attraction_cuda(pos, fit)
    again = ff.firefly_attraction_cuda(pos, fit)
    check(torch.equal(got, again), f"firefly kernel repeats other bits: "
                                   f"{label}")
    counts = {}
    cmp, plain_ms = compare_firefly(ff, got, pos, fit, label, counts=counts)
    del got, again
    ms = cuda_ms(lambda: ff.firefly_attraction_cuda(pos, fit), 5)
    bound, bound_by, ops, nbytes = ff_bound_ms(n, n, FF_DIM, counts)
    _, _, tiles = ff.attraction_schedule(fit, None, FF_DIM)
    visits = int(tiles.sum()) * ff.rows_per_block(FF_DIM)
    every = n * -(-n // ff.TILE_J)
    splits, chunk = ff.split_plan(n, n, FF_DIM, ff._sm_count(0))
    return dict(
        shape=[n, FF_DIM], kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, operations=ops, bytes=nbytes,
        brighter_pairs=int(sum(int(v) for v in counts["brighter"])),
        weighted_pairs=int(sum(int(v) for v in counts["weighted"])),
        row_tile_visits=visits, row_tiles_all=every,
        visited_share=visits / every, splits=splits, chunk_tiles=chunk,
        blocks_of_work=int((-(-tiles.long() // chunk)).sum()),
        max_abs_err=cmp["max_abs_err"],
        max_err_over_band=cmp["max_err_over_band"], smi=smi,
        seconds_so_far=time.perf_counter() - t_start), cmp


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


def tours_timed(af, state, census, label, smi):
    """B20 at a colony's pheromone: the main path's own start draw and a
    fixed seed, timed replayed from a CUDA graph (the device's time) and
    back to back (the host's pacing included), beside its bound and its
    issue floor from the census of the kernel the team width takes."""
    from distributed_swarm_algorithm_tpu_torch.ops import aco
    a, c = ACO_A, state.dist.shape[0]
    dev = state.dist.device
    logits = aco.aco_logits(state.tau, state.dist, 1.0, 2.0)
    start = torch.randint(0, c, (a,), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    seed = torch.tensor([2026], dtype=torch.int32, device=dev)
    call = lambda: af.construct_tours_cuda(logits, state.dist, start,  # noqa
                                           seed)
    tours, lengths = call()
    geo = af.tour_geometry(c)
    kernel = census["tours"] if geo.blocks_per_lane == 1 else (
        census["tours_k2"] if geo.blocks_per_lane == 2 else {})
    per_step, floor = tours_issue_floor(kernel, (a, c), geo.lanes,
                                        census["clock_mhz"])
    bound, by, ops, nbytes = aco_tours_bound_ms(tours)
    rec = dict(shape=[a, c], instance=label, kernel_ms=graph_ms(call, 20),
               kernel_back_to_back_ms=cuda_ms(call, 20), bound_ms=bound,
               bound_by=by, operations=ops, bytes=nbytes,
               issue_floor_ms=floor, instructions_per_lane_step=per_step,
               team_lanes=geo.lanes, blocks_per_lane=geo.blocks_per_lane,
               chain_steps=c - 1, smi=smi)
    return rec, (logits, start, seed, tours, lengths)


def aco_short_runs(dsa, coords, smi):
    """``ACO.run(n)`` for the short n of ACO_SHORT against the eager loop
    of n ``ACO.step()`` (fused_aco_step, no graph), each pair on two new
    colonies of one seed, timed to the device's end: the run's first call
    (its capture included) and its next (the capture replayed), the loop's
    first and next; the two colonies' states equal bit for bit after
    each.  Medians of ACO_SHORT_REPS pairs."""
    for n in ACO_SHORT:
        times = {k: [] for k in ("first", "next", "eager_first",
                                 "eager_next")}
        for _ in range(ACO_SHORT_REPS):
            g = dsa.ACO(coords=coords, seed=0, n_ants=ACO_A)
            e = dsa.ACO(coords=coords, seed=0, n_ants=ACO_A)
            for k in ("first", "next"):
                torch.cuda.synchronize()
                times[k].append(timed(lambda: g.run(n))[1])
                times["eager_" + k].append(
                    timed(lambda: [e.step() for _ in range(n)])[1])
                check(all(torch.equal(getattr(g.state, f),
                                      getattr(e.state, f))
                          for f in ("tau", "best_tour", "best_len",
                                    "iteration")),
                      f"ACO.run({n}) differs from {n} eager steps")
        med = {k: float(np.median(v)) for k, v in times.items()}
        record(phase="aco_short_runs", cities=ACO_C, ants=ACO_A,
               iterations=n, reps=ACO_SHORT_REPS,
               run_first_call_ms=med["first"], run_next_call_ms=med["next"],
               eager_first_call_ms=med["eager_first"],
               eager_next_call_ms=med["eager_next"],
               first_over_eager=med["first"] / med["eager_first"],
               next_over_eager=med["next"] / med["eager_next"],
               all_ms=times, smi=smi)


def aco_full_width(dsa, af, kernels, smi, t_start, dev, census):
    """Phase 14's ACO part: bench_aco.py's instance (C = 256, A = 1,024, 400
    iterations, replayed from the graph its warm-up captured), the device's
    busy share from a trace of 16 more, short runs against the eager loop
    (aco_short_runs), B20 and B21 at the final pheromone against their
    plain versions, timed beside them (B20 from a graph and back to back),
    their bounds, B20's issue floor and index_add_; then
    bench_aco_sweep.py's C = 512 and 1,024 (B20 and B21 timed at each) and
    its circle-1,024 known optimum."""
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
           iterations_from="one CUDA graph a colony, replayed an iteration",
           profiled_iterations=ACO_PROFILED, ms_per_iteration=ms_it,
           device_busy_ms_per_iteration=busy,
           device_busy_share=None if busy is None else busy / ms_it,
           device_idle_share=None if busy is None else 1.0 - busy / ms_it,
           device_ops_per_iteration=ops_per, top_device_ops=top, smi=smi)
    aco_short_runs(dsa, coords, smi)

    state = colony.state
    rec, (logits, start, seed, tours, lengths) = tours_timed(
        af, state, census, "uniform-256", smi)
    want, tours_plain_ms = timed(lambda: af.construct_tours_plain(
        logits, state.dist, start, seed))
    check(torch.equal(tours, want[0]) and torch.equal(lengths, want[1]),
          "B20 differs from its plain version at the main path's state")
    tours_err = float((lengths - want[1]).abs().max())
    tours_ms, t_bound, t_by = rec["kernel_ms"], rec["bound_ms"], rec["bound_by"]
    record(phase="aco_tours_timing", **rec, plain_ms=tours_plain_ms,
           kernel_share_of_run=tours_ms * launches["aco_tours"] / run_ms,
           max_abs_err=tours_err)
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
        swept, rec, run_ms, last = aco_run_checked(
            dsa, af, kernels, coords, iters, smi, f"uniform-{c}", n_ants=ACO_A)
        record(**rec, seconds_so_far=time.perf_counter() - t_start)
        rec, _ = tours_timed(af, swept.state, census, f"uniform-{c}", smi)
        record(phase="aco_tours_timing", **rec,
               kernel_share_of_run=rec["kernel_ms"] * iters / run_ms)
        del swept
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


def n1_case(kind, p, m, seed, dev):
    """(objs [p, m], viol [p] or None) on the card: the cases N1 is held
    to (random points, a single chain of P fronts, all equal, duplicates,
    +-0 and +-inf, feasible, infeasible and tied violations)."""
    rng = np.random.default_rng(seed)
    objs = rng.uniform(0.0, 1.0, (p, m)).astype(np.float32)
    viol = None
    if kind == "chain":
        objs = np.repeat(np.arange(p, dtype=np.float32)[:, None], m, 1)
        objs = objs[rng.permutation(p)]
    elif kind == "equal":
        objs[:] = 0.25
    elif kind == "duplicates":
        objs = objs[rng.integers(0, max(1, p // 4), p)]
    elif kind == "signed":
        vals = np.float32([-0.0, 0.0, np.inf, -np.inf, 1.0, -1.0])
        objs = vals[rng.integers(0, len(vals), (p, m))]
    elif kind == "viol":
        viol = rng.choice(np.float32([0.0, 1e-4, 2e-4, 0.5, 0.5, 3.0]), p)
    elif kind == "viol_zero":
        viol = np.zeros(p, np.float32)
    return (torch.from_numpy(objs).to(dev),
            None if viol is None else torch.from_numpy(viol).to(dev))


def n1_small_shapes(n1, dev):
    """Phase 3's N1 part: the kernel against its plain version under
    ``torch.equal`` at P = 1, 31, 32, 33, 1,024, 1,025, 2,049, 4,096 and M
    = 1, 2, 3 on random points, as chains (each peel's edges: one and 32
    words of the register peel, the staged peel's first size), at M past
    the pack's chunk of 64 objectives, and on every edge case, with its
    front count."""
    cases = [("random", p, m)
             for p in (1, 31, 32, 33, 1024, 1025, 2049, 4096)
             for m in (1, 2, 3)]
    cases += [("chain", p, m) for p in (32, 33, 1024, 1025, 1300, 4096)
              for m in (1, 2)]
    cases += [("random", 33, 65), ("random", 100, 200), ("viol", 1024, 130)]
    cases += [(kind, p, m) for kind in ("equal", "duplicates", "signed",
                                        "viol", "viol_zero")
              for p in (31, 1025, 4096) for m in (1, 2, 3)]
    fronts = torch.zeros(1, dtype=torch.int32, device=dev)
    most = 0
    for kind, p, m in cases:
        objs, viol = n1_case(kind, p, m, p * 3 + m, dev)
        got = n1.nsga2_ranks_cuda(objs, viol, N1_FEAS_TOL, fronts)
        want = n1.nsga2_ranks_plain(objs, viol, N1_FEAS_TOL)
        check(torch.equal(got, want)
              and int(fronts) == int(want.max()) + 1,
              f"N1 differs from its plain version: {kind}, P={p}, M={m}")
        most = max(most, int(fronts))
    record(phase="kernel_vs_plain", kernel="nsga2_ranks", cases=len(cases),
           most_fronts=most, rule="torch.equal on the ranks and the front "
           "count")


def nsga2_cpu_vs_gpu(dsa, dev):
    """Phase 4's NSGA-II part: three generations on the card with handed
    draws, each held against the CPU with the same state and draws: the
    children within the band of pow (each device's own), the selection from
    the card's parents and children (ranks by N1 on the card, the plain
    loop on the CPU) equal in survivors, ranks and crowding."""
    from distributed_swarm_algorithm_tpu_torch.ops import nsga2 as tn
    st = tn.nsga2_init(tn.zdt1, MOO_N, MOO_DIM, seed=5, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(6)
    worst = 0.0
    for _ in range(3):
        cpu = st.replace(**{f: getattr(st, f).cpu()
                            for f in tn.NSGA2_TENSOR_FIELDS})
        draws = tn.variation_draws(cpu.pos, gen)
        on = lambda x: x.to(dev)  # noqa: E731
        draws_c = (on(draws[0]), on(draws[1]), tuple(map(on, draws[2])),
                   tuple(map(on, draws[3])))
        kids_c = tn.nsga2_offspring(st, draws=draws_c)
        kids = tn.nsga2_offspring(cpu, draws=draws)
        worst = max(worst, float((kids_c.cpu() - kids).abs().max()))
        check(torch.allclose(kids_c.cpu(), kids, rtol=1e-6, atol=1e-6),
              "NSGA-II: the card's children leave the band of the CPU's")
        objs = torch.cat([st.objs, tn.zdt1(kids_c)])
        viol = torch.cat([st.viol, torch.zeros_like(st.viol)])
        got = tn.nsga2_select(objs, viol, MOO_N)
        want = tn.nsga2_select(objs.cpu(), viol.cpu(), MOO_N)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              "NSGA-II: the card's survivors, ranks or crowding differ "
              "from the CPU's")
        st = tn.nsga2_step(st, tn.zdt1, draws=draws_c)
        check(torch.equal(st.rank, got[1].index_select(0, got[0])),
              "NSGA-II: the step's ranks are not its selection's")
    record(phase="cpu_vs_gpu", model="NSGA2", generations=3, pop=MOO_N,
           dim=MOO_DIM, children_max_abs_diff=worst,
           survivors_ranks_crowding="equal")


def n1_bound_ms(p, m):
    """N1's bound: P^2 M comparisons at the f32 peak against its bytes
    (objs and viol read once, the ranks and the front count written)."""
    ops = p * p * m
    nbytes = 4 * (p * m + p + p + 1)
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def n1_timed(n1, objs, viol, label, smi, reps=200):
    """N1 on one population: equal to its plain version, timed back to
    back and from a CUDA graph, beside the plain version and the bound,
    with its front count."""
    fronts = torch.zeros(1, dtype=torch.int32, device=objs.device)
    got = n1.nsga2_ranks_cuda(objs, viol, N1_FEAS_TOL, fronts)
    want, plain_ms = timed(lambda: n1.nsga2_ranks_plain(objs, viol,
                                                        N1_FEAS_TOL))
    check(torch.equal(got, want) and int(fronts) == int(want.max()) + 1,
          f"N1 differs from its plain version: {label}")
    ms = cuda_ms(lambda: n1.nsga2_ranks_cuda(objs, viol, N1_FEAS_TOL), reps)
    g_ms = graph_ms(lambda: n1.nsga2_ranks_cuda(objs, viol, N1_FEAS_TOL),
                    reps)
    bound, bound_by = n1_bound_ms(*objs.shape)
    rec = dict(state=label, shape=list(objs.shape), fronts=int(fronts),
               kernel_ms=ms, kernel_graph_ms=g_ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by, smi=smi)
    record(phase="nsga2_ranks_timing", **rec)
    return rec


def n1_front_cost(rows, smi):
    """N1's cost a front and its fixed part: the least-squares line of its
    times from a CUDA graph over the populations' front counts."""
    fronts = np.array([r["fronts"] for r in rows], np.float64)
    ms = np.array([r["kernel_graph_ms"] for r in rows], np.float64)
    slope, fixed = np.polyfit(fronts, ms, 1)
    rec = dict(phase="nsga2_ranks_fronts", fronts=fronts.tolist(),
               kernel_graph_ms=ms.tolist(), us_per_front=slope * 1e3,
               fixed_us=fixed * 1e3, smi=smi)
    record(**rec)
    return rec


def nsga2_steps(opt, steps):
    """``steps`` eager generations of ``opt`` (``NSGA2.step``): the loop
    that ``NSGA2.run`` replays from a CUDA graph on the card."""
    for _ in range(steps):
        opt.step()


def nsga2_full_width(dsa, n1, kernels, smi, t_start, dev):
    """Phase 15's NSGA-II part: bench_nsga2.py's configuration (ZDT1, a
    population of 512, D = 30) through ``NSGA2.run`` (replayed from a CUDA
    graph of one generation) for 1,000 generations after a warm-up run,
    timed with CUDA events: one N1 launch a generation and no other
    kernel, HV@(1.1, 1.1), IGD against the 256-point front and the front's
    size; beside it an eager loop of ``NSGA2.step`` from the same seed,
    timed in the same way, whose final state, HV, IGD and front equal the
    replayed run's; the population inside [0, 1] and every rank-0 member
    undominated; the device's busy share of each from a trace of 16
    generations; N1 at the first generation's population, at the final
    one's and on a chain of 1,024 fronts, against its plain version, timed
    beside it and its bound, with its cost a front."""
    from distributed_swarm_algorithm_tpu_torch.ops import nsga2 as tn
    reset_launches(kernels)
    opt = dsa.NSGA2("zdt1", n=MOO_N, dim=MOO_DIM, seed=0)
    init_launches = n1.LAUNCHES
    eager = dsa.NSGA2("zdt1", n=MOO_N, dim=MOO_DIM, seed=0)
    # The first generation's parents and children, the random state, drawn
    # from the run's generator; the eager loop's makes the same draw, so
    # both follow the same generations.
    first = opt.state
    kids = tn.nsga2_offspring(first)
    tn.nsga2_offspring(eager.state)
    objs0 = torch.cat([first.objs, tn.zdt1(kids)])
    viol0 = torch.zeros(2 * MOO_N, device=dev)
    opt.run(MOO_WARM)                          # warm-up run, the capture
    nsga2_steps(eager, MOO_WARM)
    reset_launches(kernels)
    _, run_ms = timed(lambda: opt.run(MOO_STEPS))
    launches = {name: m.LAUNCHES for name, m in kernels.items()}
    _, eager_ms = timed(lambda: nsga2_steps(eager, MOO_STEPS))
    st = opt.state
    same = all(torch.equal(getattr(st, f), getattr(eager.state, f))
               for f in tn.NSGA2_TENSOR_FIELDS)
    same = same and torch.equal(st.gen.get_state(),
                                eager.state.gen.get_state())
    hv, igd = opt.hypervolume([1.1, 1.1]), opt.igd()
    front = opt.pareto_front()
    eager_hv, eager_igd = eager.hypervolume([1.1, 1.1]), eager.igd()
    same = (same and hv == eager_hv and igd == eager_igd
            and np.array_equal(front, eager.pareto_front()))
    ms_gen, eager_gen = run_ms / MOO_STEPS, eager_ms / MOO_STEPS
    busy, per_gen, top = device_time(lambda: opt.run(16), 16)
    e_busy, e_per_gen, e_top = device_time(lambda: nsga2_steps(eager, 16),
                                           16)
    rec = dict(phase="full_width", model="NSGA2", problem="zdt1", pop=MOO_N,
               dim=MOO_DIM, generations=MOO_STEPS, launches=launches,
               run_ms=run_ms, ms_per_generation=ms_gen,
               generations_per_sec=MOO_STEPS / (run_ms / 1e3),
               hypervolume_at_1_1=hv, igd_256=igd,
               front_size=int(front.shape[0]), init_launches=init_launches,
               device_busy_ms_per_generation=busy,
               device_idle_share=None if busy is None else 1.0 - busy / ms_gen,
               device_ops_per_generation=per_gen, top_device_ops=top,
               eager_run_ms=eager_ms, eager_ms_per_generation=eager_gen,
               eager_generations_per_sec=MOO_STEPS / (eager_ms / 1e3),
               eager_device_busy_ms_per_generation=e_busy,
               eager_device_idle_share=(None if e_busy is None
                                        else 1.0 - e_busy / eager_gen),
               eager_device_ops_per_generation=e_per_gen,
               eager_top_device_ops=e_top, replayed_equals_eager=same,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               smi=smi, seconds_so_far=time.perf_counter() - t_start)
    record(**rec)
    hashgrid_launch_check(launches, "nsga2_ranks", MOO_STEPS)
    check(same, "NSGA-II: the replayed run differs from the eager loop "
          "(state, generator, HV, IGD or front)")
    check(bool((st.pos >= 0).all() and (st.pos <= 1).all()),
          "NSGA-II: a position left [0, 1]")
    dom = n1.domination_matrix(st.objs, st.viol, N1_FEAS_TOL)
    check(not bool(dom[:, st.rank == 0].any()),
          "NSGA-II: a rank-0 member is dominated")
    check(np.isfinite(hv) and 0.0 < hv <= 1.21 and np.isfinite(igd),
          f"NSGA-II: HV {hv} or IGD {igd} out of range")
    # N1 at the final generation's parents and children, and on a chain.
    kids = tn.nsga2_offspring(st)
    objs1 = torch.cat([st.objs, tn.zdt1(kids)])
    viol1 = torch.cat([st.viol, torch.zeros_like(st.viol)])
    rows = [n1_timed(n1, objs0, viol0, "first generation (random)", smi),
            n1_timed(n1, objs1, viol1, "final generation", smi)]
    chain, _ = n1_case("chain", 2 * MOO_N, 2, 7, dev)
    rows.append(n1_timed(n1, chain, None, "chain", smi, reps=20))
    n1_front_cost(rows, smi)
    final = rows[1]
    return dict(name="nsga2_ranks", route="cuda",
                source="distributed_swarm_algorithm_tpu_torch/csrc/"
                       "nsga2_ranks.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/nsga2.py:113",
                launches=launches["nsga2_ranks"], max_abs_err=0.0,
                ms=final["kernel_ms"], graph_ms=final["kernel_graph_ms"],
                plain_ms=final["plain_ms"], bound_ms=final["bound_ms"],
                bound_by=final["bound_by"], library_ms=None)


def chunked_run(opt, steps, chunks, snap):
    """``opt.run(steps)`` in ``chunks`` equal parts, timed with CUDA events
    as one, with ``snap(opt)`` (device copies, no read) after each."""
    seen = [snap(opt)]

    def go():
        for _ in range(chunks):
            opt.run(steps // chunks)
            seen.append(snap(opt))

    _, ms = timed(go)
    return ms, seen


def zoo_rest_full_width(dsa, kernels, smi, t_start):
    """Phase 15's CMA-ES, ES and MAP-Elites: each at its configuration
    after a warm-up run, timed with CUDA events, no kernel of the port
    launched; the best never rising (CMA-ES, ES), no cell's fitness rising
    and the coverage never falling (MAP-Elites), across chunks of the
    run."""
    for lam in CMA_LAMBDAS:
        opt = dsa.CMAES("rosenbrock", dim=CMA_DIM, n=lam, seed=0)
        opt.run(CMA_WARM)
        reset_launches(kernels)
        ms, bests = chunked_run(opt, CMA_STEPS, 5,
                                lambda o: o.state.best_fit.clone())
        launches = {k: m.LAUNCHES for k, m in kernels.items()}
        bests = [float(b) for b in bests]
        record(phase="full_width", model="CMAES", objective="rosenbrock",
               dim=CMA_DIM, popsize=opt.params.popsize,
               generations=CMA_STEPS, run_ms=ms,
               generations_per_sec=CMA_STEPS / (ms / 1e3),
               best_by_chunk=bests, sigma=float(opt.state.sigma),
               launches=sum(launches.values()), smi=smi,
               seconds_so_far=time.perf_counter() - t_start)
        check(all(a >= b for a, b in zip(bests, bests[1:]))
              and np.isfinite(bests[-1]), f"CMA-ES: the best rose: {bests}")
        check(bool(torch.isfinite(opt.state.cov).all()),
              "CMA-ES: the covariance is not finite")
        check(not any(launches.values()), "CMA-ES launched a port kernel")

    opt = dsa.ES("rastrigin", n=ES_N, dim=ES_DIM, seed=0)
    opt.run(ES_WARM)
    reset_launches(kernels)
    ms, bests = chunked_run(opt, ES_STEPS, 5,
                            lambda o: o.state.best_fit.clone())
    launches = {k: m.LAUNCHES for k, m in kernels.items()}
    bests = [float(b) for b in bests]
    record(phase="full_width", model="ES", objective="rastrigin", samples=ES_N,
           dim=ES_DIM, generations=ES_STEPS, run_ms=ms,
           generations_per_sec=ES_STEPS / (ms / 1e3), best_by_chunk=bests,
           max_abs_mean=float(opt.state.mean.abs().max()),
           launches=sum(launches.values()), smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    check(all(a >= b for a, b in zip(bests, bests[1:]))
          and np.isfinite(bests[-1]), f"ES: the best rose: {bests}")
    check(float(opt.state.mean.abs().max()) <= float(np.float32(5.12)),
          "ES: the mean left the domain")
    check(not any(launches.values()), "ES launched a port kernel")

    opt = dsa.MAPElites("rastrigin", dim=ME_DIM, bins=ME_BINS, batch=ME_BATCH,
                        seed=0)
    opt.run(ME_WARM)
    reset_launches(kernels)
    ms, fits = chunked_run(opt, ME_STEPS, 5,
                           lambda o: o.state.archive_fit.clone())
    launches = {k: m.LAUNCHES for k, m in kernels.items()}
    cover = [float(torch.isfinite(f).float().mean()) for f in fits]
    record(phase="full_width", model="MAPElites", objective="rastrigin",
           dim=ME_DIM, bins=ME_BINS, batch=ME_BATCH, generations=ME_STEPS,
           run_ms=ms, generations_per_sec=ME_STEPS / (ms / 1e3),
           coverage_by_chunk=cover, qd_score_offset_200=opt.qd_score(200.0),
           best=opt.best, launches=sum(launches.values()), smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
    check(all(bool((b <= a).all()) for a, b in zip(fits, fits[1:])),
          "MAP-Elites: a cell's fitness rose")
    check(all(a <= b for a, b in zip(cover, cover[1:])),
          f"MAP-Elites: the coverage fell: {cover}")
    check(not any(launches.values()), "MAP-Elites launched a port kernel")




def n2_case(kind, s, seed, dev):
    """[S, S] square values on the card for N2's cases: uniform utilities
    in [1, 100), all ties, an infeasible agent (a zero row) and column,
    a rectangular [S, 2S/3] problem squared by ``_square_values`` (N != T,
    a third of its pairs infeasible), a third of the agents with zero rows
    (some -0), and S/2 agents squared (S/2 virtual zero rows)."""
    from distributed_swarm_algorithm_tpu_torch.ops import auction as au
    rng = np.random.default_rng(seed)
    v = rng.uniform(1.0, 100.0, (s, s)).astype(np.float32)
    if kind == "ties":
        v[:] = 10.0
    elif kind == "infeasible":
        v[s // 3] = 0.0
        v[:, s // 2] = 0.0
    elif kind == "rect":
        util = torch.from_numpy(v[:, :2 * s // 3].copy())
        feasible = torch.from_numpy(rng.random(tuple(util.shape)) < 0.67)
        return au._square_values(util, feasible).to(dev)
    elif kind == "zeros":
        rows = rng.choice(s, s // 3, replace=False)
        v[rows] = 0.0
        v[rows[::2], ::3] = -0.0
    elif kind == "virtual":
        util = torch.from_numpy(v[:s // 2].copy())
        feasible = torch.from_numpy(rng.random(tuple(util.shape)) < 0.5)
        return au._square_values(util, feasible).to(dev)
    return torch.from_numpy(v).to(dev)


def n2_pair(n2, values, prices=None, cap=AUC_MAX_ROUNDS, run=True,
            counts=None):
    """(kernel's outputs, plain version's outputs, whether all four are
    equal) of one solve on the card."""
    s = values.shape[0]
    dev = values.device
    prices = torch.zeros(s, device=dev) if prices is None else prices
    eps = torch.full((), AUC_EPS, device=dev)
    flag = torch.full((), run, dtype=torch.bool, device=dev)
    got = n2.auction_square_cuda(values, prices, eps, cap, flag)
    want = n2.auction_square_plain(values, prices, eps, cap, flag,
                                   counts=counts)
    return got, want, all(torch.equal(a, b) for a, b in zip(got, want))


def n2_small_shapes(n2, dev):
    """Phase 3's N2 part: the kernel against its plain version under
    ``torch.equal`` on all four outputs at S = 1 and sizes off the block's
    multiple, all ties, an infeasible agent, N != T, zero rows (+-0, S not
    a multiple of 4) and virtual ones, the round cap (also mid-war), warm
    prices, the run flag off, both schedules the entry chooses at the edge
    between them (S = 7,792 on a cluster of 16, 7,793 on one block with
    the global scratch, both with zero rows), and S = 9,800 (zero rows)
    and 10,000 (the state past shared memory, in the global scratch of
    one block)."""
    cases = ([("uniform", s) for s in (1, 2, 3, 31, 33, 1000, 1023, 1025)]
             + [("ties", 40), ("ties", 1024), ("infeasible", 50),
                ("infeasible", 1031), ("rect", 300), ("rect", 1500),
                ("zeros", 101), ("zeros", 1030), ("virtual", 514),
                ("virtual", 4096), ("zeros", 7792), ("zeros", 7793),
                ("uniform", 10_000)])
    rounds, clusters = {}, {}
    for kind, s in cases:
        values = n2_case(kind, s, s + 7, dev)
        got, _, equal = n2_pair(n2, values)
        check(equal, f"N2 differs from its plain version: {kind}, S={s}")
        rounds[f"{kind} {s}"] = int(got[3])
        clusters[f"{kind} {s}"] = n2.cluster_size(s)
        del values
    check(clusters["zeros 7792"] == 16 and clusters["zeros 7793"] == 1,
          f"N2's schedules moved: {clusters}")
    values = n2_case("uniform", 256, 3, dev)
    warm = torch.rand(256, generator=torch.Generator(device=dev)
                      .manual_seed(1), device=dev) * 5.0
    for label, kw in (("cap 7", dict(cap=7)), ("warm prices",
                                              dict(prices=warm)),
                      ("run off", dict(run=False))):
        got, _, equal = n2_pair(n2, values, **kw)
        check(equal, f"N2 differs from its plain version: {label}")
        rounds[label] = int(got[3])
    got, _, equal = n2_pair(n2, n2_case("zeros", 600, 5, dev), cap=150)
    check(equal and int(got[3]) == 150 and bool((got[0] < 0).any()),
          "N2 differs from its plain version at the cap mid-war")
    rounds["cap 150 mid-war"] = int(got[3])
    values = n2_case("uniform", 9_800, 4, dev)
    values[::200] = 0.0
    got, _, equal = n2_pair(n2, values)
    check(equal and n2.cluster_size(9_800) == 1,
          "N2 differs from its plain version: zero rows, global scratch")
    rounds["zero rows 9800"] = int(got[3])
    check(rounds["run off"] == 0 and rounds["cap 7"] == 7,
          f"N2's round count is off: {rounds}")
    record(phase="kernel_vs_plain", kernel="auction",
           cases=len(cases) + 5, rounds=rounds, clusters=clusters,
           state_in_shared_up_to=max(s for s in range(1, 20_000)
                                     if n2._lib()[2](s)),
           rule="torch.equal on agent_task, task_agent, prices and rounds")


def n2_bound_ms(s, needed_rows, rounds):
    """N2's bound on one solve by the work the function needs: every value
    row once (round 1), then the rows of the unseated agents whose row is
    not all zero (the plain version's ``needed_rows``, S floats each), the
    starting prices and the four outputs, at HBM's rate (the L2's is not
    published; where [S, S] fits the 50 MB L2 the floor is lower still),
    against its operations (a subtraction and two comparisons a value read,
    and the zero rows' shared bid from the prices, a price a round) at the
    f32 peak.  The prices stay on the chip between rounds, so their scan
    counts as operations, not bytes."""
    nbytes = 4 * (needed_rows * s + s + 3 * s + 1)
    ops = 3 * (needed_rows + rounds) * s
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def n2_timed(n2, values, label, smi, reps=5):
    """N2 on one instance: equal to its plain version, its rounds, the rows
    they read in the plain version, the zero rows among them and the rows
    the function needs, the cluster, timed back to back and from a CUDA
    graph (and a round's time), beside the plain version's time and the
    bound."""
    counts = {}
    _, want, equal = n2_pair(n2, values, counts=counts)
    check(equal, f"N2 differs from its plain version: {label}")
    s = values.shape[0]
    prices = torch.zeros(s, device=values.device)
    eps = torch.full((), AUC_EPS, device=values.device)
    flag = torch.ones((), dtype=torch.bool, device=values.device)
    solve = lambda: n2.auction_square_cuda(  # noqa: E731
        values, prices, eps, AUC_MAX_ROUNDS, flag)
    ms = cuda_ms(solve, reps)
    g_ms = graph_ms(solve, reps)
    _, plain_ms = timed(lambda: n2.auction_square_plain(
        values, prices, eps, AUC_MAX_ROUNDS, flag))
    rounds = int(want[3])
    bound, bound_by = n2_bound_ms(s, counts["needed_rows"], rounds)
    rec = dict(instance=label, shape=[s, s], rounds=rounds,
               bidder_rows=counts["bidder_rows"],
               zero_rows=counts["zero_rows"],
               needed_rows=counts["needed_rows"],
               cluster=n2.cluster_size(s), kernel_ms=ms,
               kernel_graph_ms=g_ms, ms_per_round=ms / max(rounds, 1),
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
               seated=int((want[0] >= 0).sum()), smi=smi)
    record(phase="auction_timing", **rec)
    return rec


def bench_values(dev):
    """bench_auction.py's instances on the card, by label: uniform(1, 100)
    utilities from ``default_rng(0)`` at 1024^2 and 4096^2 (141 and 314
    rounds in its docstring), and its shallow price war at 1024^2
    (``price_war_util``: 8 hot tasks at 100 plus a jitter below 0.01, the
    rest in [0.5, 1); 398 rounds)."""
    out = {}
    for n in (1024, 4096):
        u = np.random.default_rng(0).uniform(1.0, 100.0, size=(n, n))
        out[f"uniform {n}"] = torch.from_numpy(u.astype(np.float32)).to(dev)
    rng = np.random.default_rng(7)
    u = rng.uniform(0.5, 1.0, size=(1024, 1024)).astype(np.float32)
    u[:, :8] = 100.0 + rng.uniform(0.0, 0.01, size=(1024, 8)).astype(
        np.float32)
    out["price war 1024, hot 100"] = torch.from_numpy(u).to(dev)
    return out


def auction_benches(n2, instances, smi):
    """N2 at bench_auction.py's instances, each at flat eps 0.25."""
    out = [n2_timed(n2, values, label, smi, reps=2 if "war" in label else 5)
           for label, values in instances.items()]
    check([r["rounds"] for r in out] == [141, 314, 398],
          f"the bench instances' rounds moved: {[r['rounds'] for r in out]}")
    return out


def auction_swarm(dsa, n, cfg, dev, tasks_seed=0):
    """BASELINE config 4's swarm (bench_allocation.py:22-32): ``n`` agents
    from make_swarm(seed=0, spread=50) and ``n`` tasks uniform in
    [-50, 50]^2 (numpy's draw from ``tasks_seed``)."""
    st = dsa.make_swarm(n, seed=0, spread=50.0, device=dev)
    task_pos = np.random.default_rng(tasks_seed).uniform(-50.0, 50.0,
                                                         (n, 2))
    return dsa.with_tasks(st, torch.from_numpy(task_pos.astype(np.float32))
                          .to(dev))


def auction_cpu_vs_gpu(dsa, dev):
    """Phase 4's auction part: the auction tick at 256 agents x 256 tasks
    on the CPU and on the card for 20 ticks from the same state (25 ticks
    in, so a leader emerges at tick 32 and the cadence re-solves at 40;
    an awarded winner killed at tick 35), with the same jitter and the
    agents pinned (max_speed 0, so both devices' utilities come from the
    same positions): task_winner, task_claimed and the FSM equal at every
    tick, one task per agent."""
    cfg = dsa.DEFAULT_CONFIG.replace(**AUC_CFG, max_speed=0.0)
    cpu = auction_swarm(dsa, AUC_CMP_N, cfg, "cpu")
    cpu = dsa.swarm_rollout(cpu, None, cfg, 25)
    gpu = dsa.state_from_numpy(dsa.state_to_numpy(cpu), device=dev)
    jitter = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.election_jitter_ticks + 1, (AUC_CMP_TICKS, AUC_CMP_N))
        .astype(np.int32))
    unequal, resolves = [], 0
    for k in range(AUC_CMP_TICKS):
        if k == 10:
            won = cpu.task_winner[cpu.task_winner >= 0]
            check(won.numel() > 0, "no task awarded at the kill")
            cpu = dsa.kill(cpu, [int(won[0])])
            gpu = dsa.kill(gpu, [int(won[0])])
        before = cpu.task_winner.clone()
        cpu = dsa.swarm_tick(cpu, None, cfg, jitter[k])
        gpu = dsa.swarm_tick(gpu, None, cfg, jitter[k].to(dev))
        resolves += int(not torch.equal(before, cpu.task_winner))
        for f in ("task_winner", "task_claimed", "fsm", "leader_id"):
            if not torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()):
                unequal.append((k, f))
        won = cpu.task_winner[cpu.task_winner >= 0]
        check(won.unique().numel() == won.numel(),
              "the auction gave an agent two tasks")
    awarded = int((cpu.task_winner >= 0).sum())
    record(phase="cpu_vs_gpu", model="auction tick", agents=AUC_CMP_N,
           tasks=AUC_CMP_N, ticks=AUC_CMP_TICKS, awarded=awarded,
           ticks_with_new_awards=resolves, unequal=unequal,
           max_util_diff=float((cpu.task_util - gpu.task_util.cpu()).abs()
                               .max()))
    check(not unequal, f"the auction tick differs CPU vs GPU: {unequal}")
    check(awarded > 0 and resolves >= 2,
          "the compared ticks re-solved too rarely")


def auction_replay_vs_eager(dsa, kernels, smi, dev):
    """Phase 16's auction rollout replayed from CUDA graphs against the
    eager one: BASELINE config 4 as the auction tick in "window"
    separation with a re-sort every ``AUC_EVERY`` ticks (the "pallas"
    tick runs eagerly; the window rollout replays its chunks, N2 captured
    in each tick), ``AUC_KILL_AT`` ticks, the first awarded winner killed,
    the rest of ``AUC_TICKS``; each run from its own copy of the
    generator.  Every state field equal bit for bit, N2 and B4 once a
    tick in each run, re-solves in the span."""
    from distributed_swarm_algorithm_tpu_torch.models import swarm as swm
    from distributed_swarm_algorithm_tpu_torch.state import TENSOR_FIELDS
    cfg = dsa.DEFAULT_CONFIG.replace(**dict(
        AUC_CFG, separation_mode="window", sort_every=AUC_EVERY))
    st0 = auction_swarm(dsa, AUC_N, cfg, dev)
    outs, runs = {}, {}
    for replay in (False, True):
        st = copy_gen(st0, dev)
        reset_launches(kernels)
        with replaying(swm, replay):
            def rollout(s=st):
                s = dsa.swarm_rollout(s, None, cfg, AUC_KILL_AT)
                won = s.task_winner[s.task_winner >= 0]
                check(won.numel() > 0, "no task awarded at the kill")
                s = dsa.kill(s, [int(won[0])])
                return dsa.swarm_rollout(s, None, cfg,
                                         AUC_TICKS - AUC_KILL_AT)
            out, ms = timed(rollout)
        launches = {k: m.LAUNCHES for k, m in kernels.items()}
        outs[replay] = out
        runs["replayed" if replay else "eager"] = dict(
            ms_per_tick=ms / AUC_TICKS, launches=launches)
        want = {name: 0 for name in launches}
        want.update(auction=AUC_TICKS, window_separation=AUC_TICKS)
        check(launches == want, f"unexpected launches {launches}, "
              f"replay {replay}")
    unequal = [f for f in TENSOR_FIELDS
               if not torch.equal(getattr(outs[False], f),
                                  getattr(outs[True], f))]
    won = outs[True].task_winner[outs[True].task_winner >= 0]
    record(phase="auction_replay_vs_eager", agents=AUC_N, tasks=AUC_N,
           ticks=AUC_TICKS, kill_at=AUC_KILL_AT, separation_mode="window",
           sort_every=AUC_EVERY, chunk_captured=swm._chunk is not None,
           awarded=int(won.numel()), runs=runs, unequal_fields=unequal,
           smi=smi)
    check(not unequal, f"the replayed auction rollout differs from the "
          f"eager one in {unequal}")
    check(won.numel() > 0 and won.unique().numel() == won.numel(),
          "the replayed auction gave an agent two tasks, or none")


def auction_full_width(dsa, n2, kernels, smi, t_start, dev):
    """Phase 16's auction: BASELINE config 4 as an auction tick
    (``allocation_mode="auction"``, ``auction_every`` 10, the "pallas"
    separation, B1) through ``swarm_tick``, 100 ticks with an awarded
    winner killed at tick 60, each tick timed with CUDA events and split
    into re-solve ticks and the others (a tick re-solves where a leader
    exists and the cadence, an eviction or the leader's emergence calls
    for it, as the tick decides on the device); N2 once a tick; one task
    per agent, every winner alive; N2 at the final tick's own values
    against its plain version, timed beside it and its bound; then the
    bench instances."""
    from distributed_swarm_algorithm_tpu_torch.ops import allocation as al
    from distributed_swarm_algorithm_tpu_torch.ops import auction as au
    from distributed_swarm_algorithm_tpu_torch.state import LEADER
    cfg = dsa.DEFAULT_CONFIG.replace(**AUC_CFG)
    warm = auction_swarm(dsa, AUC_N, cfg, dev)
    for _ in range(4):
        warm = dsa.swarm_tick(warm, None, cfg)
    del warm
    st = auction_swarm(dsa, AUC_N, cfg, dev)
    reset_launches(kernels)
    ms, resolve, had = [], [], False
    for k in range(AUC_TICKS):
        evict = False
        if k == AUC_KILL_AT:
            won = st.task_winner[st.task_winner >= 0]
            check(won.numel() > 0, "no task awarded at the kill")
            st = dsa.kill(st, [int(won[0])])
            evict = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st = dsa.swarm_tick(st, None, cfg)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        has = bool((st.alive & (st.fsm == LEADER)).any())
        resolve.append(has and (int(st.tick) % AUC_EVERY == 0 or evict
                                or not had))
        had = has
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    won = st.task_winner[st.task_winner >= 0]
    alive_ids = st.agent_id[st.alive]
    solve_ms = [m for m, r in zip(ms, resolve) if r]
    other_ms = [m for m, r in zip(ms, resolve) if not r]
    rec = dict(phase="full_width", model="auction tick", agents=AUC_N,
               tasks=AUC_N, ticks=AUC_TICKS, auction_every=AUC_EVERY,
               separation_mode=cfg.separation_mode, launches=launches,
               resolve_ticks=[k + 1 for k, r in enumerate(resolve) if r],
               ms_per_tick=sum(ms) / AUC_TICKS,
               ms_per_resolve_tick=float(np.mean(solve_ms)),
               ms_resolve_ticks=solve_ms,
               ms_per_other_tick=float(np.mean(other_ms)),
               ms_per_other_tick_median=float(np.median(other_ms)),
               awarded=int(won.numel()), task_util_sum=float(st.task_util
                                                             .sum()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               smi=smi, seconds_so_far=time.perf_counter() - t_start)
    record(**rec)
    want = {name: 0 for name in launches}
    want.update(auction=AUC_TICKS, separation=AUC_TICKS)
    check(launches == want, f"unexpected launches {launches}")
    check(len(solve_ms) >= 3, f"too few re-solves: {rec['resolve_ticks']}")
    check(max(solve_ms) < 100.0,
          f"a re-solve tick passed the 100 ms period: {solve_ms}")
    check(won.unique().numel() == won.numel() and won.numel() > 0,
          "the auction gave an agent two tasks, or none was awarded")
    check(bool(torch.isin(won, alive_ids).all()), "a dead agent won a task")
    # N2 at the main path's shape: the final tick's own square values.
    u = al.utility_matrix(st, cfg)
    values = au._square_values(u, st.alive[:, None]
                               & (u > cfg.utility_threshold))
    main = n2_timed(n2, values, "the final tick's utilities", smi)
    instances = bench_values(dev)
    benches = auction_benches(n2, instances, smi)
    del values, instances
    auction_replay_vs_eager(dsa, kernels, smi, dev)
    return dict(name="auction", route="cuda",
                source="distributed_swarm_algorithm_tpu_torch/csrc/"
                       "auction.cu",
                replaces="distributed_swarm_algorithm_tpu/ops/auction.py:148",
                launches=launches["auction"], max_abs_err=0.0,
                ms=main["kernel_ms"], graph_ms=main["kernel_graph_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                rounds=main["rounds"], ms_per_round=main["ms_per_round"],
                needed_rows=main["needed_rows"],
                zero_rows=main["zero_rows"], cluster=main["cluster"],
                benches={r["instance"]: dict(
                    rounds=r["rounds"], ms=r["kernel_ms"],
                    graph_ms=r["kernel_graph_ms"], bound_ms=r["bound_ms"],
                    ms_per_round=r["ms_per_round"], cluster=r["cluster"])
                    for r in benches})


def field_swarm(dsa, dev):
    """decompose_rebuild.py:67-80's station: 65,536 agents from
    make_swarm(seed=0, spread=250), four tasks, each agent's target its
    own start."""
    st = dsa.make_swarm(HG_N, seed=0, spread=HG_SPREAD, device=dev)
    st = dsa.with_tasks(st, BENCH_TASKS)
    return st.replace(target=st.pos.clone(),
                      has_target=torch.ones_like(st.has_target))


def copy_gen(state, dev):
    gen = torch.Generator(device=dev)
    gen.set_state(state.gen.get_state())
    return state.replace(gen=gen)


def field_full_width(dsa, kernels, smi, t_start, dev):
    """Phase 16's field: the field tick at decompose_rebuild.py:67-94,
    287-294's station (65,536 agents, hw 256, skin 0, cap 16, rescue
    1,024, max_speed 1, sort_every 1; k_align 0.3, k_coh 0.1) on the slots
    kernel (B2), in both deposits, beside the same tick with the field
    off: each rollout of FIELD_TICKS ticks replayed in chunks, B2 once a
    tick and no other kernel; two runs from the same state equal bit for
    bit; the replayed rollout equal to the eager one across a kill; a
    trace of two replayed chunks; the deposit twice on the final state
    equal, and within the field's band of the CPU's."""
    from distributed_swarm_algorithm_tpu_torch.models import swarm as swm
    from distributed_swarm_algorithm_tpu_torch.ops import grid_moments as gm
    from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as hp
    from distributed_swarm_algorithm_tpu_torch.state import TENSOR_FIELDS
    base = dsa.DEFAULT_CONFIG.replace(**FIELD_CFG)
    chunk = swm.HASHGRID_CHUNK
    rows = {}
    for name, cfg in (("field off", base.replace(k_align=0.0, k_coh=0.0)),
                      ("scatter", base),
                      ("sorted", base.replace(field_deposit="sorted"))):
        st0 = field_swarm(dsa, dev)
        plan = dsa.build_tick_plan(st0, cfg)
        check(plan.has_field == (name != "field off"),
              f"{name}: the plan carries the field keys wrongly")
        st = copy_gen(st0, dev)
        dsa.swarm_rollout(st, None, cfg, chunk)   # the capture, kept
        saved = st.gen.get_state()
        reset_launches(kernels)
        out, run_ms = timed(lambda: dsa.swarm_rollout(st, None, cfg,
                                                      FIELD_TICKS))
        launches = {k: m.LAUNCHES for k, m in kernels.items()}
        hashgrid_launch_check(launches, "grid_separation", FIELD_TICKS)
        st.gen.set_state(saved)
        again = dsa.swarm_rollout(st, None, cfg, FIELD_TICKS)
        repeat_unequal = [f for f in TENSOR_FIELDS
                          if not torch.equal(getattr(out, f),
                                             getattr(again, f))]
        outs = {}
        for replay in (False, True):
            s = copy_gen(st0, dev)
            with replaying(swm, replay):
                s = dsa.swarm_rollout(s, None, cfg, FIELD_CMP_TICKS[0])
                s = dsa.kill(s, [HG_N - 1, 7])
                s = dsa.swarm_rollout(s, None, cfg, FIELD_CMP_TICKS[1])
            outs[replay] = s
        replay_unequal = [f for f in TENSOR_FIELDS
                          if not torch.equal(getattr(outs[False], f),
                                             getattr(outs[True], f))]
        busy, ops, top = device_time(
            lambda: dsa.swarm_rollout(out, None, cfg, 2 * chunk), 2 * chunk)
        ms_tick = run_ms / FIELD_TICKS
        rows[name] = dict(ms_per_tick=ms_tick, launches=launches)
        record(phase="full_width", model="field tick", scenario=name,
               agents=HG_N, ticks=FIELD_TICKS, chunk_ticks=chunk,
               launches=launches, run_ms=run_ms, ms_per_tick=ms_tick,
               agent_steps_per_sec=HG_N * FIELD_TICKS / (run_ms / 1e3),
               plan_has_field=plan.has_field,
               repeat_unequal_fields=repeat_unequal,
               replay_vs_eager_unequal_fields=replay_unequal,
               device_busy_ms_per_tick=busy,
               device_idle_share=None if busy is None else 1.0 - busy
               / ms_tick, device_ops_per_tick=ops, top_device_ops=top,
               max_abs_vel=float(out.vel.abs().max()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               smi=smi, seconds_so_far=time.perf_counter() - t_start)
        check(not repeat_unequal, f"{name}: two runs differ in "
              f"{repeat_unequal}")
        check(not replay_unequal, f"{name}: the replayed rollout differs "
              f"from the eager one in {replay_unequal}")
        check(bool(torch.isfinite(out.pos).all()), f"{name}: non-finite")
    # The deposit on the final state, twice on the card and on the CPU.
    cfg = base.replace(field_deposit="sorted")
    plan = dsa.build_tick_plan(out, cfg)
    keys = hp.plan_field_keys(plan)
    args = (out.pos, out.vel, out.alive, HG_HW, base.grid_cell)
    for deposit, kw in (("scatter", {}), ("sorted", dict(plan=plan))):
        one = gm.cic_field_commensurate(*args, keys=keys, deposit=deposit,
                                        **kw)
        two = gm.cic_field_commensurate(*args, keys=keys, deposit=deposit,
                                        **kw)
        check(all(torch.equal(a, b) for a, b in zip(one, two)),
              f"the {deposit} deposit differs between two runs")
        cpu = gm.cic_field_commensurate(*(a.cpu() if torch.is_tensor(a)
                                          else a for a in args),
                                        deposit="scatter")
        worst = max(float(((a.cpu() - b).abs() - 2e-4 * b.abs()).max()
                          / max(float(b.abs().max()), 1.0))
                    for a, b in zip(one, cpu))
        dep_ms = cuda_ms(lambda: gm.cic_field_commensurate(
            *args, keys=keys, deposit=deposit, **kw), 20)
        record(phase="field_deposit", deposit=deposit, agents=HG_N,
               ms=dep_ms, repeat_equal=True,
               worst_excess_over_band_vs_cpu=worst, smi=smi)
        check(worst <= 2e-5, f"the {deposit} field leaves the band of the "
              f"CPU's: {worst}")
    off, on = rows["field off"]["ms_per_tick"], rows["scatter"]["ms_per_tick"]
    record(phase="field_tick_cost", ms_per_tick_field_off=off,
           ms_per_tick_scatter=on,
           ms_per_tick_sorted=rows["sorted"]["ms_per_tick"],
           field_ms_per_tick=on - off, smi=smi)
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
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        nsga2_ranks as n1,
    )
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        auction as n2,
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
               "aco_deposit": LaunchCount(af, "DEPOSIT_LAUNCHES"),
               "nsga2_ranks": n1, "auction": n2}
    sources = ["separation", "window_separation", "grid_separation",
               "candidate_sweep", "pso_fused",
               *(f"{fam}_fused" for fam in zoo),
               *(f"{fam}_fused" for fam in rot),
               *LEVY_SOURCES.values(), "firefly_fused", "aco_fused",
               "nsga2_ranks", "auction"]
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    record(phase="device", kind=kind, nvidia_smi=smi,
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda, max_sm_clock_mhz=clock_mhz)

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build(sources)
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
             for name in sources}
    record(phase="build", seconds=time.perf_counter() - t0,
           per_source=per_source, ptxas=ptxas)
    record(phase="redesigned_builds", ptxas={
        name: ptxas[name] for name in ("firefly_fused", "gwo_fused")},
        gwo_sass=sass_census(_build, "gwo_fused", "gwo_fused_kernelILi2E"))
    # PR 11's redesigns: the census of the main path's kernels, whose step
    # loops give the issue floors of phases 8, 9 and 14.
    census = dict(clock_mhz=clock_mhz,
                  tours=sass_census(_build, "aco_fused", TOURS_MAIN),
                  tours_k2=sass_census(_build, "aco_fused", TOURS_MAIN_K2),
                  pso=sass_census(_build, "pso_fused", PSO_MAIN))
    record(phase="redesigned_builds_pr11", **census,
           tours_step_loop=step_loop(census["tours"]),
           pso_step_and_chunk_loops=step_loop(census["pso"]))
    for group in REDESIGNED:
        redesigned_census(_build, census, group)

    # 3. kernels vs plain on the card ---------------------------------------
    separation_small_shapes(sep, dev)
    for label, n, box, dead, co, window, presorted in (
        ("n=300, 20% dead, co-located trio", 300, 5.0, 0.2, True, 8, True),
        ("n=5000 unsorted", 5000, 40.0, 0.0, False, 16, False),
        ("n=1048576 spread 1000", WIN_N, BENCH_SPREAD, 0.0, False, 16, True),
        ("n=4096, W=600 (staged halo)", 4096, 20.0, 0.0, False, 600, True),
        ("n=4096, W=3000 (global reads)", 4096, 20.0, 0.0, False, 3000,
         True),
        ("n=4096 crowded, every shift near", 4096, 0.4, 0.0, False, 16,
         True),
        ("n=20000, 90% dead", 20000, 20.0, 0.9, False, 16, True),
        ("n=5000, all dead", 5000, 2.0, 1.01, False, 16, True),
        ("n=7777, W=40 (three groups)", 7777, 25.0, 0.1, False, 40, True),
        ("n=6000, W=1500 (the widest staged halo)", 6000, 60.0, 0.0, False,
         1500, True),
        ("n=37 (a partial warp)", 37, 1.0, 0.0, False, 16, True),
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
    n1_small_shapes(n1, dev)
    n2_small_shapes(n2, dev)

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
    nsga2_cpu_vs_gpu(dsa, dev)
    auction_cpu_vs_gpu(dsa, dev)

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
    # The first span pays the chunk's capture, the second (after the kill,
    # the same swarm) replays it alone.
    replay_ms_per_tick = spans[1] / (WIN_TICKS - WIN_KILL_AFTER)
    record(phase="window_replay", agents=WIN_N, sort_every=WIN_SORT_EVERY,
           ms_per_tick_capture_span=spans[0] / WIN_KILL_AFTER,
           ms_per_tick_replay_span=replay_ms_per_tick,
           agent_steps_per_sec_replay_span=WIN_N / (replay_ms_per_tick / 1e3),
           smi=smi)
    # The trace of 16 more ticks: two replayed chunks.  CUPTI reports each
    # kernel a graph launches as its own kernel activity, so the sums are
    # the device's busy time as in an eager trace.
    busy_ms, kernels_per_tick, top = device_breakdown(sw, 2 * WIN_SORT_EVERY)
    record(phase="window_tick_breakdown", agents=WIN_N,
           profiled_ticks=2 * WIN_SORT_EVERY, ms_per_tick=ms_per_tick,
           ms_per_tick_replay_span=replay_ms_per_tick,
           device_busy_ms_per_tick=busy_ms,
           device_idle_share=(None if busy_ms is None
                              else 1.0 - busy_ms / ms_per_tick),
           device_idle_share_replay_span=(
               None if busy_ms is None
               else 1.0 - busy_ms / replay_ms_per_tick),
           device_ops_per_tick=kernels_per_tick, top_device_ops=top, smi=smi)
    state = sw.state
    window_replay_vs_eager(dsa, state, wcfg, dev)

    # The window kernel at the main path's shape and order (the final
    # state, sorted at most 8 ticks ago).
    pos, alive = state.pos, state.alive
    _, win_cmp = compare_window(win, nb, pos, alive, WINDOW, True,
                                "main path, final state")
    win_ms = cuda_ms(lambda: win.separation_window_cuda(
        pos, alive, K_SEP, R, EPS, WINDOW), 50)
    win_graph_ms = graph_ms(lambda: win.separation_window_cuda(
        pos, alive, K_SEP, R, EPS, WINDOW), 50)
    win_plain_ms = cuda_ms(lambda: nb.separation_window(
        pos, alive, K_SEP, R, EPS, CELL, WINDOW, presorted=True), 5)
    win_bound_ms, win_bound_by, tests, near = window_bound_ms(pos, alive)
    counts = window_queue_counts(pos, alive)
    # The card's counts are the numpy model's on a slice of the state.
    part = 32 * 640
    _, model = win.near_pair_queue(pos[:part].cpu().numpy(),
                                   alive[:part].cpu().numpy(), K_SEP, R, EPS,
                                   WINDOW)
    mine = window_queue_counts(pos[:part], alive[:part])
    check(all(np.array_equal(a.cpu().numpy(), b[:, 0])
              for a, b in zip(mine, model)),
          "the queue counts on the card differ from the numpy model's")
    win_floor = window_issue_floor(census["window"], counts,
                                   256 + 2 * WINDOW, census["clock_mhz"])
    total, most, crowded, rounds, sums = counts
    record(phase="window_timing", shape=[WIN_N, 2], window=WINDOW,
           kernel_ms=win_ms, kernel_graph_ms=win_graph_ms,
           plain_ms=win_plain_ms, bound_ms=win_bound_ms,
           bound_by=win_bound_by, pair_tests=tests, near_pairs=near,
           warps=int(total.numel()), crowded_warps=int(crowded.sum()),
           queue_rounds=int(rounds.sum()), most_per_lane_mean=float(
               most.double().mean()),
           issue_floor=win_floor[0], issue_floor_ms=win_floor[1],
           ptxas=census.get("window_ptxas"),
           kernel_share_of_tick=win_ms / ms_per_tick,
           kernel_share_of_replayed_tick=win_ms / replay_ms_per_tick,
           smi=smi, seconds_so_far=time.perf_counter() - t_start)

    del sw, state, pos, alive

    # 7. the main path at full width, "hashgrid" ----------------------------
    # Each rollout replays chunks of HASHGRID_CHUNK ticks from one captured
    # CUDA graph: the span before the kill pays the capture, the span
    # after it replays the kept capture alone.
    from distributed_swarm_algorithm_tpu_torch.models import swarm as swm
    chunk = swm.HASHGRID_CHUNK
    hg = {}
    for name, station in (("station", True), ("converge", False)):
        hcfg = dsa.DEFAULT_CONFIG.replace(**HG_BASE)
        budget = hcfg.hashgrid_overflow_budget
        sw, launches, leaders, spans = run_hashgrid(dsa, kernels, hcfg,
                                                    station)
        total_ms = sum(spans)
        ms_per_tick = total_ms / HG_TICKS
        replay_ms = spans[1] / (HG_TICKS - HG_KILL_AFTER)
        state = sw.state
        plan = dsa.build_tick_plan(state, hcfg)
        live_over = int(plan.cap_overflow)
        record(
            phase="full_width", agents=HG_N, ticks=HG_TICKS,
            separation_mode="hashgrid", hashgrid_kernel="slots",
            scenario=name, leaders=leaders, launches=launches,
            ms_per_tick=ms_per_tick,
            ms_per_tick_capture_span=spans[0] / HG_KILL_AFTER,
            ms_per_tick_after_kill=replay_ms, chunk_ticks=chunk,
            agent_steps_per_sec=HG_N * HG_TICKS / (total_ms / 1e3),
            tasks_awarded=int((state.task_winner >= 0).sum()),
            final_cap_overflow=live_over,
            final_rescued=min(live_over, budget),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        hashgrid_launch_check(launches, "grid_separation", HG_TICKS)
        if station:
            # Two replayed chunks.
            busy_ms, per_tick, top = device_breakdown(sw, 2 * chunk)
            record(phase="hashgrid_tick_breakdown", agents=HG_N,
                   scenario=name, profiled_ticks=2 * chunk,
                   ms_per_tick=ms_per_tick, ms_per_tick_replay_span=replay_ms,
                   device_busy_ms_per_tick=busy_ms,
                   device_idle_share=(None if busy_ms is None
                                      else 1.0 - busy_ms / ms_per_tick),
                   device_idle_share_replay_span=(
                       None if busy_ms is None
                       else 1.0 - busy_ms / replay_ms),
                   device_ops_per_tick=per_tick, top_device_ops=top, smi=smi)
            state = sw.state
            plan_build_share(dsa, state, hcfg, ms_per_tick, busy_ms, per_tick,
                             smi)
            cap_ms, rep_ms = capture_cost_ms(dsa, swm, state, hcfg, chunk)
            record(phase="hashgrid_capture", scenario=name, chunk_ticks=chunk,
                   capture_and_replay_ms=cap_ms, replay_ms=rep_ms,
                   capture_ms=cap_ms - rep_ms, smi=smi)
            plan = dsa.build_tick_plan(state, hcfg)
        else:
            check(live_over > 0, "the converge run shows no cap overflow")
        cmp, args = compare_grid_sweep(grid, state.pos, plan, budget,
                                       f"main path, {name} final state")
        if not station:
            check(cmp["rescued"] == min(live_over, budget),
                  "the converge state's rescue is not engaged in full")
        pos_f = state.pos
        ms = cuda_ms(lambda: grid.grid_sweep_cuda(*args), 50)
        g_ms = graph_ms(lambda: grid.grid_sweep_cuda(*args), 50)
        no_rescue = args[:4] + (0,) + args[5:]
        g_no_rescue = graph_ms(lambda: grid.grid_sweep_cuda(*no_rescue), 50)
        whole_ms = graph_ms(lambda: grid.grid_sweep_cuda(
            grid.sweep_operands(pos_f, plan), *args[1:]), 50)
        plain_ms = cuda_ms(lambda: grid.grid_sweep_plain(*args), 3,
                           warmup=False)
        bound_ms, bound_by, tests, near, planes_ms = grid_bound_ms(grid, args)
        floor = grid_issue_floor(grid, census["grid"], args,
                                 census["clock_mhz"])
        hg[name] = dict(launches=launches["grid_separation"], cmp=cmp,
                        ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
        record(phase="grid_separation_timing", scenario=name,
               grid=[plan.g, plan.g, plan.max_per_cell], kernel_ms=ms,
               kernel_graph_ms=g_ms, kernel_graph_ms_budget_0=g_no_rescue,
               rescue_device_ms=g_ms - g_no_rescue,
               whole_function_graph_ms=whole_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               planes_bound_ms=planes_ms, pair_tests=tests, near_pairs=near,
               issue_floor=floor, ptxas=census.get("grid_ptxas"),
               kernel_share_of_replayed_tick=g_ms / replay_ms, smi=smi,
               seconds_so_far=time.perf_counter() - t_start)
        del sw, state, plan, args, no_rescue, pos_f

    fcfg = dsa.DEFAULT_CONFIG.replace(**dict(HG_BASE, **HG_FAST))
    settle = dsa.DEFAULT_CONFIG.replace(**HG_BASE, max_speed=5.0)
    swm.CHUNKS_RERUN = 0
    state, plan, launches, leaders, spans, counters = run_fast_movers(
        dsa, kernels, settle, fcfg)
    total_ms = sum(spans)
    ms_per_tick = total_ms / HG_TICKS
    replay_ms = spans[1] / (HG_TICKS - HG_KILL_AFTER)
    record(
        phase="full_width", agents=HG_N, ticks=HG_TICKS,
        separation_mode="hashgrid", hashgrid_kernel="candidates",
        scenario="fast movers, partial refresh", leaders=leaders,
        launches=launches, ms_per_tick=ms_per_tick,
        ms_per_tick_capture_span=spans[0] / HG_KILL_AFTER,
        ms_per_tick_after_kill=replay_ms, chunk_ticks=chunk,
        chunks_rerun=swm.CHUNKS_RERUN,
        agent_steps_per_sec=HG_N * HG_TICKS / (total_ms / 1e3),
        plan_counters_per_half=counters,
        table_shapes=dict(g=plan.g, W=plan.cand.shape[1],
                          RK=plan.recv.shape[1]),
    )
    hashgrid_launch_check(launches, "candidate_sweep", HG_TICKS)
    cand_launches = launches["candidate_sweep"]
    # Two replayed chunks of the fast movers, beside the station's trace.
    busy_ms, per_tick, top = device_time(
        lambda: dsa.swarm_rollout(state, None, fcfg, 2 * chunk), 2 * chunk)
    record(phase="hashgrid_tick_breakdown", agents=HG_N,
           scenario="fast movers, partial refresh", profiled_ticks=2 * chunk,
           ms_per_tick=ms_per_tick, ms_per_tick_replay_span=replay_ms,
           device_busy_ms_per_tick=busy_ms,
           device_idle_share_replay_span=(None if busy_ms is None
                                          else 1.0 - busy_ms / replay_ms),
           device_ops_per_tick=per_tick, top_device_ops=top, smi=smi)
    cap_ms, rep_ms = capture_cost_ms(dsa, swm, state, fcfg, chunk)
    record(phase="hashgrid_capture", scenario="fast movers", chunk_ticks=chunk,
           capture_and_replay_ms=cap_ms, replay_ms=rep_ms,
           capture_ms=cap_ms - rep_ms, smi=smi)
    plan = hp.refresh_plan_partial(state.pos, state.alive, plan)
    cand_cmp = compare_candidates(cand, state.pos, plan,
                                  "main path, fast-mover final state")
    check(cand_cmp["bitwise_equal"],
          "the candidate kernel differs from its plain version")
    args = (state.pos, plan.cand, plan.recv, K_SEP, R, EPS, plan.torus_hw)
    cand_b2b_ms = cuda_ms(lambda: cand.candidate_sweep_cuda(*args), 50)
    cand_ms = graph_ms(lambda: cand.candidate_sweep_cuda(*args), 50)
    cand_plain_ms = cuda_ms(lambda: cand.candidate_sweep_plain(*args), 5)
    cand_bound_ms, cand_bound_by, tests, near, tables_ms = candidate_bound_ms(
        cand, state.pos, plan)
    cand_floor = candidate_issue_floor(cand, census["cand"], state.pos, plan,
                                       census["clock_mhz"])
    record(phase="candidate_sweep_timing", tables=[plan.g * plan.g,
                                                   plan.cand.shape[1],
                                                   plan.recv.shape[1]],
           kernel_ms=cand_b2b_ms, kernel_graph_ms=cand_ms,
           plain_ms=cand_plain_ms, bound_ms=cand_bound_ms,
           bound_by=cand_bound_by, tables_bound_ms=tables_ms,
           pair_tests=tests, near_pairs=near,
           cells_per_warp=cand.cells_per_warp(plan.cand.shape[1]),
           issue_floor=cand_floor, ptxas=census.get("cand_ptxas"),
           kernel_share_of_replayed_tick=cand_ms / replay_ms, smi=smi,
           seconds_so_far=time.perf_counter() - t_start)
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
    per_element, pso_floor = pso_issue_floor(census["pso"], PSO_N, PSO_DIM,
                                             PSO_K, clock_mhz)
    record(phase="pso_fused_timing", shape=[PSO_DIM, PSO_N], k_steps=PSO_K,
           kernel_ms=pso_ms, plain_ms=pso_plain_ms, bound_ms=pso_bound,
           bound_by=pso_bound_by, operations=ops, bytes=nbytes,
           issue_floor_ms=pso_floor,
           instructions_per_element_step=per_element,
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
           issue_floor_ms=pso_issue_floor(census["pso"], ISL_I * ISL_N,
                                          PSO_DIM, PSO_K, clock_mhz)[1],
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
    zoo_rows = [zoo_full_width(dsa, fam, mod, kernels, smi, t_start, dev,
                               census) for fam, mod in zoo.items()]

    # 12. DE, SHADE, GA and moth-flame optimization at full width ----------
    rot_rows = [rot_full_width(dsa, fam, rot, kernels, smi, t_start, dev,
                               census) for fam in rot]

    # 13. cuckoo, Harris hawks, ABC and parallel tempering at full width ----
    levy_rows = [levy_full_width(dsa, fam, levy, kernels, smi, t_start,
                                 dev, census) for fam in levy]

    # 14. firefly and ACO at full width ---------------------------------------
    ff_row = firefly_full_width(dsa, ff, kernels, smi, t_start, dev)
    aco_rows = aco_full_width(dsa, af, kernels, smi, t_start, dev, census)

    # 15. NSGA-II, CMA-ES, ES and MAP-Elites at full width -----------------
    n1_row = nsga2_full_width(dsa, n1, kernels, smi, t_start, dev)
    zoo_rest_full_width(dsa, kernels, smi, t_start)

    # 16. the auction tick, N2 and the field tick at full width -----------
    n2_row = auction_full_width(dsa, n2, kernels, smi, t_start, dev)
    field_full_width(dsa, kernels, smi, t_start, dev)

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
            "graph_ms": station["graph_ms"],
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
            "ms": cand_b2b_ms,
            "graph_ms": cand_ms,
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
        n1_row,
        n2_row,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
