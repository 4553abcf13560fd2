"""Configuration for the TPU-native swarm framework.

The reference hard-codes every tunable as a literal inside ``agent.py``
(see SURVEY.md §5 "Config / flag system").  This module lifts each of them
into a single frozen dataclass so the whole framework is configured in one
place and the config can be passed as a *static* argument to ``jax.jit``
(it is hashable because it is frozen and contains only leaf values).

Reference provenance for each default (file:line in /root/reference):
  - loop rate 10 Hz                       agent.py:68
  - heartbeat every 10th tick (1 Hz)      agent.py:288
  - election timeout 3.0 s (= 30 ticks)   agent.py:222
  - election jitter U(0, 0.2) s           agent.py:229
  - max_speed 5.0 m/s                     agent.py:49
  - k_att 1.0, arrival tolerance 0.5 m    agent.py:118,123
  - k_rep 50.0, rho_0 5.0 m               agent.py:128-129
  - distance clamp 0.001                  agent.py:135,154
  - k_sep 20.0, personal space 2.0 m      agent.py:149,153
  - formation spacing 2.0 m (V-shape)     agent.py:106-107
  - utility threshold 20.0                agent.py:297
  - utility scale 100.0                   agent.py:347
  - claim hysteresis +5.0                 agent.py:316
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class TelemetryConfig:
    """Static gate for the in-scan flight recorder (r10,
    utils/telemetry.py).

    Frozen + hashable, so it rides inside ``SwarmConfig`` as part of
    the jit-static config: the gate is resolved at TRACE time, which
    is what makes the disabled path compile to the identical HLO the
    telemetry-free tick always had (no masked-out collection ops, no
    dead ``ys`` — the Python ``if`` never emits them).  Enabled, the
    tick computes one fixed-shape :class:`~..utils.telemetry.
    TickTelemetry` of scalar counters/gauges per step, which the
    rollout drivers stack as ``lax.scan`` ys — telemetry stays on
    device for the whole rollout (no host syncs), and the carried
    state computation is untouched, so the trajectory is bitwise
    identical either way (pinned by tests/test_telemetry.py via
    ``utils/replay.fingerprint``).
    """

    enabled: bool = False

    def replace(self, **kw) -> "TelemetryConfig":
        return dataclasses.replace(self, **kw)


TELEMETRY_OFF = TelemetryConfig()
TELEMETRY_ON = TelemetryConfig(enabled=True)


@dataclass(frozen=True)
class SwarmConfig:
    """All swarm tunables.  Frozen → hashable → usable as a jit-static arg.

    Timing is expressed in *ticks*, not wall-clock seconds: the reference's
    event loop runs at 10 Hz wall-clock (agent.py:67-81), so 1 tick = 0.1 s.
    The synchronous TPU model steps ticks as fast as the chip allows; an
    optional realtime mode re-introduces the wall-clock pacing.
    """

    # --- timing -----------------------------------------------------------
    tick_rate_hz: float = 10.0          # reference loop rate (agent.py:68)
    dt: float = 0.1                     # integration step = 1/tick_rate
    heartbeat_period_ticks: int = 10    # 1 Hz heartbeat (agent.py:288)
    election_timeout_ticks: int = 30    # 3.0 s at 10 Hz (agent.py:222)
    election_jitter_ticks: int = 2      # U(0, 0.2) s at 10 Hz (agent.py:229)

    # --- physics / motion (APF) ------------------------------------------
    max_speed: float = 5.0              # velocity clamp (agent.py:49)
    k_att: float = 1.0                  # target attraction gain (agent.py:118)
    arrival_tolerance: float = 0.5      # no attraction inside (agent.py:123)
    k_rep: float = 50.0                 # obstacle repulsion gain (agent.py:128)
    rho0: float = 5.0                   # obstacle influence radius (agent.py:129)
    k_sep: float = 20.0                 # neighbor separation gain (agent.py:149)
    personal_space: float = 2.0         # separation radius (agent.py:153)
    # Velocity-alignment / cohesion field forces (r6, beyond-parity —
    # the reference has neither): when either gain is nonzero the
    # tick adds k_align * (neighborhood mean velocity - vel) and
    # k_coh * (neighborhood centroid - pos) from the COMMENSURATE
    # moments-deposit CIC field (ops/grid_moments.py): the alignment
    # grid is locked to the hashgrid separation geometry (cell_a an
    # even integer multiple of the effective grid_cell, canonically
    # 4x), the deposit is one 16-channel cell reduction instead of
    # four per-agent corner scatters, and the identical portable
    # algebra runs on CPU and TPU.  Requires world_hw > 0 and
    # dim == 2 (the field tiles the torus).  Dead agents neither
    # deposit nor feel the field.
    k_align: float = 0.0                # 0 = alignment force off
    k_coh: float = 0.0                  # 0 = cohesion force off
    align_cell: float = 0.0             # field cell; <= 0 derives the
    #   canonical commensurate cell_a = 4 * cell_sep_eff; explicit
    #   values must resolve to a commensurate grid (even integer
    #   number of sep cells per field cell) or the tick raises.
    dist_eps: float = 1e-3              # distance clamp (agent.py:135,154);
    #   unlike the reference, the clamp is applied to *every* norm, fixing the
    #   ZeroDivisionError for co-located agents (SURVEY.md §5a bug 1).

    # --- formation --------------------------------------------------------
    formation_spacing: float = 2.0      # V spacing (agent.py:106-107)
    formation_shape: str = "vee"        # "vee" (agent.py:105-107) | "line"
    #   (line-formation variant left commented in the reference,
    #   agent.py:101-103) | "none" (no follower retarget — followers keep
    #   their user nav targets; a rank-indexed V spans kilometres at
    #   10^4+ agents, so bounded-arena swarms need the opt-out)
    formation_rank_mode: str = "ordinal"
    #   "ordinal": rank = position among alive non-leader agents (fixes the
    #     gaps-in-the-V quirk, SURVEY.md §5a bug 7).
    #   "id": rank = raw agent id, byte-faithful to agent.py:99.

    # --- task allocation --------------------------------------------------
    utility_threshold: float = 20.0     # claim threshold (agent.py:297)
    utility_scale: float = 100.0        # U = scale/(1+d)·cap (agent.py:347)
    claim_hysteresis: float = 5.0       # challenger margin (agent.py:316)
    allocation_lock_on_award: bool = True
    #   True (reference semantics, agent.py:330-336): the award broadcast
    #   LOCKs the task for everyone, so assignments are final and the
    #   hysteresis only arbitrates same-tick claim races.  False: losers may
    #   keep challenging as the swarm moves, and an incumbent is replaced
    #   only when beaten by claim_hysteresis — live reallocation.
    allocation_mode: str = "greedy"
    #   "greedy": reference semantics — threshold claims + leader argmax
    #     arbitration with hysteresis (agent.py:291-347).
    #   "auction": eps-optimal one-task-per-agent assignment via the
    #     Bertsekas auction (ops/auction.py) — a beyond-parity upgrade;
    #     solves on the auction_every cadence and whenever an awarded
    #     winner dies.
    auction_every: int = 10             # auction re-solve cadence, ticks
    auction_eps: float = 0.25           # bid increment (optimality gap
    #   <= max(N, T) * auction_eps in total utility)

    # --- scale / numerics -------------------------------------------------
    separation_mode: str = "dense"
    #   "dense": exact all-pairs via [N,N,D] broadcast — small swarms.
    #   "pallas": exact all-pairs, tiled Pallas TPU kernel, no O(N²) HBM
    #     intermediates — large swarms on chip (ops/pallas/separation.py).
    #   "grid": spatial-hash approximation (gather-heavy; CPU-oriented).
    #   "window": Morton-sorted sliding window — the TPU-native
    #     approximate mode for very large N (roll-based, no gathers).
    #   "hashgrid": torus-world spatial hash — exact up to the per-cell
    #     cap and STABLE in detection (no window-rank flicker), at
    #     window-like cost: the fused Pallas cell-slot kernel
    #     (ops/pallas/grid_separation.py) on TPU, the portable
    #     torus-mode separation_grid elsewhere.  Requires world_hw > 0
    #     (the world becomes the torus [-world_hw, world_hw)^2; keep
    #     agents inside it) and dim == 2.
    #   "off": no separation force.
    grid_cell: float = 2.0              # cell for "grid"/"window" modes
    grid_max_per_cell: int = 8          # bucket capacity for "grid" mode
    world_hw: float = 0.0               # torus half-width for "hashgrid"
    #   (0 = unset).  Binning clips to the box; displacements use
    #   minimum-image wrapping, so agents far outside [-hw, hw) would
    #   see wrong neighbors — same caller contract as the torus-mode
    #   separation_grid.
    hashgrid_backend: str = "auto"
    #   "auto": fused Pallas kernel on TPU when the geometry qualifies
    #     (2-D f32, >= 16 aligned grid rows, cap a multiple of 8 in
    #     [8, 64]), else portable torus-grid.  "pallas" forces the
    #     kernel (interpret off-TPU — test hook); "portable" forces
    #     separation_grid — also the documented choice for GSPMD
    #     multi-device meshes (the kernel is a single-device program;
    #     a shard_map tick driver is future work).
    hashgrid_overflow_budget: int = 256
    #   Max capped-out agents per tick that still receive exact
    #   (symmetric) separation via the kernel's rescue pass; see
    #   ops/pallas/grid_separation.py.
    hashgrid_skin: float = 0.0
    #   Verlet skin radius (r9, ops/hashgrid_plan.py).  0 = rebuild
    #   the spatial index every tick (the exact r8 behavior).  > 0:
    #   the index is built with cells inflated by `skin` and REUSED
    #   across `lax.scan` rollout ticks until any agent has moved
    #   more than skin/2 from the build snapshot (or the alive set
    #   changes) — a provably exact superset until then, so
    #   detection stays exact while the bin+sort cost is paid per
    #   REBUILD instead of per tick.  Portable rollouts additionally
    #   materialize a per-cell stencil-union candidate table
    #   (hashgrid_neighbor_cap) whose one-row [N, W] sweep replaces
    #   the 9-cell stencil gathers.
    #   Pick skin ~ personal_space/2..personal_space; budget cap
    #   headroom (grid_max_per_cell) for the inflated cells, which
    #   hold (1 + skin/cell)^2 more agents.  Amortization engages in
    #   swarm_rollout / VectorSwarm.step(n>1); single eager ticks
    #   still rebuild per tick (exact either way).
    hashgrid_rebuild_every: int = 0
    #   Hard staleness ceiling for the Verlet plan: > 0 forces a
    #   rebuild whenever the carried plan is this many ticks old,
    #   regardless of measured displacement — an override for drift
    #   the displacement probe cannot see.  0 = displacement/alive
    #   triggers only.
    hashgrid_partial_refresh: bool = False
    #   r22 locality-aware trigger (hashgrid_plan.refresh_plan_
    #   partial): per-agent anchors + per-cell partial repair in
    #   place of the r9 global-max displacement trigger, so a few
    #   fast movers refresh their 3x3 neighborhoods instead of
    #   rebuilding the whole structure (full rebuilds remain for
    #   alive-set changes, the rebuild_every ceiling, and trigger
    #   storms past the caps).  Only engages on amortized portable
    #   rollouts carrying a candidate table (hashgrid_skin > 0,
    #   hashgrid_neighbor_cap > 0) without a riding field binning;
    #   anywhere else it falls back to the global trigger.  Default
    #   off: the r9 trigger stays the bitwise-pinned baseline.
    hashgrid_partial_crosser_cap: int = 512
    #   Fixed per-tick budget of CELL-CROSSING violators the partial
    #   repair can absorb (its merge tables are [cap]-shaped); more
    #   crossers than this in one tick falls back to a full rebuild.
    #   Size to the regime's observed crossings per tick (~200/tick
    #   at 65k agents, max_speed=5 — docs/PERFORMANCE.md r22).
    hashgrid_neighbor_cap: int = 64
    #   Width W of the per-cell stencil-union candidate table
    #   ([g*g, W]: every live agent in a cell's 3x3 neighborhood, in
    #   stencil scan order) — the amortized portable sweep reads one
    #   [N, W] row instead of nine [N, K] stencil windows.  Size to
    #   ~9x the expected cell occupancy; neighborhoods past W
    #   truncate their scan-order tail (counted in
    #   plan.cand_overflow), like grid_max_per_cell overflow.  Only
    #   materialized for amortized portable rollouts
    #   (hashgrid_skin > 0).
    hashgrid_kernel: str = "slots"
    #   Which fused Pallas program the hashgrid kernel path runs
    #   (r23).  "slots": the r5 per-cell slot-plane kernel
    #   (separation_hashgrid_pallas) — re-derives its planes every
    #   tick, cannot ride a skinned plan.  "candidates": the
    #   plan-native candidate sweep (ops/pallas/candidate_sweep.py)
    #   — consumes HashgridPlan.cand/recv directly, gathers CURRENT
    #   positions through the table so a stale (skinned) plan stays
    #   exact, and so runs the amortized Verlet regime on-chip.
    #   With "candidates" the plan always carries the cand+recv
    #   operands (even on the portable fallback) so kernel and
    #   portable backends share identical plans and stay bitwise
    #   equal; gating (VMEM fit, multi-device fallback) follows the
    #   r6/r8 hashgrid_backend discipline via
    #   candidate_backend_choice.
    hashgrid_recv_cap: int = 0
    #   Receiver rows RK of the candidate kernel's per-cell writeback
    #   table (plan.recv [g*g, RK]: each cell's own live occupants).
    #   0 (auto) sizes to 2x grid_max_per_cell rounded up to a
    #   multiple of 8 (the kernel's sublane tile).  Cells holding
    #   more than RK live agents truncate their receiver tail
    #   (counted in plan.recv_overflow) and those agents silently
    #   get zero separation force from the kernel — size RK so the
    #   regime keeps recv_overflow == 0; with RK >= grid_max_per_cell
    #   (enforced) any receiver truncation implies cap_overflow > 0,
    #   so the existing overflow telemetry already flags it.
    spatial_per_tile_rebuild: bool = False
    #   r22 two-level trigger for the spatially-sharded tick
    #   (parallel/spatial.py): each tile's Verlet rebuild predicate
    #   becomes its OWN local+halo staleness OR'd with its two ring
    #   neighbors' band-edge triggers (shipped on the halo payload's
    #   meta row) instead of the r12 mesh-wide OR — a fast mover
    #   rebuilds its own neighborhood while quiet tiles keep their
    #   plans.  Halo membership is re-selected every tick (bitwise-
    #   equal to the carried lists on quiet ticks), which is what
    #   empties the rebuild branch of collectives and makes the
    #   non-uniform predicate deadlock-free.  Default off keeps the
    #   r12 global-OR lockstep baseline the parity tests pin.
    spatial_rehome: bool = False
    #   r22 drifter re-homing: a bounded ring migration at the top of
    #   every sharded tick ships agents whose position left their
    #   home strip to the owning neighbor tile (one ring hop per
    #   tick), draining ``SpatialCarry.escapes`` to zero under
    #   sustained drift.  Arrivals land in dead slots (receiver free
    #   capacity is advertised on the halo meta row one tick ahead),
    #   so kill/revive flows must not rely on vacated corpse slots
    #   persisting under re-homing.  No-op on a 1-tile mesh.
    spatial_migration_cap: int = 64
    #   Per-direction migrant slots per tick (the fixed f32
    #   ``[cap, F]`` ppermute payload of the re-homing pass).
    #   Escapees past the cap — or past the receiver's advertised
    #   free slots — stay put and retry next tick, counted loudly in
    #   ``SpatialCarry.migration_overflow`` (the halo_overflow
    #   discipline: out-of-budget regimes are detected, not silent).
    field_deposit: str = "scatter"
    #   Moments-field deposit backend (r9, promoting r8's
    #   plan_cell_sums).  "scatter": the production .at[key].add cell
    #   reduction.  "sorted": the sorted-segment deposit off the
    #   shared plan's existing cell sort (plan_cell_sums — measured
    #   -24% deposit time on CPU in r8, kept non-default pending the
    #   TPU re-measure this flag exists to run without code changes).
    #   "sorted" requires the shared plan: separation_mode='hashgrid',
    #   commensurate field geometry, hashgrid_skin == 0.
    telemetry: TelemetryConfig = TELEMETRY_OFF
    #   In-scan flight recorder (r10, utils/telemetry.py +
    #   docs/OBSERVABILITY.md).  Static: flipping it retraces; the
    #   disabled trace is the identical telemetry-free HLO.  Enabled,
    #   physics_step/physics_step_plan emit a per-tick TickTelemetry
    #   the rollout drivers stack as scan ys (swarm_rollout(...,
    #   telemetry=True) enables it for one rollout without touching
    #   the config).  Collection is provably non-perturbing: the
    #   telemetry-on trajectory is bitwise-equal to telemetry-off.
    window_size: int = 16               # ± sorted-order span for "window"
    sort_every: int = 1                 # "window" re-sort cadence in ticks.
    #   1 (default): sort+gather+scatter inside the separation pass every
    #     tick; agent array slots are stable.
    #   >1: the WHOLE swarm state is re-ordered by Morton key every
    #     sort_every ticks (state.permute_agents) and the separation pass
    #     runs roll-only with no sort/gather/scatter — 3.7x faster ticks
    #     at 1M agents.  Semantically transparent to the protocol
    #     (identity lives in agent_id; kill/revive match by value), but
    #     ARRAY SLOTS become internal — address agents by id, not index.
    #     KEEP sort_every <= ~personal_space / (2*max_speed*dt) (= 2 at
    #     the defaults; 8 is still fine in practice): an agent crosses a
    #     personal space in personal_space/(max_speed*dt) = 4 ticks, and
    #     the measured force error under converging motion jumps from
    #     ~0.7% at sort_every=8 to ~99% at 25 — the stale ordering
    #     misses exactly the newly colliding (strongest-force) pairs.
    #     See docs/PERFORMANCE.md "Window-separation error".
    dtype: str = "float32"

    def replace(self, **kw) -> "SwarmConfig":
        return dataclasses.replace(self, **kw)

    @property
    def timeout_seconds(self) -> float:
        return self.election_timeout_ticks / self.tick_rate_hz


DEFAULT_CONFIG = SwarmConfig()
