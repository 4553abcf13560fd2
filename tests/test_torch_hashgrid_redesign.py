"""The host side of the redesigned hashgrid kernels (B2 with its rescue, B3)
and of the replayed hashgrid rollouts, on the CPU.

- B2's plain version (``grid_sweep_plain`` with ``_overflow_rescue_local``,
  the whole slots path) against ``separation_hashgrid_pallas(interpret=
  True)`` of the JAX package: agents on the wrap seam at exactly -hw and
  +hw, a crowded state past the rescue budget, no overflow at all, R = 2
  (half cells) and a budget of 0.  Band ``5e-4 * sum|terms| + 1e-6``, the
  slots path's band of ``tests/test_torch_hashgrid.py`` (XLA on the CPU
  approximates the TPU kernel's rsqrt).
- B2's plain version against a loop model of the kernel (one receiver at
  a time, its stencil cells in ascending key order, the in-grid pass and
  then the rescued pass, the sums taken one term after another), bit for
  bit: the plain version repeats the kernel's order, so the card holds
  the kernel to it under ``torch.equal`` where their rsqrt agree.
- B3's tables: every row of ``cand`` and ``recv`` is a valid prefix
  followed by padding, after a build and a chain of partial refreshes (the
  kernel stops at its first padded chunk), and ``cells_per_warp`` keeps a
  warp's staging within the kernel's shared memory.
- The refresh decided on the device (``refresh_plan_on_device``) against
  the host-decided ``refresh_plan_partial`` and ``refresh_plan``: keep,
  partial and full steps give the same plan field for field (keep as the
  partial refresh with no trigger) or raise the full flag.
- The replayed hashgrid rollouts' plumbing (a per-tick plan and a carried
  one, a chunk that needed a full rebuild rerun eagerly, jitter rows, a
  shorter last chunk, launch counts) against the eager rollout bit for
  bit across a kill, with a stand-in for the CUDA graph that runs the
  captured body again at each replay (the card's tests hold the real
  graph).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import hashgrid_plan as jhp
from distributed_swarm_algorithm_tpu.ops.pallas.grid_separation import (
    hashgrid_overflow as j_overflow,
    separation_hashgrid_pallas,
)
from distributed_swarm_algorithm_tpu_torch.models import swarm as tsw
from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as thp
from distributed_swarm_algorithm_tpu_torch.ops._numerics import fma
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    candidate_sweep as tcand,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    grid_separation as tgrid,
)
from distributed_swarm_algorithm_tpu_torch.state import TENSOR_FIELDS

K_SEP, PS, EPS = 20.0, 2.0, 1e-3
HW = 16.0


def t(a):
    return torch.from_numpy(np.array(a))


def dense_abs_sum(pos, alive, hw):
    d = pos[:, None, :].astype(np.float64) - pos[None, :, :]
    d = np.mod(d + hw, 2 * hw) - hw
    r = np.sqrt((d * d).sum(-1))
    near = (r < PS) & alive[:, None] & alive[None, :] & ~np.eye(len(pos),
                                                               dtype=bool)
    mag = K_SEP / np.maximum(r, EPS) ** 3
    return np.where(near[..., None], mag[..., None] * np.abs(d), 0.0).sum(1)


def seam_swarm(n, seed, crowd=0, crowd_at=(-HW, -HW)):
    """Uniform agents on the torus, a few exactly on the seam (x or y at
    -hw or +hw, partners just across it), and an optional crowd of
    ``crowd`` agents around ``crowd_at`` wrapped onto the torus."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-HW, HW, (n, 2)).astype(np.float32)
    pos[:8] = [[-HW, 3.0], [HW - 0.5, 3.0], [HW, -5.0], [-HW + 0.7, -5.2],
               [2.0, -HW], [2.3, HW - 0.4], [-HW, -HW], [HW - 0.3, HW - 0.6]]
    if crowd:
        c = np.float32(crowd_at) + 0.6 * rng.normal(size=(crowd, 2))
        pos[8:8 + crowd] = (np.mod(c + HW, 2 * HW) - HW).astype(np.float32)
    alive = rng.random(n) >= 0.1
    alive[:8 + crowd] = True
    return pos, alive


# --- B2's plain version, against JAX ----------------------------------------

@pytest.mark.parametrize(
    "cell,cap,budget,crowd,over",
    [(2.0, 16, 64, 0, "none"), (2.0, 8, 16, 60, "past"),
     (2.0, 8, 512, 40, "within"), (1.0, 8, 24, 120, "past"),
     (2.0, 8, 0, 40, "past")],
    ids=["seam-no-overflow", "seam-crowd-past-budget", "crowd-within-budget",
         "R2-half-cells-past-budget", "budget-0"],
)
def test_slots_plain_matches_jax_on_the_seam_and_past_the_budget(
        cell, cap, budget, crowd, over):
    pos, alive = seam_swarm(360, 5, crowd)
    kw = dict(cell=cell, max_per_cell=cap, torus_hw=HW,
              overflow_budget=budget)
    want = separation_hashgrid_pallas(jnp.asarray(pos), jnp.asarray(alive),
                                      K_SEP, PS, EPS, interpret=True, **kw)
    got = tgrid.separation_hashgrid(t(pos), t(alive), K_SEP, PS, EPS, **kw)
    scale = dense_abs_sum(pos, alive, HW)
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert (err <= 5e-4 * scale + 1e-6).all(), err.max()
    n_over = int(j_overflow(jnp.asarray(pos), cell, cap, HW,
                            jnp.asarray(alive)))
    assert {"none": n_over == 0, "within": 0 < n_over <= budget,
            "past": n_over > budget}[over]
    assert (got.numpy()[~alive] == 0).all()
    # The seam's pairs feel each other across it.
    assert (got.numpy()[:8] != 0).any(1).all()


@pytest.mark.parametrize("hw,cell,cap,budget", [
    (24.0, 2.0, 8, 30), (24.0, 2.0, 8, 400), (16.0, 1.5, 8, 40)],
    ids=["R1-past-budget", "R1-within-budget", "R2-past-budget"])
def test_slots_plain_matches_jax_on_a_stale_skinned_plan_past_the_cap(
        hw, cell, cap, budget):
    # The port pairs rescued agents over the stencil, JAX over all rescued
    # pairs: the same pairs while the stencil covers personal_space plus
    # the skin.  A crowd spread over several cells past the cap, the plan
    # built at a snapshot, then every agent moved by under skin / 2 (the
    # plan's contract), so cells are stale and rescued agents of different
    # cells are near each other.
    skin = 0.5
    rng = np.random.default_rng(13)
    n, crowd = 420, 160
    pos = rng.uniform(-hw, hw, (n, 2)).astype(np.float32)
    c = np.float32([hw - 1.0, 2.0]) + 1.6 * rng.normal(size=(crowd, 2))
    pos[:crowd] = np.mod(c + hw, 2 * hw) - hw
    alive = rng.random(n) >= 0.08
    alive[:crowd] = True
    g = (int(2 * hw / (cell + skin)) // 16) * 16
    jplan = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive), hw,
                                    cell, cap, g=g, skin=skin)
    tplan = thp.build_hashgrid_plan(t(pos), t(alive), hw, cell, cap, g=g,
                                    skin=skin)
    drift = rng.uniform(-0.35 * skin, 0.35 * skin, pos.shape)
    cur = (np.mod(pos + drift + hw, 2 * hw) - hw).astype(np.float32)
    kw = dict(cell=cell + skin, max_per_cell=cap, torus_hw=hw,
              overflow_budget=budget)
    want = separation_hashgrid_pallas(
        jnp.asarray(cur), jnp.asarray(alive), K_SEP, PS, EPS,
        interpret=True, plan=jplan, **kw)
    got = tgrid.separation_hashgrid(t(cur), t(alive), K_SEP, PS, EPS,
                                    plan=tplan, **kw)
    scale = dense_abs_sum(cur, alive, hw)
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert (err <= 5e-4 * scale + 1e-6).all(), err.max()
    assert (got.numpy()[~alive] == 0).all()
    # The case is the one the stencil argument must carry: the rescue is
    # engaged (past the budget where asked), some agents left their
    # snapshot cell, and rescued agents of different cells are near.
    over = int(tplan.cap_overflow)
    assert over > 0 and (over > budget) == (budget < 400)
    ops = tgrid.sweep_operands(t(cur), tplan)
    _, rescued = tgrid._receivers(ops, g, cap, budget)
    v = torch.nonzero(rescued).flatten()
    d = ops.spos[v][:, None] - ops.spos[v][None]
    d = torch.remainder(d + hw, 2 * hw) - hw
    near = (d.norm(dim=-1) < PS) & (ops.skey[v][:, None]
                                    != ops.skey[v][None])
    assert bool(near.any())
    now = thp.build_hashgrid_plan(t(cur), t(alive), hw, cell, cap, g=g,
                                  skin=skin)
    moved = torch.ones(n, dtype=torch.long)
    moved[tplan.order.long()] = tplan.skey.long()
    still = torch.ones(n, dtype=torch.long)
    still[now.order.long()] = now.skey.long()
    assert bool((moved != still).any())


# --- B2's plain version, against a loop model of the kernel -----------------

def kernel_model(ops, g, k, r, budget):
    """The kernel's control flow, one receiver at a time, in the plain
    version's primitive operations (torch scalars on the CPU)."""
    n = ops.spos.shape[0]
    spos, skey, rank = ops.spos, ops.skey.tolist(), ops.rank.tolist()
    bounds, ovf = ops.bounds.tolist(), ops.ovf_before.tolist()
    order = ops.order.tolist()
    two = torch.tensor(2.0 * HW)
    out = torch.zeros(n, 2)

    def wrap(v):
        return v - two if v >= HW else (v + two if v < -HW else v)

    def term(d):
        d2 = fma(d[0:1], d[0:1], d[1:2] * d[1:2])
        if not bool(d2 < PS * PS):
            return None
        inv = torch.rsqrt(d2.clamp(min=EPS * EPS))
        s = K_SEP * inv * inv * inv
        return s * d[0:1], s * d[1:2]

    for p in range(n):
        c = skey[p]
        if c >= g * g:
            continue
        in_grid = rank[p] < k
        if not in_grid and ovf[c] + rank[p] - k >= budget:
            continue
        cx, cy = divmod(c, g)
        rows = sorted((cx + d) % g for d in range(-r, r + 1))
        cols = sorted((cy + d) % g for d in range(-r, r + 1))
        cells = [a * g + b for a in rows for b in cols]
        acc = [torch.zeros(1), torch.zeros(1)]
        me = spos[p]
        for cc in cells:                       # pass 1: the in-grid agents
            lo, hi = bounds[cc], bounds[cc + 1]
            for q in range(lo, lo + min(hi - lo, k)):
                if q == p:
                    continue
                tr = term(torch.stack([wrap(me[0] - spos[q, 0]),
                                       wrap(me[1] - spos[q, 1])]))
                if tr is not None:
                    acc = [acc[0] + tr[0], acc[1] + tr[1]]
        for cc in cells:                       # pass 2: the rescued agents
            lo, hi = bounds[cc] + k, bounds[cc + 1]
            for q in range(lo, lo + max(0, min(hi - lo, budget - ovf[cc]))):
                if q == p:
                    continue
                d = spos[q] - me if in_grid else me - spos[q]
                tr = term(torch.stack([wrap(d[0]), wrap(d[1])]))
                if tr is not None:
                    if in_grid:
                        acc = [acc[0] - tr[0], acc[1] - tr[1]]
                    else:
                        acc = [acc[0] + tr[0], acc[1] + tr[1]]
        out[order[p]] = torch.cat(acc)
    return out


@pytest.mark.parametrize("cell,cap,budget,crowd", [
    (2.0, 8, 20, 45), (1.0, 6, 4, 30), (2.0, 16, 64, 0)],
    ids=["R1-past-budget", "R2-past-budget", "no-overflow"])
def test_slots_plain_sums_in_the_kernel_order(cell, cap, budget, crowd):
    pos, alive = seam_swarm(220, 7, crowd, crowd_at=(HW - 0.2, 0.0))
    g, cell_eff = tgrid._geometry(HW, cell)
    r = tgrid._stencil_radius(cell_eff, PS)
    plan = thp.build_hashgrid_plan(t(pos), t(alive), HW, cell_eff, cap, g=g)
    ops = tgrid.sweep_operands(t(pos), plan)
    got = tgrid.grid_sweep_plain(ops, g, cap, r, budget, K_SEP, PS, EPS, HW)
    assert torch.equal(got, kernel_model(ops, g, cap, r, budget))
    if crowd:
        assert int(plan.cap_overflow) > budget


# --- B3's tables ------------------------------------------------------------

def assert_prefix_rows(table, n):
    valid = table < n
    length = valid.sum(1, keepdim=True)
    cols = torch.arange(table.shape[1])[None]
    assert torch.equal(valid, cols < length)


def test_candidate_rows_are_valid_prefixes_through_partial_refreshes():
    rng = np.random.default_rng(3)
    n, hw = 700, 24.0
    pos = rng.uniform(-hw, hw, (n, 2)).astype(np.float32)
    pos[:80] = (0.4 * rng.normal(size=(80, 2))).astype(np.float32)
    alive = rng.random(n) >= 0.1
    g = int(2 * hw / 2.5)
    plan = thp.build_hashgrid_plan(t(pos), t(alive), hw, 2.0, 16, g=g,
                                   skin=0.5, need_csr=True, neighbor_cap=32,
                                   recv_cap=24)
    assert int(plan.cand_overflow) > 0 and int(plan.recv_overflow) > 0
    cur = t(pos)
    for step in range(4):
        for table in (plan.cand, plan.recv):
            assert_prefix_rows(table, n)
        cur = cur + 0.35 * torch.from_numpy(
            rng.normal(size=(n, 2)).astype(np.float32))
        plan = thp.refresh_plan_partial(cur, t(alive), plan)
    assert int(plan.cells_rebuilt) > 0
    for w in (32, 128, 129, 256, 1024):
        gw = tcand.cells_per_warp(w)
        assert 1 <= gw <= 6 and gw * w <= 1024
    assert tcand.cells_per_warp(128) == 6


# --- the refresh decided on the device --------------------------------------

P_HW, P_CELL, P_SKIN, P_CAP, P_NCAP = 32.0, 2.0, 1.0, 8, 40
P_G = int(2 * P_HW / (P_CELL + P_SKIN))


def assert_same_plan(a, b, where=""):
    for f in thp.HashgridPlan.ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (where, f)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), (where, f)


def test_device_refresh_decision_matches_the_host_one():
    rng = np.random.default_rng(11)
    pos = rng.uniform(-P_HW, P_HW, (512, 2)).astype(np.float32)
    pos[:12] = (1.0 + 0.3 * rng.normal(size=(12, 2))).astype(np.float32)
    alive = rng.random(512) >= 0.08
    alive[:12] = True
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP,
                                 g=P_G, skin=P_SKIN, need_csr=True,
                                 neighbor_cap=P_NCAP, recv_cap=16)
    cur, tiers = pos, []
    for k, amp, flip, ccap in ((0, 0, 0, 512), (6, 2.0, 0, 512),
                               (4, 2.0, 0, 512), (300, 2.0, 0, 512),
                               (3, 2.0, 3, 512), (8, 2.0, 0, 1)):
        cur = cur.copy()
        if k:
            mv = rng.choice(np.where(alive)[0], k, replace=False)
            cur[mv] += rng.uniform(-amp, amp, (k, 2)).astype(np.float32)
            cur = (((cur + P_HW) % (2 * P_HW)) - P_HW).astype(np.float32)
        if flip:
            alive = alive.copy()
            alive[np.where(alive)[0][:flip]] = False
        host = thp.refresh_plan_partial(t(cur), t(alive), tp,
                                        crosser_cap=ccap)
        dev, full = thp.refresh_plan_on_device(t(cur), t(alive), tp,
                                               crosser_cap=ccap)
        assert full.dtype == torch.bool and full.shape == ()
        if int(host.rebuilds) > int(tp.rebuilds):
            tiers.append("full")
            assert bool(full)
        else:
            tiers.append("partial" if int(host.cells_rebuilt)
                         > int(tp.cells_rebuilt) else "keep")
            assert not bool(full)
            assert_same_plan(dev, host, f"step {len(tiers)}")
        tp = host
    assert tiers == ["keep", "partial", "partial", "full", "full", "full"]


def test_keep_equals_the_partial_refresh_with_no_trigger():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-P_HW, P_HW, (400, 2)).astype(np.float32)
    alive = rng.random(400) >= 0.1
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP,
                                 g=P_G, skin=P_SKIN, need_csr=True,
                                 neighbor_cap=P_NCAP, recv_cap=16)
    # Moved, but under skin/2: no trigger.
    cur = t(pos + rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32))
    tiers = thp._partial_tiers(cur, t(alive), tp, 0, 512)
    assert not bool(tiers.trigger) and not bool(tiers.full_needed)
    assert_same_plan(thp._partial_plan(cur, tp, tiers),
                     tp.replace(age=tp.age + 1))
    # The global trigger's keep and rebuild, decided on the device.
    kept, stale = thp.refresh_plan_on_device(cur, t(alive), tp,
                                             partial=False)
    assert not bool(stale)
    assert_same_plan(kept, thp.refresh_plan(cur, t(alive), tp))
    _, stale = thp.refresh_plan_on_device(cur + 3.0, t(alive), tp,
                                          partial=False)
    assert bool(stale)


# --- the replayed hashgrid rollouts, with a stand-in graph ------------------

class StandInGraph:
    """A CUDA graph stand-in: capturing runs the body once as the stream
    would record it (the kernels' wrappers count into their capture
    tallies, the generator's state is put back), and each replay runs it
    again."""

    capturing = False

    def __init__(self, body):
        self.body = body

    def replay(self):
        StandInGraph.capturing = True
        try:
            self.body()
        finally:
            StandInGraph.capturing = False

    @classmethod
    def capture(cls, body, gen, device):
        state = gen.get_state()
        graph = cls(body)
        graph.replay()
        gen.set_state(state)
        return graph


def counted(mod, fn):
    def kernel(*a, **kw):
        out = fn(*a, **kw)
        if StandInGraph.capturing:
            mod._captured += 1
        else:
            mod.LAUNCHES += 1
        return out
    return kernel


@pytest.fixture
def stand_in(monkeypatch):
    """Both kernels' entries counted as their wrappers count (the plain
    versions run), and the graph replaced by ``StandInGraph``."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: StandInGraph.capturing)
    monkeypatch.setattr(tsw, "capture_graph", StandInGraph.capture)
    monkeypatch.setattr(tsw, "_chunk", None)
    monkeypatch.setattr(tgrid, "grid_sweep",
                        counted(tgrid, tgrid.grid_sweep))
    monkeypatch.setattr(tcand, "candidate_sweep",
                        counted(tcand, tcand.candidate_sweep))
    return monkeypatch


CFGS = {
    "station": dict(grid_max_per_cell=8, hashgrid_overflow_budget=16),
    "converge": dict(grid_max_per_cell=4, hashgrid_overflow_budget=16),
    # A crosser cap of 2 forces full rebuilds inside replayed chunks.
    "fast movers": dict(max_speed=5.0, hashgrid_kernel="candidates",
                        grid_max_per_cell=24, hashgrid_skin=1.5,
                        hashgrid_neighbor_cap=48,
                        hashgrid_partial_refresh=True,
                        hashgrid_partial_crosser_cap=2),
}


def scenario(name, n=256):
    st = tdsa.make_swarm(n, spread=18.0, seed=4, device="cpu")
    st = tdsa.with_tasks(st, [[1.0, 1.0], [-2.0, 3.0]])
    target = st.pos.clone() if name == "station" else torch.zeros_like(
        st.pos)
    return st.replace(target=target,
                      has_target=torch.ones_like(st.has_target))


@pytest.mark.parametrize("name,spans,with_jitter", [
    ("station", (20, 13), False), ("converge", (20, 20), True),
    ("fast movers", (30, 21), True)])
def test_replayed_hashgrid_rollout_equals_the_eager_one(
        stand_in, name, spans, with_jitter):
    cfg = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", world_hw=24.0, formation_shape="none",
        hashgrid_backend="pallas", **CFGS[name])
    mod = tcand if name == "fast movers" else tgrid
    n = 256
    jitter = None
    if with_jitter:
        jitter = torch.from_numpy(np.random.default_rng(0).integers(
            0, 3, (sum(spans), n)).astype(np.int32))
    runs = {}
    stand_in.setattr(tsw, "CHUNKS_RERUN", 0)
    for replayed in (False, True):
        stand_in.setattr(tsw, "replays_graphs", lambda dev: replayed)
        st, at, before, plans = scenario(name, n), 0, mod.LAUNCHES, []
        for k, ticks in enumerate(spans):
            if k:
                st = tdsa.kill(st, [n - 1])
            st, plan = tsw.swarm_rollout(
                st, None, cfg, ticks, return_plan=True,
                jitter=None if jitter is None else jitter[at:at + ticks])
            at += ticks
            plans.append(plan)
        runs[replayed] = (st, plans, mod.LAUNCHES - before)
    (eager, pe, le), (graph, pg, lg) = runs[False], runs[True]
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(eager, f), getattr(graph, f)), f
    assert torch.equal(eager.gen.get_state(), graph.gen.get_state())
    # Launches whose results the rollout keeps: once a tick.
    assert le == lg == sum(spans)
    if name == "fast movers":
        for a, b in zip(pe, pg):
            assert_same_plan(a, b)
        assert int(pe[0].rebuilds) > 0          # full rebuilds happened
        assert tsw._chunk.flag is not None
        assert tsw.CHUNKS_RERUN > 0             # and their chunks reran
    else:
        assert pe == pg == [None, None] and tsw.CHUNKS_RERUN == 0
    if name == "converge":
        assert int(tdsa.build_tick_plan(eager, cfg).cap_overflow) > 16
    assert [int(v) for v in tdsa.current_leader(graph)] == [n - 2, 1]


def test_replayed_hashgrid_rollout_keeps_to_its_regime(stand_in):
    stand_in.setattr(tsw, "replays_graphs", lambda dev: True)
    cfg = tdsa.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", world_hw=24.0, formation_shape="none",
        hashgrid_backend="pallas", **CFGS["station"])
    st = scenario("station")
    # Fewer ticks than a chunk, record=True and the portable sweep stay
    # eager.
    tsw.swarm_rollout(st, None, cfg, tsw.HASHGRID_CHUNK - 1)
    tsw.swarm_rollout(st, None, cfg, 12, record=True)
    tsw.swarm_rollout(st, None, cfg.replace(hashgrid_backend="portable"), 12)
    assert tsw._chunk is None
    tsw.swarm_rollout(st, None, cfg, 12)
    first = tsw._chunk
    assert first is not None and first.kernel is tgrid
    assert first.plan is None and first.flag is None
    # A capture that does not launch the kernel once a tick raises.
    stand_in.setattr(tsw, "_chunk", None)
    stand_in.setattr(tgrid, "grid_sweep",
                     lambda ops, *a: torch.zeros_like(ops.spos))
    with pytest.raises(RuntimeError, match="once a tick"):
        tsw.swarm_rollout(st, None, cfg, 12)
    assert tsw._chunk is None
