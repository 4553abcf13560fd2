"""The port's auction (``ops/auction.py``, N2's plain version in
``ops/cuda/auction.py``) and ``allocation_mode="auction"`` against the JAX
package and its NumPy oracle ``auction_assign_np``.

Mirrors ``tests/test_auction.py`` (its two ``cpu_swarm`` cases wait for
the port of ``models/cpu_swarm.py``) and adds the cross-package
comparisons.  Every comparison is exact, prices included: a round has only
additions, subtractions and maxima, in f32 in both packages, and ties go
to the lowest index in both.  ``task_util`` after a tick is one division
of the same f32 inputs (1e-6, as ``tests/test_torch_coord_alloc.py``).

On the CPU the auction is the plain loop (the JAX loop in PyTorch, its
flag read on the host); the kernel that runs it on the card is held to
that loop by ``tests/test_torch_cuda.py``.  The replayed rollout in
auction mode runs here with a stand-in graph (the capture and replay
plumbing, the launch counts) against the eager rollout.
"""

import dataclasses
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import allocation as jalloc
from distributed_swarm_algorithm_tpu.ops import auction as jauc
from distributed_swarm_algorithm_tpu_torch.models import swarm as tsw
from distributed_swarm_algorithm_tpu_torch.ops import allocation as talloc
from distributed_swarm_algorithm_tpu_torch.ops import auction as tauc
from distributed_swarm_algorithm_tpu_torch.ops.cuda import auction as tn2
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    grid_separation as tgrid,
)
from distributed_swarm_algorithm_tpu_torch.state import TENSOR_FIELDS


def t(a):
    return torch.from_numpy(np.array(a))


def brute_force_best(util, feasible):
    """Max total utility over all one-to-one partial assignments."""
    n, tt = len(util), len(util[0])
    best = 0.0
    for r in range(0, min(n, tt) + 1):
        for rows in itertools.combinations(range(n), r):
            for cols in itertools.permutations(range(tt), r):
                if all(feasible[i][j] for i, j in zip(rows, cols)):
                    best = max(best, sum(util[i][j]
                                         for i, j in zip(rows, cols)))
    return best


def check_valid(util, feasible, res):
    """One-to-one, feasible, and the two views agree."""
    n, tt = util.shape
    at, ta = res.agent_task.numpy(), res.task_agent.numpy()
    for i in range(n):
        if at[i] >= 0:
            assert feasible[i][at[i]] and ta[at[i]] == i
    for j in range(tt):
        if ta[j] >= 0:
            assert at[ta[j]] == j
    seated = [j for j in at if j >= 0]
    assert len(seated) == len(set(seated))


def assert_same(port, want):
    """Every field of an AuctionResult equal to JAX's (or numpy's)."""
    for name, a, b in zip(port._fields, port, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype or name == "rounds", name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def both(util, feasible=None, **kw):
    """(port, JAX) auction_assign on the same numpy inputs."""
    port = tauc.auction_assign(t(util), None if feasible is None
                               else t(feasible), **kw)
    ref = jauc.auction_assign(jnp.asarray(util), None if feasible is None
                              else jnp.asarray(feasible), **kw)
    assert_same(port, ref)
    return port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(5, 5), (6, 3), (3, 6)])
def test_auction_matches_brute_force(seed, shape):
    rng = np.random.default_rng(seed)
    n, tt = shape
    util = rng.integers(1, 100, size=(n, tt)).astype(np.float32)
    feasible = rng.random((n, tt)) < 0.7
    util = np.where(feasible, util, 0.0).astype(np.float32)
    res = both(util, feasible, eps=0.1)
    check_valid(util, feasible, res)
    got = float(tauc.assignment_utility(t(util), res))
    assert got == pytest.approx(brute_force_best(util.tolist(),
                                                 feasible.tolist()),
                                abs=1e-3)


def test_auction_specialist_beats_greedy():
    util = np.float32([[10.0, 9.0], [8.0, 0.0]])
    res = both(util, eps=0.05)
    assert res.agent_task.tolist() == [1, 0]
    assert float(tauc.assignment_utility(t(util), res)) == \
        pytest.approx(17.0)


def test_auction_infeasible_agent_stays_unassigned():
    res = both(np.float32([[50.0, 40.0], [0.0, 0.0], [30.0, 60.0]]),
               eps=0.1)
    assert int(res.agent_task[1]) == -1
    assert sorted(res.task_agent.tolist()) == [0, 2]


def test_auction_surplus_agents_drop_out():
    res = both(np.float32([[10.0], [30.0], [20.0], [25.0]]), eps=0.5)
    assert int(res.task_agent[0]) == 1
    assert res.agent_task.tolist() == [-1, 0, -1, -1]


def test_auction_ties_are_deterministic():
    util = np.full((3, 2), 10.0, np.float32)
    r1, r2 = both(util, eps=0.5), both(util, eps=0.5)
    assert torch.equal(r1.task_agent, r2.task_agent)
    seated = r1.task_agent.tolist()
    assert len(set(seated)) == 2 and all(a in (0, 1, 2) for a in seated)


def test_scaled_auction_same_quality_as_flat():
    rng = np.random.default_rng(7)
    util = rng.uniform(1.0, 100.0, size=(24, 24)).astype(np.float32)
    flat = both(util, eps=0.05)
    scaled = tauc.auction_assign_scaled(t(util), eps=0.05, phases=4,
                                        theta=5.0)
    assert_same(scaled, jauc.auction_assign_scaled(jnp.asarray(util),
                                                   eps=0.05, phases=4,
                                                   theta=5.0))
    check_valid(util, util > 0, scaled)
    a = float(tauc.assignment_utility(t(util), flat))
    b = float(tauc.assignment_utility(t(util), scaled))
    assert abs(a - b) <= 2 * 24 * 0.05 + 1e-3


@pytest.mark.parametrize("shape", [(8, 5), (16, 16), (5, 9), (64, 40)])
@pytest.mark.parametrize("seed", [0, 3])
def test_numpy_oracle_matches_jax_auction_exactly(shape, seed):
    """The port, JAX and the NumPy oracle: the same outcomes, prices and
    rounds, scaled and flat."""
    rng = np.random.default_rng(seed)
    n, tt = shape
    util = rng.uniform(0.0, 100.0, size=(n, tt)).astype(np.float32)
    feasible = rng.random((n, tt)) < 0.8
    port = tauc.auction_assign_scaled(t(util), t(feasible))
    npy = jauc.auction_assign_np(util, feasible)
    assert_same(port, jauc.auction_assign_scaled(jnp.asarray(util),
                                                 jnp.asarray(feasible)))
    assert_same(port, npy)
    both(util, feasible)


@pytest.mark.parametrize("seed", [0, 1])
def test_sentinel_robust_at_large_magnitudes(seed):
    rng = np.random.default_rng(seed)
    scale = 1.0e5
    util = (rng.integers(1, 40, size=(5, 5)) * scale).astype(np.float32)
    feasible = np.ones((5, 5), bool)
    res = both(util, feasible, eps=0.1 * scale)
    check_valid(util, feasible, res)
    got = float(tauc.assignment_utility(t(util), res))
    assert got == pytest.approx(brute_force_best(util.tolist(),
                                                 feasible.tolist()),
                                rel=1e-6)
    npy = jauc.auction_assign_np(util, feasible, eps=0.1 * scale)
    np.testing.assert_array_equal(res.agent_task.numpy(), npy.agent_task)


def test_single_pair_instance():
    """S == 1: the masked second best is -inf and maps to a zero
    margin."""
    res = both(np.float32([[7.0]]), eps=0.25)
    assert res.agent_task.tolist() == [0] and res.task_agent.tolist() == [0]
    assert np.isfinite(float(res.prices[0]))
    scaled = tauc.auction_assign_scaled(t(np.float32([[7.0]])), eps=0.25)
    assert int(scaled.agent_task[0]) == 0
    assert np.isfinite(float(scaled.prices[0]))


def test_greedy_one_to_one_baseline_sane():
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks"))
    from bench_auction import greedy_one_to_one

    util = np.float32([[90.0, 80.0], [89.0, 0.0]])
    assert greedy_one_to_one(util) == 90.0
    res = both(util, eps=0.05)
    assert float(tauc.assignment_utility(t(util), res)) >= 169.0 - 1e-3
    rng = np.random.default_rng(3)
    for _ in range(3):
        u = rng.uniform(1.0, 100.0, size=(24, 24)).astype(np.float32)
        r = both(u, eps=0.1)
        assert float(tauc.assignment_utility(t(u), r)) >= \
            greedy_one_to_one(u) - 1e-3


def test_auction_round_and_the_plain_loop_match_jax():
    """One round from a mid-auction state, the whole loop with a round
    cap and from warm prices, and ``run`` false (zero rounds, nothing
    seated, the prices as given)."""
    rng = np.random.default_rng(11)
    s = 48
    values = np.where(rng.random((s, s)) < 0.6,
                      rng.uniform(1.0, 100.0, (s, s)), 0.0).astype(np.float32)
    values[:, :3] = 50.0                       # ties on three columns
    eps = np.float32(0.25)
    carry = jauc._auction_square(jnp.asarray(values), jnp.zeros(s), eps, 7)
    got = tauc._auction_round(t(values), t(eps), *map(t, carry[:3]))
    want = jauc._auction_round(jnp.asarray(values), eps, carry)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    prices = rng.uniform(0.0, 5.0, s).astype(np.float32)
    for cap in (7, 100_000):
        got = tn2.auction_square_plain(t(values), t(prices), t(eps), cap)
        want = jauc._auction_square(jnp.asarray(values), jnp.asarray(prices),
                                    eps, cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    off = tn2.auction_square_plain(t(values), t(prices), t(eps), 100,
                                   run=torch.tensor(False))
    assert (off[0] == -1).all() and (off[1] == -1).all()
    assert torch.equal(off[2], t(prices)) and int(off[3]) == 0
    res = tauc.auction_assign(t(values), eps=0.25, run=torch.tensor(False))
    assert (res.agent_task == -1).all() and int(res.rounds) == 0


# --- the swarm ---------------------------------------------------------------


def jax_to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s) if f.name != "key"}


def jax_jitter(js, cfg):
    _, sub = jax.random.split(js.key)
    return t(jax.random.randint(sub, (js.n_agents,), 0,
                                cfg.election_jitter_ticks + 1))


AUCTION = dict(allocation_mode="auction", auction_every=4,
               separation_mode="dense", utility_threshold=5.0)


def test_auction_tick_matches_jax_from_its_state():
    """60 ticks from JAX's state each, an awarded winner killed at tick
    45: task_winner, task_claimed, the FSM exact; task_util within
    1e-6."""
    jcfg = jdsa.SwarmConfig().replace(**AUCTION)
    tcfg = tdsa.DEFAULT_CONFIG.replace(**AUCTION)
    js = jdsa.make_swarm(10, seed=0, spread=3.0)
    js = jdsa.with_tasks(js, jnp.asarray([[1.0, 1.0], [-1.0, 2.0],
                                          [2.0, -1.0], [0.0, -2.0]]))
    step = jax.jit(lambda s: jdsa.swarm_tick(s, None, jcfg))
    awarded = set()
    for tick in range(60):
        if tick == 45:
            js = jdsa.kill(js, [int(np.asarray(js.task_winner)[0])])
        ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
        jitter = jax_jitter(js, jcfg)
        js = step(js)
        ts = tdsa.swarm_tick(ts, None, tcfg, jitter)
        want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
        for f in ("task_winner", "task_claimed", "fsm", "leader_id",
                  "alive"):
            np.testing.assert_array_equal(got[f], want[f], f"{tick} {f}")
        np.testing.assert_allclose(got["task_util"], want["task_util"],
                                   atol=1e-6)
        awarded.add(tuple(want["task_winner"].tolist()))
    assert len(awarded) > 2        # awards made, then redone after the kill


def gate_state(n=12, leader=True, tick=3, dead_winner=False):
    """A JAX state with awards for the gate tests: a leader (or none), a
    tick off the cadence of 4, optionally a dead winner."""
    js = jdsa.make_swarm(n, seed=2, spread=4.0)
    js = jdsa.with_tasks(js, jnp.asarray([[1.0, 0.0], [-1.0, 1.0],
                                          [0.5, -2.0]]))
    fsm = np.full(n, jdsa.FOLLOWER, np.int32)
    if leader:
        fsm[n - 1] = jdsa.LEADER
    js = js.replace(fsm=jnp.asarray(fsm), tick=jnp.asarray(tick, jnp.int32),
                    task_winner=jnp.asarray([0, 1, -1], jnp.int32),
                    task_util=jnp.asarray([9.0, 8.0, 0.0], jnp.float32),
                    task_claimed=jnp.zeros((n, 3), bool).at[:, :2].set(True))
    if dead_winner:
        js = jdsa.kill(js, [1])
    return js


@pytest.mark.parametrize("case", ["cadence", "eviction", "leader-emerged",
                                  "no-trigger", "leaderless"])
def test_resolve_gate_matches_jax(case):
    """The re-solve fires on the cadence, an eviction or a leader's
    emergence, only with a leader; otherwise the awards stand (only the
    eviction's changes)."""
    kw = dict(tick=4 if case == "cadence" else 3,
              dead_winner=case in ("eviction", "leaderless"),
              leader=case != "leaderless")
    js = gate_state(**kw)
    emerged = case == "leader-emerged"
    cfg = jdsa.SwarmConfig().replace(**AUCTION)
    want = jalloc.auction_allocation_step(js, cfg,
                                          leader_emerged=jnp.asarray(emerged))
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    tcfg = tdsa.DEFAULT_CONFIG.replace(**AUCTION)
    for flag in (emerged, torch.tensor(emerged)):
        got = talloc.auction_allocation_step(ts, tcfg, leader_emerged=flag)
        g, w = tdsa.state_to_numpy(got), jax_to_numpy(want)
        for f in ("task_winner", "task_claimed"):
            np.testing.assert_array_equal(g[f], w[f], f)
        np.testing.assert_allclose(g["task_util"], w["task_util"],
                                   atol=1e-6)
    resolved = not np.array_equal(g["task_winner"], [0, -1 if kw[
        "dead_winner"] else 1, -1])
    assert resolved == (case in ("cadence", "eviction", "leader-emerged"))
    if case == "no-trigger":
        for f in TENSOR_FIELDS:
            assert torch.equal(getattr(got, f), getattr(ts, f)), f
    if case == "leaderless":     # evicted, not re-solved
        assert g["task_winner"].tolist() == [0, -1, -1]


def test_swarm_auction_mode_assigns_and_recovers():
    cfg = tdsa.DEFAULT_CONFIG.replace(allocation_mode="auction",
                                      auction_every=1,
                                      separation_mode="dense",
                                      utility_threshold=5.0)
    s = tdsa.make_swarm(8, seed=0, spread=3.0, device="cpu")
    s = tdsa.with_tasks(s, [[1.0, 1.0], [-1.0, 2.0], [2.0, -1.0]])
    for _ in range(40):
        s = tdsa.swarm_tick(s, None, cfg)
    winners = s.task_winner.tolist()
    assert all(w != tdsa.NO_WINNER for w in winners)
    assert len(set(winners)) == len(winners)
    victim = winners[0]
    s = tdsa.kill(s, [victim])
    for _ in range(3):
        s = tdsa.swarm_tick(s, None, cfg)
    assert victim not in s.task_winner.tolist()
    for _ in range(40):
        s = tdsa.swarm_tick(s, None, cfg)
    winners2 = s.task_winner.tolist()
    assert victim not in winners2 and tdsa.NO_WINNER not in winners2


# --- the replayed rollout, with a stand-in graph -----------------------------


class StandInGraph:
    """A CUDA graph stand-in: capturing runs the body once as the stream
    would record it (the wrappers count into their capture tallies, the
    generator's state is put back); each replay runs it again."""

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


@pytest.mark.parametrize("case", ["auction", "auction-field",
                                  "window-auction-field"])
def test_replayed_rollout_in_auction_mode_equals_the_eager_one(
        monkeypatch, case):
    """A hashgrid rollout on the slots kernel (its plain version), or a
    window rollout with its re-sort, in auction mode, with and without the
    moments field: the replayed chunks equal the eager ticks, a kill
    included, and both kernels count one launch a tick."""
    from distributed_swarm_algorithm_tpu_torch.ops import neighbors as tnb
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
        window_separation as twin,
    )

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: StandInGraph.capturing)
    monkeypatch.setattr(tsw, "capture_graph", StandInGraph.capture)
    monkeypatch.setattr(tsw, "_chunk", None)
    monkeypatch.setattr(tgrid, "grid_sweep",
                        counted(tgrid, tgrid.grid_sweep))
    monkeypatch.setattr(twin, "separation_window", counted(
        twin, lambda *a, **kw: tnb.separation_window(*a, **kw)))
    monkeypatch.setattr(tn2, "auction_square_plain",
                        counted(tn2, tn2.auction_square_plain))
    extra = (dict(k_align=0.3, k_coh=0.1, field_deposit="sorted")
             if case == "auction-field" else
             dict(k_align=0.3, k_coh=0.1) if case.endswith("field")
             else {})
    sep = (dict(separation_mode="window", sort_every=8)
           if case.startswith("window") else
           dict(separation_mode="hashgrid", hashgrid_backend="pallas"))
    sep_mod = twin if case.startswith("window") else tgrid
    cfg = tdsa.DEFAULT_CONFIG.replace(
        world_hw=16.0, formation_shape="none", allocation_mode="auction",
        auction_every=5, utility_threshold=5.0, **sep, **extra)
    n, spans = 96, (20, 13) if sep_mod is tgrid else (24, 16)
    runs = {}
    for replayed in (False, True):
        monkeypatch.setattr(tsw, "replays_graphs", lambda dev: replayed)
        st = tdsa.make_swarm(n, spread=8.0, seed=4, device="cpu")
        st = tdsa.with_tasks(st, [[1.0, 1.0], [-2.0, 3.0], [4.0, -1.0]])
        before = (sep_mod.LAUNCHES, tn2.LAUNCHES)
        for k, ticks in enumerate(spans):
            if k:    # the top agent, and an awarded winner if any
                st = tdsa.kill(st, [n - 1] + st.task_winner[
                    st.task_winner >= 0][:1].tolist())
            st = tsw.swarm_rollout(st, None, cfg, ticks)
        runs[replayed] = (st, sep_mod.LAUNCHES - before[0],
                          tn2.LAUNCHES - before[1])
    (eager, *le), (graph, *lg) = runs[False], runs[True]
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(eager, f), getattr(graph, f)), f
    assert le == lg == [sum(spans), sum(spans)]
    chunk = tsw._chunk
    ticks = 8 if sep_mod is twin else 10
    assert chunk.kernel is sep_mod and chunk.others == ((tn2, ticks),)
    assert (graph.task_winner >= 0).all()


# --- N2's redesign: the zero rows' shared bid ---------------------------------


def shortcut_square(values, prices, eps, max_rounds, counts=None):
    """N2's round as the redesigned kernel runs it, in numpy f32: round 1
    reads every row; after it only the unseated agents whose row is not all
    zero read theirs, and the lowest unseated zero-row agent bids the zero
    row's bid, taken from the prices alone (its net values are 0 - prices).
    Each task takes its highest bid, ties to the lowest agent.  Returns
    ``(agent_task, task_agent, prices, rounds)``; ``counts`` gains
    ``rows``, the value rows read."""
    v = np.asarray(values, np.float32)
    s = v.shape[0]
    zero = ~(v != 0).any(1)
    at = np.full(s, -1, np.int32)
    ta = np.full(s, -1, np.int32)
    p = np.array(prices, np.float32)
    eps = np.float32(eps)
    rounds = 0

    def bids_of(net):
        """Bids of rows ``net`` [B, S] (the JAX round's bid, in f32)."""
        b = np.arange(len(net))
        j1 = net.argmax(1)
        w1 = net[b, j1]
        rest = net.copy()
        rest[b, j1] = -np.inf
        w2 = rest.max(1)
        w2 = np.where(np.isfinite(w2), w2, w1)
        return j1, (p[j1] + (w1 - w2)) + eps

    while rounds < max_rounds and (at < 0).any():
        unseated = at < 0
        rows = (np.arange(s) if rounds == 0
                else np.flatnonzero(unseated & ~zero))
        if counts is not None:
            counts["rows"] = counts.get("rows", 0) + len(rows)
        j1, bid = bids_of(v[rows] - p[None, :])
        agents = list(rows)
        if rounds > 0 and (unseated & zero).any():
            zj, zbid = bids_of((np.float32(0.0) - p)[None, :])
            agents.append(int(np.flatnonzero(unseated & zero)[0]))
            j1, bid = np.append(j1, zj), np.append(bid, zbid)
        best = {}
        for i, j, b in zip(agents, j1.tolist(), bid):
            if not unseated[i]:
                continue                    # round 1: only the unseated bid
            if j not in best or b > best[j][0] or (b == best[j][0]
                                                   and i < best[j][1]):
                best[j] = (b, i)
        for j, (b, i) in best.items():
            if ta[j] >= 0:
                at[ta[j]] = -1
            at[i], ta[j], p[j] = j, i, b
        rounds += 1
    return at, ta, p, rounds


def shortcut_assign(util, feasible, eps=0.25, max_rounds=100_000,
                    phases=None, theta=5.0):
    """``auction_assign`` (or, with ``phases``, ``auction_assign_scaled``)
    over :func:`shortcut_square`, padded and unpadded by the port."""
    values = tauc._square_values(t(util), t(feasible)).numpy()
    p = np.zeros(len(values), np.float32)
    total = 0
    for k in (range(phases - 1, -1, -1) if phases else [0]):
        at, ta, p, rounds = shortcut_square(
            values, p, np.float32(eps * float(theta) ** k) if phases
            else eps, max_rounds)
        total += rounds
    return tauc._unpad(t(util), t(feasible), t(at), t(ta), t(p),
                       torch.tensor(total, dtype=torch.int32))


def zero_row_instance(case):
    """(util, feasible, kwargs) of the shortcut's cases."""
    rng = np.random.default_rng(21)
    util = rng.uniform(1.0, 100.0, (60, 60)).astype(np.float32)
    feasible = rng.random((60, 60)) < 0.8
    if case == "third-infeasible":     # a third of the agents, and the dead
        feasible[rng.choice(60, 20, replace=False)] = False
        alive = rng.random(60) > 0.1
        feasible &= alive[:, None]
    elif case == "virtual-rows":       # N < T: 24 virtual zero rows
        util, feasible = util[:36], feasible[:36]
    elif case == "virtual-columns":    # N > T, some agents infeasible
        util, feasible = util[:, :37], feasible[:, :37]
        feasible[::4] = False
    elif case == "ties":
        util[:] = 10.0
        feasible[rng.choice(60, 25, replace=False)] = False
    elif case == "cap-mid-war":
        feasible[:30] = False
        return util, feasible, dict(max_rounds=20)
    elif case == "scaled":
        feasible[rng.choice(60, 20, replace=False)] = False
        return util, feasible, dict(phases=4)
    return util, feasible, {}


@pytest.mark.parametrize("case", ["third-infeasible", "virtual-rows",
                                  "virtual-columns", "ties", "cap-mid-war",
                                  "scaled"])
def test_zero_rows_shared_bid_equals_jax_auction(case):
    """The redesign's round (the zero rows' bid once a round from the
    prices, only the lowest unseated zero-row agent bidding it) gives JAX's
    assignment, prices and rounds exactly: flat, scaled (warm prices), with
    virtual rows and columns, ties and the round cap reached mid-war."""
    util, feasible, kw = zero_row_instance(case)
    got = shortcut_assign(util, feasible, **kw)
    if "phases" in kw:
        want = jauc.auction_assign_scaled(jnp.asarray(util),
                                          jnp.asarray(feasible),
                                          phases=kw["phases"])
    else:
        want = jauc.auction_assign(jnp.asarray(util), jnp.asarray(feasible),
                                   **kw)
    for name, a, b in zip(got._fields, got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), (case, name)
    if case == "cap-mid-war":
        assert int(got.rounds) == 20


def zero_row_square(s=512, n_zero=160, seed=0):
    """[S, S] uniform(1, 100) values whose last ``n_zero`` rows are 0."""
    v = np.random.default_rng(seed).uniform(1.0, 100.0, (s, s)).astype(
        np.float32)
    v[s - n_zero:] = 0.0
    return v


def test_plain_counts_pin_zero_and_needed_rows():
    """On 512 agents, 160 of them with no feasible task: 161 rounds read
    13,560 rows, 13,039 of them zero rows; the redesign needs 512 in round
    1 and the 169 real re-bids after it, 681, as the shortcut model
    reads."""
    v = zero_row_square()
    counts, model = {}, {}
    out = tn2.auction_square_plain(t(v), torch.zeros(512), torch.tensor(0.25),
                                   100_000, counts=counts)
    assert int(out[3]) == 161
    assert counts == dict(bidder_rows=13_560, zero_rows=13_039,
                          needed_rows=681)
    at, ta, p, rounds = shortcut_square(v, np.zeros(512, np.float32), 0.25,
                                        100_000, counts=model)
    assert model["rows"] == counts["needed_rows"] and rounds == 161
    for a, b in zip((at, ta, p), out[:3]):
        assert np.array_equal(a, b.numpy())
