"""The port's window tick against the JAX package.

The same numpy inputs go through the JAX functions (on the CPU, where
``separation_mode="window"`` takes the portable roll chain) and through the
port's plain versions, which are what the port runs on a CPU tensor.

Tolerances, each with its reason:

- ``morton_keys`` and every integer or bool field: exact.  The keys decide
  the slot order, and the slot order decides which agent draws which
  election jitter.
- ``separation_window``: ``|port - jax| <= 1e-5 * sum|terms| + 1e-5`` per
  agent and axis.  Both compute the same formula in f32, but XLA on the
  CPU fuses ``a + b * c`` into one multiply-add where PyTorch rounds twice
  (ROADMAP Queue C), so each term may differ by an ulp or two; where the
  terms of a sum nearly cancel, that is more than 1e-5 of the sum (seen:
  4.6e-5 on a force of 0.37 made of terms in the thousands), so the band
  is relative to the sum of the terms' absolute values.
- Against the TPU kernel ``separation_window_pallas`` (interpret mode):
  rtol=1e-4, atol=1e-3, the JAX package's own band for it; it rounds the
  force as ``k / d^3 * diff``.
- ``pos`` and ``vel`` after one tick: rtol=1e-5, atol=1e-5, as for the
  other modes (tests/test_torch_swarm.py).

Under ``sort_every > 1`` the tick permutes the whole state by Morton key,
and the election jitter is drawn per slot, so rollouts are compared from
the same state at every chunk; a free-running comparison holds only the
outcomes that cannot depend on slot order.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import neighbors as jnb
from distributed_swarm_algorithm_tpu.ops.pallas.window_separation import (
    separation_window_pallas,
)
from distributed_swarm_algorithm_tpu_torch import cli as tcli
from distributed_swarm_algorithm_tpu_torch.ops import neighbors as tnb
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    window_separation as twin,
)

REPO = Path(__file__).resolve().parent.parent
K_SEP, R, EPS = 20.0, 2.0, 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
BENCH_TASKS = [[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0], [0.0, 9.0]]


def jax_to_numpy(s):
    return {
        f.name: np.asarray(getattr(s, f.name))
        for f in dataclasses.fields(s)
        if f.name != "key"
    }


def jax_jitter(s, cfg, n_ticks):
    """[n_ticks, N] i32: the jitter JAX's next ``n_ticks`` coordination
    steps draw from ``s.key``, one split per tick."""
    key, out = s.key, []
    for _ in range(n_ticks):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(
            sub, (s.n_agents,), 0, cfg.election_jitter_ticks + 1)))
    return torch.from_numpy(np.stack(out))


def assert_discrete_equal(got, want, where=""):
    for f, w in want.items():
        if w.dtype.kind in "biu":
            assert got[f].dtype == w.dtype, (where, f)
            np.testing.assert_array_equal(got[f], w, err_msg=f"{where} {f}")


def window_cfgs(**kw):
    return tuple(
        pkg.DEFAULT_CONFIG.replace(separation_mode="window", **kw)
        for pkg in (jdsa, tdsa)
    )


def bench_scenario(n, spread, seed=0):
    """bench_swarm_tpu.py's protocol scenario: uniform spawn, four tasks,
    a shared target [50, 0]."""
    s = jdsa.make_swarm(n, seed=seed, spread=spread)
    s = jdsa.with_tasks(s, jnp.asarray(BENCH_TASKS))
    return s.replace(
        target=jnp.broadcast_to(jnp.asarray([50.0, 0.0]), s.pos.shape),
        has_target=jnp.ones_like(s.has_target),
    )


def swarm_arrays(n, seed, side=60.0, dim=2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-side, side, (n, dim)).astype(np.float32)
    return pos, np.arange(n) % 97 != 0


def both_windows(pos, alive, window, cell=2.0, **kw):
    want = jnb.separation_window(jnp.asarray(pos), jnp.asarray(alive), K_SEP,
                                 R, EPS, cell, window, **kw)
    got = tnb.separation_window(torch.from_numpy(pos),
                                torch.from_numpy(alive), K_SEP, R, EPS, cell,
                                window, **kw)
    return np.asarray(want), got.numpy()


def assert_window_band(got, pos, alive, window, want, cell=2.0, **kw):
    """``|got - want| <= 1e-5 * sum|terms| + 1e-5`` per agent and axis."""
    scale = tnb.separation_window(
        torch.from_numpy(pos), torch.from_numpy(alive), K_SEP, R, EPS, cell,
        window, absolute=True, **kw).numpy()
    assert (np.abs(got) <= scale * (1 + 1e-6)).all()
    excess = np.abs(got - want) - (1e-5 * scale + 1e-5)
    assert excess.max() <= 0, (np.abs(got - want).max(), excess.max())


# --- morton_keys, window_shifts --------------------------------------------

def _key_positions(kind, cell, rng):
    if kind == "random":
        return rng.uniform(-1000, 1000, (4096, 2)).astype(np.float32)
    if kind == "edges":
        k = np.arange(-40, 41, dtype=np.float32) * np.float32(cell)
        edge = np.concatenate([k, np.nextafter(k, np.float32(-np.inf)),
                               np.nextafter(k, np.float32(np.inf)),
                               np.array([-0.0, 0.0], np.float32)])
        return np.stack([edge, edge[::-1]], 1).astype(np.float32)
    span = np.float32(32768 * cell)
    far = np.array([-3 * span, -span - cell, -span, -span + cell, span - cell,
                    span, span + cell, 3 * span, 1e7, -1e7], np.float32)
    grid = np.stack(np.meshgrid(far, far), -1).reshape(-1, 2)
    return grid.astype(np.float32)


@pytest.mark.parametrize("cell", [2.0, 1.5])
@pytest.mark.parametrize("kind", ["random", "edges", "clipped"])
def test_morton_keys_equal_jax(kind, cell):
    pos = _key_positions(kind, cell, np.random.default_rng(7))
    want = np.asarray(jnb.morton_keys(jnp.asarray(pos), cell))
    got = tnb.morton_keys(torch.from_numpy(pos), cell)
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if kind == "clipped":   # the saturated corners reach both key extremes
        assert got.min() == 0 and got.max() == 0xFFFFFFFF


@pytest.mark.parametrize("n", [1, 5, 40])
@pytest.mark.parametrize("window", [1, 3, 50])
def test_window_shifts_equal_jax(n, window):
    want = [(s, np.asarray(v)) for s, v in jnb.window_shifts(n, window)]
    got = [(s, v.numpy()) for s, v in tnb.window_shifts(n, window)]
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- separation_window -----------------------------------------------------

@pytest.mark.parametrize(
    "n,window,seed,kw",
    [
        (9000, 1, 0, {}),
        (9000, 8, 0, {}),
        (9000, 16, 0, {}),
        (5000, 16, 5, {}),
        (3000, 8, 1, dict(passes=2)),
        (3000, 6, 2, dict(passes=2, cell=1.5)),
    ],
    ids=["w1", "w8", "w16", "ragged", "two-passes", "two-passes-cell1.5"],
)
def test_separation_window_matches_jax(n, window, seed, kw):
    pos, alive = swarm_arrays(n, seed)
    want, got = both_windows(pos, alive, window, **kw)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    assert (want != 0).any(axis=1).sum() > n // 10   # many agents feel a force
    assert_window_band(got, pos, alive, window, want, **kw)
    np.testing.assert_array_equal(got[~alive], 0.0)


@pytest.mark.parametrize("passes", [1, 2])
def test_separation_window_presorted_matches_jax(passes):
    pos, alive = swarm_arrays(8192, 3)
    order = np.argsort(np.asarray(jnb.morton_keys(jnp.asarray(pos), 2.0)),
                       kind="stable")
    pos, alive = pos[order], alive[order]
    want, got = both_windows(pos, alive, 12, presorted=True, passes=passes)
    assert_window_band(got, pos, alive, 12, want, presorted=True,
                       passes=passes)


def test_separation_window_all_dead_is_zero():
    pos, _ = swarm_arrays(2048, 7)
    _, got = both_windows(pos, np.zeros(2048, bool), 8)
    assert np.abs(got).max() == 0.0


def test_separation_window_3d_is_dense():
    pos, alive = swarm_arrays(300, 4, side=5.0, dim=3)
    want, got = both_windows(pos, alive, 4)
    dense = tnb.separation_dense(torch.from_numpy(pos),
                                 torch.from_numpy(alive), K_SEP, R, EPS)
    torch.testing.assert_close(torch.from_numpy(got), dense, rtol=0, atol=0)
    np.testing.assert_allclose(got, want, **TOL)


def test_separation_window_validates():
    pos, alive = swarm_arrays(64, 0)
    pos, alive = torch.from_numpy(pos), torch.from_numpy(alive)
    with pytest.raises(ValueError, match="window"):
        tnb.separation_window(pos, alive, K_SEP, R, EPS, 2.0, 0)
    with pytest.raises(ValueError, match="passes"):
        tnb.separation_window(pos, alive, K_SEP, R, EPS, 2.0, 4, passes=3)


@pytest.mark.parametrize(
    "n,window,seed,presorted",
    [(5000, 16, 5, False), (8192, 12, 3, True)],
    ids=["ragged-unsorted", "presorted"],
)
def test_port_and_tpu_kernel_compute_the_same_function(n, window, seed,
                                                       presorted):
    pos, alive = swarm_arrays(n, seed)
    if presorted:
        order = np.argsort(np.asarray(jnb.morton_keys(jnp.asarray(pos), 2.0)),
                           kind="stable")
        pos, alive = pos[order], alive[order]
    want = separation_window_pallas(
        jnp.asarray(pos), jnp.asarray(alive), K_SEP, R, EPS, 2.0, window,
        presorted=presorted, interpret=True,
    )
    got = twin.separation_window(
        torch.from_numpy(pos), torch.from_numpy(alive), K_SEP, R, EPS, 2.0,
        window, presorted=presorted,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


# --- dispatch --------------------------------------------------------------

def test_window_tick_on_the_cpu_runs_the_plain_version(monkeypatch):
    calls = []
    plain = tnb.separation_window

    def spy(*a, **kw):
        calls.append(kw.get("presorted"))
        return plain(*a, **kw)

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel ran on a CPU tensor")

    monkeypatch.setattr(tnb, "separation_window", spy)
    monkeypatch.setattr(twin, "separation_window_cuda", no_kernel)
    before = twin.LAUNCHES
    s = tdsa.make_swarm(64, spread=5.0, device="cpu")
    s = s.replace(target=torch.full_like(s.pos, 9.0),
                  has_target=torch.ones_like(s.has_target))
    for sort_every in (1, 4):
        _, cfg = window_cfgs(sort_every=sort_every)
        out = tdsa.physics_step(s, None, cfg)
        assert torch.isfinite(out.pos).all()
    assert calls == [False, True] and twin.LAUNCHES == before


def test_window_module_imports_without_nvcc():
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda."
            "window_separation as m; assert m._fn is None and "
            "m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_window_kernel_wrapper_rejects_cpu_tensors():
    pos, alive = swarm_arrays(16, 0)
    before = twin.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        twin.separation_window_cuda(torch.from_numpy(pos),
                                    torch.from_numpy(alive), K_SEP, R, EPS, 4)
    assert twin.LAUNCHES == before


# --- the tick --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_states(sort_every, ticks):
    """The JAX bench scenario at each of ``ticks``, stepped by swarm_tick
    (its in-tick re-sort keeps the cadence), with the state's key."""
    cfg, _ = window_cfgs(sort_every=sort_every)
    s = bench_scenario(192, spread=10.0, seed=3)
    out = {}
    for t in range(max(ticks) + 1):
        if t in ticks:
            out[t] = s
        s = jdsa.swarm_tick(s, None, cfg)
    return out


@pytest.mark.parametrize("sort_every", [1, 8])
@pytest.mark.parametrize("tick", [0, 45, 48],
                         ids=["tick1-sorts", "tick46-no-sort", "tick49-sorts"])
def test_one_window_tick_matches_jax(sort_every, tick):
    cfg, tcfg = window_cfgs(sort_every=sort_every)
    js = _jax_states(sort_every, (0, 45, 48))[tick]
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    jitter = jax_jitter(js, cfg, 1)[0]
    js = jdsa.swarm_tick(js, None, cfg)
    ts = tdsa.swarm_tick(ts, None, tcfg, jitter)
    want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
    assert_discrete_equal(got, want)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **TOL)
    if sort_every > 1 and (tick + 1) % sort_every == 1:   # the sort fired
        assert not np.array_equal(want["agent_id"], np.arange(192))
    if tick:
        assert int(tdsa.current_leader(ts)[0]) == 191


def test_chunked_rollout_matches_jax_at_every_chunk():
    # 200 ticks in rollouts of 12: one chunk of sort_every = 8 and a
    # remainder chunk of 4, each opening with a re-sort.  Every rollout
    # starts from JAX's state, with JAX's jitter handed in.
    n, calls, kill_after = 256, 17, 5
    cfg, tcfg = window_cfgs(sort_every=8)
    js = bench_scenario(n, spread=20.0)
    leaders = []
    for c in range(calls):
        steps = 12 if c < calls - 1 else 8
        if c == kill_after:            # the leader dies after tick 60
            js = jdsa.kill(js, [n - 1])
        ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
        jitter = jax_jitter(js, cfg, steps)
        js = jdsa.swarm_rollout(js, None, cfg, steps)
        ts = tdsa.swarm_rollout(ts, None, tcfg, steps, jitter=jitter)
        want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
        assert_discrete_equal(got, want, where=f"rollout {c}")
        np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"rollout {c}")
        leaders.append(int(tdsa.current_leader(ts)[0]))
    assert int(js.tick) == 200
    assert leaders[kill_after - 1] == n - 1 and leaders[-1] == n - 2
    assert (got["task_winner"] >= 0).all()


def test_free_running_rollout_reaches_the_jax_outcome(record_property):
    # No re-anchoring.  With no election jitter every agent waits the same
    # number of ticks, so the election cannot depend on slot order.
    n = 256
    cfg, tcfg = window_cfgs(sort_every=8, election_jitter_ticks=0)
    js = bench_scenario(n, spread=20.0)
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    leaders = []
    for steps, kill in ((60, False), (140, True)):
        if kill:
            js, ts = jdsa.kill(js, [n - 1]), tdsa.kill(ts, [n - 1])
        js = jdsa.swarm_rollout(js, None, cfg, steps)
        ts = tdsa.swarm_rollout(ts, None, tcfg, steps)
        leaders.append((int(jdsa.current_leader(js)[0]),
                        int(tdsa.current_leader(ts)[0])))
    assert leaders == [(n - 1, n - 1), (n - 2, n - 2)]
    want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
    np.testing.assert_array_equal(got["task_winner"], want["task_winner"])
    assert (got["task_winner"] >= 0).all()
    record_property("slot_order_agreement",
                    float((got["agent_id"] == want["agent_id"]).mean()))


def test_record_returns_frames_in_id_order_under_resort():
    _, tcfg = window_cfgs(sort_every=3)
    sw = tdsa.VectorSwarm(32, config=tcfg, seed=2, spread=10.0, device="cpu")
    sw.set_target([5.0, 0.0])
    traj = sw.step(12, record=True)
    assert traj.shape == (12, 32, 2)
    aid = sw.state.agent_id.long()
    assert not torch.equal(aid, torch.arange(32))   # slots did move
    want = torch.empty_like(sw.state.pos)
    want[aid] = sw.state.pos
    torch.testing.assert_close(traj[-1], want, rtol=0, atol=0)
    step_d = (traj[1:] - traj[:-1]).norm(dim=-1)
    assert step_d.max() <= tcfg.max_speed * tcfg.dt + 1e-4


def test_vector_swarm_window_flow_survives_permutation():
    # The README flow with slots permuted every 5 ticks: identity lives in
    # agent_id, and kill matches by value.
    _, tcfg = window_cfgs(sort_every=5)
    sw = tdsa.VectorSwarm(64, config=tcfg, seed=1, spread=30.0, device="cpu")
    sw.set_target([10.0, 0.0])
    sw.step(40)
    assert sw.leader() == (63, True)
    sw.kill([63])
    sw.step(40)
    assert sw.leader() == (62, True)
    assert torch.isfinite(sw.state.pos).all()


def test_vector_swarm_single_steps_match_jax():
    # step(1) is swarm_tick, whose re-sort follows the tick counter (ticks
    # 1 and 9 here); a rollout would re-sort at every call.
    cfg, tcfg = window_cfgs(sort_every=8)
    jsw = jdsa.VectorSwarm(96, config=cfg, seed=1, spread=30.0)
    jsw.set_target([10.0, 0.0])
    start = tdsa.state_from_numpy(jax_to_numpy(jsw.state), device="cpu")
    tsw = tdsa.VectorSwarm(96, config=tcfg, device="cpu")
    tsw.state = start
    for t in range(16):
        jsw.step(1)
        tsw.step(1)
        assert_discrete_equal(tdsa.state_to_numpy(tsw.state),
                              jax_to_numpy(jsw.state), where=f"tick {t + 1}")
    # One-tick rollouts instead re-sort before every tick.
    ts = start
    for _ in range(16):
        ts = tdsa.swarm_rollout(ts, None, tcfg, 1)
    assert not torch.equal(ts.agent_id, tsw.state.agent_id)


def test_cli_swarm_window_prints_its_json(capsys):
    rc = tcli.main(["swarm", "--device", "cpu", "--n", "48", "--steps",
                    "40", "--separation", "window", "--target", "5", "0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["agents"] == 48 and out["ticks"] == 40
    assert out["backend"] == "torch-cpu" and out["leader"] == 47
