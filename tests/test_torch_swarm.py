"""The port's whole-swarm tick against the JAX package's ``swarm_tick``.

Every comparison starts from one state, converted through numpy, and hands
the JAX key chain's election jitter to the port.

- One tick (dense, pallas and off separation, with obstacles): integer
  and bool fields exact; ``pos`` and ``vel`` within rtol=1e-5, atol=1e-5.
  The two frameworks round a few operations differently (XLA on the CPU
  fuses ``a + b * c`` into one multiply-add; the separation sums run in
  another order), a few f32 ulps at positions of tens of metres.
- The bench scenario shrunk to 128 agents for 200 ticks with a leader
  kill: discrete state exact at every tick.  Positions are chaotic where
  agents touch: the separation force jumps from 5 to 0 at the edge of the
  personal space, so a last-bit difference there becomes a whole step.
  Measured on this scenario: every agent within 1.9e-4 m up to the kill
  at tick 60, the median agent within 8.8e-5 m and the centroid within
  0.034 m over all 200 ticks, the worst agent up to 5 m.  The test holds
  the bounds 1e-3 m, 1e-3 m and 0.1 m.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parent.parent
BENCH_TASKS = [[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0], [0.0, 9.0]]
OBSTACLES = np.array([[8.0, 2.0, 1.5], [-6.0, -4.0, 2.0]], np.float32)


def jax_to_numpy(s):
    return {
        f.name: np.asarray(getattr(s, f.name))
        for f in dataclasses.fields(s)
        if f.name != "key"
    }


def jax_jitter(s, cfg):
    """The jitter JAX's next coordination_step draws from ``s.key``."""
    _, sub = jax.random.split(s.key)
    return torch.from_numpy(np.array(jax.random.randint(
        sub, (s.n_agents,), 0, cfg.election_jitter_ticks + 1
    )))


def assert_discrete_equal(got, want, where=""):
    for f, w in want.items():
        if w.dtype.kind in "biu":
            assert got[f].dtype == w.dtype, (where, f)
            np.testing.assert_array_equal(got[f], w, err_msg=f"{where} {f}")


def bench_scenario(n, spread):
    """bench_swarm_tpu.py's protocol scenario: uniform spawn, four tasks,
    a shared target [50, 0]."""
    s = jdsa.make_swarm(n, seed=0, spread=spread)
    s = jdsa.with_tasks(s, jnp.asarray(BENCH_TASKS))
    return s.replace(
        target=jnp.broadcast_to(jnp.asarray([50.0, 0.0]), s.pos.shape),
        has_target=jnp.ones_like(s.has_target),
    )


@pytest.mark.parametrize("mode", ["dense", "pallas", "off"])
@pytest.mark.parametrize("warm_ticks", [0, 45])
def test_one_tick_matches_jax(mode, warm_ticks):
    cfg = jdsa.DEFAULT_CONFIG.replace(separation_mode=mode)
    tcfg = tdsa.DEFAULT_CONFIG.replace(separation_mode=mode)
    js = bench_scenario(96, spread=8.0)
    if warm_ticks:   # mid-protocol: a leader, heartbeats, awards, a V
        js = jdsa.swarm_rollout(js, jnp.asarray(OBSTACLES), cfg, warm_ticks)
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    jitter = jax_jitter(js, cfg)
    js = jdsa.swarm_tick(js, jnp.asarray(OBSTACLES), cfg)
    ts = tdsa.swarm_tick(ts, torch.from_numpy(OBSTACLES), tcfg, jitter)
    want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
    assert_discrete_equal(got, want)
    for f in ("pos", "vel"):
        assert got[f].dtype == np.float32
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize(
    "variant",
    [
        dict(formation_shape="line"),
        dict(formation_shape="none"),
        dict(formation_rank_mode="id"),
        dict(allocation_lock_on_award=False),
        dict(separation_mode="pallas", dim=3),
    ],
    ids=["line", "no-formation", "id-rank", "live-realloc", "pallas-3d"],
)
def test_one_tick_config_variants_match_jax(variant):
    variant = dict(variant)
    dim = variant.pop("dim", 2)
    cfg = jdsa.DEFAULT_CONFIG.replace(**variant)
    tcfg = tdsa.DEFAULT_CONFIG.replace(**variant)
    js = jdsa.make_swarm(64, dim=dim, seed=2, spread=6.0)
    js = jdsa.with_tasks(js, jnp.asarray(BENCH_TASKS)[:, :dim] if dim == 2
                         else jnp.ones((2, dim)))
    js = js.replace(target=jnp.full(js.pos.shape, 20.0),
                    has_target=jnp.ones_like(js.has_target))
    js = jdsa.swarm_rollout(js, None, cfg, 40)
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    jitter = jax_jitter(js, cfg)
    js = jdsa.swarm_tick(js, None, cfg)
    ts = tdsa.swarm_tick(ts, None, tcfg, jitter)
    want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
    assert_discrete_equal(got, want)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)


def test_rollout_with_leader_kill_matches_jax():
    n, kill_at = 128, 60
    cfg = jdsa.DEFAULT_CONFIG.replace(separation_mode="pallas")
    tcfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="pallas")
    js = bench_scenario(n, spread=20.0)
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    leaders, worst_median, worst_centroid = [], 0.0, 0.0
    for t in range(1, 201):
        if t == kill_at:
            js, ts = jdsa.kill(js, [n - 1]), tdsa.kill(ts, [n - 1])
        jitter = jax_jitter(js, cfg)
        js = jdsa.swarm_tick(js, None, cfg)
        ts = tdsa.swarm_tick(ts, None, tcfg, jitter)
        want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
        assert_discrete_equal(got, want, where=f"tick {t}")
        assert np.isfinite(got["pos"]).all()
        dev = np.abs(got["pos"] - want["pos"])
        if t < kill_at:
            assert dev.max() <= 1e-3, (t, dev.max())
        worst_median = max(worst_median, float(np.median(dev)))
        worst_centroid = max(worst_centroid, float(np.abs(
            got["pos"].mean(0) - want["pos"].mean(0)).max()))
        leaders.append(int(tdsa.current_leader(ts)[0]))
    assert worst_median <= 1e-3
    assert worst_centroid <= 0.1
    assert leaders[kill_at - 2] == n - 1 and leaders[-1] == n - 2
    assert (got["task_winner"] >= 0).all()


def test_rollout_records_the_trajectory():
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="pallas")
    s = tdsa.make_swarm(32, spread=5.0, device="cpu")
    s = s.replace(target=torch.full_like(s.pos, 9.0),
                  has_target=torch.ones_like(s.has_target))
    jitter = torch.zeros((12, 32), dtype=torch.int32)
    end, traj = tdsa.swarm_rollout(s, None, cfg, 12, record=True,
                                   jitter=jitter)
    assert traj.shape == (12, 32, 2) and traj.dtype == torch.float32
    torch.testing.assert_close(traj[-1], end.pos, rtol=0, atol=0)
    again = tdsa.swarm_rollout(s, None, cfg, 12, jitter=jitter)
    torch.testing.assert_close(again.pos, end.pos, rtol=0, atol=0)
    with pytest.raises(ValueError, match="jitter"):
        tdsa.swarm_rollout(s, None, cfg, 3, jitter=jitter)


def test_vector_swarm_quickstart_flow():
    # The README flow: the highest id leads, and after its death the next.
    sw = tdsa.VectorSwarm(64, spread=10.0, device="cpu",
                          config=tdsa.DEFAULT_CONFIG.replace(
                              separation_mode="pallas"))
    sw.set_target([50.0, 0.0])
    sw.add_tasks(BENCH_TASKS)
    sw.set_obstacles([[20.0, 0.0, 2.0]])
    sw.step(100)
    assert sw.leader() == (63, True)
    assert sw.task_statuses().shape == (64, 4)
    sw.kill([63])
    sw.step(40)
    assert sw.leader() == (62, True)
    sw.revive([63])
    sw.run_realtime(0)
    traj = sw.step(2, record=True)
    assert traj.shape == (2, 64, 2)
    assert sw.leader() == (62, True)    # a revived agent rejoins as follower


def test_cli_swarm_prints_its_json(capsys):
    rc = tcli.main(["swarm", "--device", "cpu", "--n", "24", "--steps",
                    "40", "--separation", "pallas", "--target", "5", "0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"agents", "ticks", "backend", "leader",
                        "ticks_per_sec", "agent_steps_per_sec"}
    assert out["agents"] == 24 and out["ticks"] == 40
    assert out["backend"] == "torch-cpu" and out["leader"] == 23


def test_entry_points_without_cuda_raise(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.make_swarm(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.VectorSwarm(4)
    assert tcli.main(["swarm", "--n", "4", "--steps", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert tdsa.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "mode", ["k_align-hashgrid", "window", "field-deposit-sorted",
             "tiebreak", "island-telemetry", "island-shift-fn"])
def test_unported_modes_raise_with_their_roadmap_item(mode):
    # Every separation mode runs since slice 3; what still raises is the
    # moments field (item 9), the window sizing helpers (item 6), the
    # sharded tick's tiebreak (item 16) and, of the island model, its
    # telemetry (item 11) and the sharded ring shift (item 17).
    from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan

    if mode.startswith("island"):
        from distributed_swarm_algorithm_tpu_torch.ops import objectives
        from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
            islands_fused,
        )
        from distributed_swarm_algorithm_tpu_torch.parallel import islands

        st = islands.island_init(objectives.sphere, 2, 8, 2, 5.12,
                                 device="cpu")
        if mode == "island-telemetry":
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue A item 11"):
                islands.island_run(st, objectives.sphere, 1, telemetry=True)
        else:
            flat = torch.zeros(2, 16)
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue A item 17"):
                islands_fused._migrate_t(
                    flat, flat, flat, torch.zeros(1, 16), 1, 2, 8,
                    shift_fn=lambda p, f: (p, f))
        return

    s = tdsa.make_swarm(4, device="cpu", spread=3.0)
    if mode == "window":   # the tick is ported; its sizing helpers are not
        from distributed_swarm_algorithm_tpu_torch.ops import neighbors

        for helper in (neighbors.suggest_window,
                       neighbors.neighbor_counts_sampled):
            with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
                helper(s.pos, 2.0)
        return
    hashgrid = tdsa.DEFAULT_CONFIG.replace(separation_mode="hashgrid",
                                           world_hw=16.0)
    plan = tdsa.build_tick_plan(s, hashgrid)
    if mode == "tiebreak":
        with pytest.raises(NotImplementedError, match="item 16"):
            tdsa.build_hashgrid_plan(s.pos, s.alive, 16.0, 2.0, 8,
                                     tiebreak=s.agent_id)
        return
    if mode == "field-deposit-sorted":
        cfg = hashgrid.replace(k_coh=0.5, field_deposit="sorted")
        for call in (lambda: hashgrid_plan.plan_cell_sums(plan, s.pos),
                     lambda: hashgrid_plan.plan_field_keys(plan)):
            with pytest.raises(NotImplementedError, match="item 9"):
                call()
    else:
        cfg = hashgrid.replace(k_align=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 9"):
        tdsa.swarm_tick(s, None, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 9"):
        tdsa.build_tick_plan(s, cfg)


def test_unported_options_raise():
    s = tdsa.make_swarm(4, device="cpu")
    for cfg in (
        tdsa.DEFAULT_CONFIG.replace(telemetry=tdsa.TELEMETRY_ON),
        tdsa.DEFAULT_CONFIG.replace(k_align=1.0),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            tdsa.swarm_tick(s, None, cfg)
    with pytest.raises(ValueError, match="unknown separation_mode"):
        tdsa.swarm_tick(
            s, None, tdsa.DEFAULT_CONFIG.replace(separation_mode="nope")
        )


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "distributed_swarm_algorithm_tpu_torch").rglob(
        "*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = {"jax", "jaxlib", "flax", "distributed_swarm_algorithm_tpu"}
    for path in files:
        hits = banned & set(_imported_roots(path))
        assert not hits, f"{path.relative_to(REPO)} imports {sorted(hits)}"
