"""The port's swarm state against the JAX package's, field for field.

States cross between the two through numpy (``state_from_numpy`` /
``state_to_numpy``).  Everything here is exact: construction, the
fault-injection events and the caches they maintain involve no float
arithmetic.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
from distributed_swarm_algorithm_tpu import state as jstate
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu_torch import state as tstate
from distributed_swarm_algorithm_tpu_torch.models import _checkpoint

TASKS = np.array([[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0]], np.float32)


def jax_to_numpy(s):
    return {
        f.name: np.asarray(getattr(s, f.name))
        for f in dataclasses.fields(s)
        if f.name != "key"
    }


def assert_same_fields(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_fields_match_the_jax_state():
    jax_fields = [f.name for f in dataclasses.fields(jstate.SwarmState)]
    assert tstate.TENSOR_FIELDS == tuple(f for f in jax_fields if f != "key")
    assert tstate.AGENT_AXIS_FIELDS == jstate.AGENT_AXIS_FIELDS
    for c in ("FOLLOWER", "ELECTION_WAIT", "LEADER", "NO_LEADER", "NO_CAP",
              "NO_WINNER", "TASK_OPEN", "TASK_TENTATIVE", "TASK_ASSIGNED",
              "TASK_LOCKED"):
        assert getattr(tstate, c) == getattr(jstate, c), c


@pytest.mark.parametrize(
    "n,dim,n_tasks,n_caps", [(16, 2, 0, 1), (33, 3, 3, 2), (8, 2, 3, 0)]
)
def test_make_swarm_matches_jax(n, dim, n_tasks, n_caps):
    js = jdsa.make_swarm(n, dim=dim, n_tasks=n_tasks, n_caps=n_caps)
    ts = tdsa.make_swarm(n, dim=dim, n_tasks=n_tasks, n_caps=n_caps,
                         device="cpu")
    assert_same_fields(tdsa.state_to_numpy(ts), jax_to_numpy(js))
    # with_tasks installs the same task table.
    task_pos = np.random.default_rng(n).normal(size=(4, dim))
    task_cap = np.array([-1, 0, 0, -1], np.int32)
    assert_same_fields(
        tdsa.state_to_numpy(tdsa.with_tasks(ts, task_pos, task_cap)),
        jax_to_numpy(jdsa.with_tasks(js, jnp.asarray(task_pos), task_cap)),
    )


def test_numpy_round_trip():
    s = tdsa.make_swarm(40, n_tasks=2, spread=5.0, seed=3, device="cpu")
    s = tdsa.instant_election(tdsa.kill(s, [39, 7]))
    arrays = tdsa.state_to_numpy(s)
    back = tdsa.state_from_numpy(arrays, device="cpu")
    assert_same_fields(tdsa.state_to_numpy(back), arrays)
    with pytest.raises(ValueError, match="missing fields"):
        tdsa.state_from_numpy({"pos": arrays["pos"]}, device="cpu")


def _jax_and_port(n=24, spread=3.0):
    """A JAX state with a known leader, tasks and scattered positions,
    and the same state in the port."""
    js = jdsa.make_swarm(n, n_tasks=3, spread=spread, seed=1)
    js = jdsa.with_tasks(js, jnp.asarray(TASKS))
    js = jdsa.instant_election(js)
    return js, tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")


@pytest.mark.parametrize(
    "events",
    [
        [("kill", [23])],                        # the leader
        [("kill", [3, 5, 23]), ("revive", [5])],
        [("kill", [0, 23]), ("revive", [23, 0]), ("kill", [12])],
        [("revive", [4])],                       # revive a live agent
    ],
    ids=["kill-leader", "kill-revive", "kill-revive-leader", "revive-live"],
)
def test_kill_revive_match_jax(events):
    js, ts = _jax_and_port()
    for name, ids in events:
        js = getattr(jdsa, name)(js, ids)
        ts = getattr(tdsa, name)(ts, ids)
        assert_same_fields(tdsa.state_to_numpy(ts), jax_to_numpy(js))
    lid_j, ex_j = jdsa.current_leader(js)
    lid_t, ex_t = tdsa.current_leader(ts)
    assert (int(lid_t), bool(ex_t)) == (int(lid_j), bool(ex_j))


def test_recount_and_instant_election_match_jax():
    js, ts = _jax_and_port()
    alive = np.ones(24, bool)
    alive[[2, 9, 23]] = False
    js = js.replace(alive=jnp.asarray(alive))
    ts = ts.replace(alive=torch.from_numpy(alive))
    assert_same_fields(
        tdsa.state_to_numpy(tstate.recount_alive_below(ts)),
        jax_to_numpy(jstate.recount_alive_below(js)),
    )
    assert_same_fields(
        tdsa.state_to_numpy(tdsa.instant_election(ts)),
        jax_to_numpy(jdsa.instant_election(js)),
    )


def test_permute_and_sort_match_jax():
    js, ts = _jax_and_port()
    order = np.random.default_rng(0).permutation(24).astype(np.int32)
    assert_same_fields(
        tdsa.state_to_numpy(tstate.permute_agents(ts, torch.from_numpy(order))),
        jax_to_numpy(jstate.permute_agents(js, jnp.asarray(order))),
    )
    keys = np.random.default_rng(1).integers(0, 5, 24).astype(np.int32)
    assert_same_fields(
        tdsa.state_to_numpy(
            tstate.sort_agents_by_key(ts, torch.from_numpy(keys))
        ),
        jax_to_numpy(jstate.sort_agents_by_key(js, jnp.asarray(keys))),
    )


def test_checkpoint_round_trip(tmp_path):
    sw = tdsa.VectorSwarm(32, n_tasks=0, spread=4.0, seed=2, device="cpu")
    sw.add_tasks(TASKS)
    sw.set_target([10.0, 0.0])
    sw.step(35)
    path = str(tmp_path / "swarm.pt")
    sw.save(path)
    saved = tdsa.state_to_numpy(sw.state)
    sw.step(10)
    after = tdsa.state_to_numpy(sw.state)
    sw.load(path)
    assert_same_fields(tdsa.state_to_numpy(sw.state), saved)
    # The generator's state came back too: the same ticks draw the same
    # jitter and land in the same state.
    sw.step(10)
    assert_same_fields(tdsa.state_to_numpy(sw.state), after)
    assert _checkpoint.load(path, device="cpu").tick.dtype == torch.int32
