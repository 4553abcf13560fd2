"""Coordination and greedy allocation of the port against the JAX package,
tick by tick.

Both start from the same state, converted through numpy, and step the
same 200-tick sequence: the election jitter is the JAX key chain's own
draw, handed to the port, and the agents drift by the same numpy steps so
that the utilities change.  The leader is killed at tick 60 (an election
takes 30+ ticks: the timeout, then the jittered wait) and revived at tick
130.  Discrete state must match exactly at every tick; ``leader_pos`` and
``task_util`` within 1e-6 (both are copies or one division of the same
f32 inputs, so they agree to the last bit or close to it).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
from distributed_swarm_algorithm_tpu.ops.allocation import (
    agent_task_view as jax_agent_task_view,
)
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu_torch.ops import allocation as talloc
from distributed_swarm_algorithm_tpu_torch.ops import coordination as tcoord

N, STEPS, KILL_AT, REVIVE_AT = 48, 200, 60, 130
EXACT = ("fsm", "leader_id", "last_hb_tick", "wait_until", "leader_live",
         "has_leader_pos", "alive", "alive_below", "task_winner",
         "task_claimed", "tick")
CLOSE = ("leader_pos", "task_util")


def jax_to_numpy(s):
    return {
        f.name: np.asarray(getattr(s, f.name))
        for f in dataclasses.fields(s)
        if f.name != "key"
    }


def jax_jitter(key, cfg):
    """The draw coordination_step makes from ``key``, and the next key."""
    key, sub = jax.random.split(key)
    return key, jax.random.randint(
        sub, (N,), 0, cfg.election_jitter_ticks + 1
    )


@partial(jax.jit, static_argnums=1)
def jax_protocol(s, cfg):
    s = s.replace(tick=s.tick + 1)
    s = jdsa.coordination_step(s, cfg)
    return jdsa.allocation_step(s, cfg)


def _start():
    rng = np.random.default_rng(7)
    js = jdsa.make_swarm(N, n_tasks=3, n_caps=2, seed=0)
    js = js.replace(
        pos=jnp.asarray(rng.uniform(-5, 5, (N, 2)).astype(np.float32)),
        caps=jnp.asarray(rng.random((N, 2)) > 0.5),
    )
    js = jdsa.with_tasks(
        js,
        jnp.asarray([[1.0, 1.0], [-2.0, 3.0], [4.0, -3.0]]),
        jnp.asarray([-1, 0, 1], jnp.int32),
    )
    return js, tdsa.state_from_numpy(jax_to_numpy(js), device="cpu"), rng


@pytest.mark.parametrize("lock_on_award", [True, False])
def test_protocol_sequence_matches_jax(lock_on_award):
    cfg = jdsa.DEFAULT_CONFIG.replace(allocation_lock_on_award=lock_on_award)
    tcfg = tdsa.DEFAULT_CONFIG.replace(allocation_lock_on_award=lock_on_award)
    js, ts, rng = _start()
    leaders, winners = set(), set()
    for t in range(1, STEPS + 1):
        if t == KILL_AT:
            js, ts = jdsa.kill(js, [N - 1]), tdsa.kill(ts, [N - 1])
        if t == REVIVE_AT:
            js, ts = jdsa.revive(js, [N - 1]), tdsa.revive(ts, [N - 1])
        drift = rng.normal(0.0, 0.3, (N, 2)).astype(np.float32)
        pos = np.asarray(js.pos) + drift
        js = js.replace(pos=jnp.asarray(pos))
        ts = ts.replace(pos=torch.from_numpy(pos.copy()))

        _, jitter = jax_jitter(js.key, cfg)
        js = jax_protocol(js, cfg)
        ts = ts.replace(tick=ts.tick + 1)
        ts = tdsa.coordination_step(
            ts, tcfg, jitter=torch.from_numpy(np.array(jitter))
        )
        ts = tdsa.allocation_step(ts, tcfg)

        want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
        for f in EXACT:
            assert got[f].dtype == want[f].dtype, (t, f)
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{t} {f}")
        for f in CLOSE:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{t} {f}")
        leaders.add(int(tdsa.current_leader(ts)[0]))
        winners.update(int(w) for w in got["task_winner"])
    # The sequence did what it is meant to exercise.
    assert {N - 1, N - 2} <= leaders
    assert len(winners - {-1}) >= 2
    np.testing.assert_array_equal(
        talloc.agent_task_view(ts).numpy(),
        np.asarray(jax_agent_task_view(js)),
    )
    np.testing.assert_array_equal(
        tdsa.task_status_view(ts).numpy(),
        np.asarray(jdsa.task_status_view(js)),
    )


def test_jitter_draws_follow_the_state_key():
    # The JAX key chain that the sequence above hands to the port is the
    # one coordination_step draws from: after a tick, state.key is the
    # split's first half.
    cfg = jdsa.DEFAULT_CONFIG
    js, _, _ = _start()
    key = js.key
    for _ in range(3):
        key, _ = jax_jitter(key, cfg)
        js = jax_protocol(js, cfg)
        np.testing.assert_array_equal(np.asarray(js.key), np.asarray(key))


def test_port_draws_its_own_jitter_in_range():
    s = tdsa.make_swarm(500, device="cpu", seed=3)
    j = tcoord.draw_jitter(s, tdsa.DEFAULT_CONFIG)
    assert j.dtype == torch.int32
    assert int(j.min()) == 0
    assert int(j.max()) == tdsa.DEFAULT_CONFIG.election_jitter_ticks


def test_auction_mode_raises_with_its_roadmap_item():
    # ROADMAP Queue A item 10 is ported: nothing raises in auction mode.
    # allocation_step is the greedy arbiter whatever the mode (as in JAX);
    # the tick dispatches to the auction (tests/test_torch_auction.py).
    s = tdsa.with_tasks(tdsa.make_swarm(4, device="cpu"), [[0.0, 0.0]])
    s = s.replace(fsm=torch.full_like(s.fsm, tdsa.LEADER))
    auction = tdsa.DEFAULT_CONFIG.replace(allocation_mode="auction")
    greedy = tdsa.allocation_step(s, tdsa.DEFAULT_CONFIG)
    same = tdsa.allocation_step(s, auction)
    assert torch.equal(same.task_winner, greedy.task_winner)
    out = tdsa.swarm_tick(s, None, auction)
    assert out.task_winner.shape == (1,)
