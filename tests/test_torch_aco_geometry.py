"""The tour kernel's team geometry (B20, ``ops/cuda/aco_fused.py:
tour_geometry``, which the kernel's entry takes and checks) at its edges,
and ``fused_aco_run``'s CPU path, which stays an eager loop (the card
replays one captured iteration from a CUDA graph), against the JAX
package's fused run and against stepping ``fused_aco_step`` by hand.

The geometry is integer bookkeeping: exact.  The colony against JAX: the
tolerances of ``tests/test_torch_aco.py`` (tours and best length exact
with JAX's draws handed in, pheromone ``rtol = 1e-5``, the scatter-adds'
order); the run against its own steps: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu.ops import aco as ja
from distributed_swarm_algorithm_tpu.ops.pallas import aco_fused as jaf
from distributed_swarm_algorithm_tpu_torch.ops import aco as ta
from distributed_swarm_algorithm_tpu_torch.ops.cuda import aco_fused as taf


def instance(c, seed=0):
    """(JAX dist, JAX state) of C cities uniform in [0, 10)^2."""
    g = np.random.default_rng(seed)
    dist = ja.coords_to_dist(jnp.asarray(
        g.uniform(0, 10, (c, 2)).astype(np.float32)))
    return dist, ja.aco_init(dist, seed=0)


def to_port(js):
    return ta.aco_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in ta.ACO_TENSOR_FIELDS},
        device="cpu")


def jax_fused_draws(key, c, n_ants):
    """``fused_construct_tours(rng="host")``'s draws, as
    ``tests/test_torch_aco.py`` slices them from the padded operands:
    (start [A], u [C - 1, C, A], u_q [C - 1, A])."""
    cp, a_pad = -(-c // 128) * 128, -(-n_ants // 128) * 128
    _, k0, ku, kq = jax.random.split(key, 4)
    start = jax.random.randint(k0, (a_pad,), 0, c)[:n_ants]
    u = jax.random.uniform(ku, ((c - 1) * cp, a_pad), jnp.float32)
    uq = jax.random.uniform(kq, (c - 1, a_pad), jnp.float32)
    return (torch.from_numpy(np.array(start)).to(torch.int32),
            torch.from_numpy(np.array(u.reshape(c - 1, cp, a_pad)
                                      [:, :c, :n_ants])),
            torch.from_numpy(np.array(uq[:, :n_ants])))


def test_geometry_rejects_outside_the_envelope():
    for c in (0, -3, taf.MAX_CITIES + 1):
        with pytest.raises(ValueError, match="2048"):
            taf.tour_geometry(c)


@pytest.mark.parametrize("c,want", [
    (1, (32, 8, 1, 0)), (128, (32, 8, 1, 0)), (129, (64, 4, 1, 256)),
    (256, (64, 4, 1, 256)), (257, (128, 2, 1, 256)), (512, (128, 2, 1, 256)),
    (513, (128, 2, 2, 256)), (1024, (128, 2, 2, 256)),
    (1025, (128, 2, 4, 256)), (1536, (128, 2, 4, 256)),
    (2048, (128, 2, 4, 256)),
])
def test_geometry_at_its_edges(c, want):
    assert tuple(taf.tour_geometry(c)) == want


def test_geometry_covers_every_city_once():
    # What the kernel's entry checks (tour_geometry_ok), at every C: a team
    # of 1, 2 or 4 warps, whole teams a block, 1, 2 or 4 blocks of four
    # cities a lane (a 32-bit visited mask), a slot for every city, and
    # the warps' exchange in shared memory where a team spans warps.
    for c in range(1, taf.MAX_CITIES + 1):
        g = taf.tour_geometry(c)
        assert g.lanes in (32, 64, taf.MAX_TEAM_LANES)
        assert g.ants_per_block * g.lanes == taf.TOUR_THREADS
        assert g.blocks_per_lane in (1, 2, 4)
        assert 4 * g.lanes * g.blocks_per_lane >= c
        assert (g.shared > 0) == (g.lanes > 32)


def test_cpu_run_is_its_steps_and_counts_nothing():
    # On the CPU fused_aco_run loops over fused_aco_step (the plain
    # versions): the same state, the same last tours, no launch counted.
    dist = ta.coords_to_dist(torch.rand(
        (24, 2), generator=torch.Generator().manual_seed(2)) * 10.0)
    before = taf.TOURS_LAUNCHES, taf.DEPOSIT_LAUNCHES
    out_run, out_steps = {}, {}
    run = taf.fused_aco_run(ta.aco_init(dist, seed=3), 4, 32, q0=0.2,
                            elite=2.0, out=out_run)
    st = ta.aco_init(dist, seed=3)
    for _ in range(4):
        st = taf.fused_aco_step(st, 32, q0=0.2, elite=2.0, out=out_steps)
    for f in ta.ACO_TENSOR_FIELDS:
        assert torch.equal(getattr(run, f), getattr(st, f)), f
    for f in ("tours", "lengths"):
        assert torch.equal(out_run[f], out_steps[f]), f
    assert (taf.TOURS_LAUNCHES, taf.DEPOSIT_LAUNCHES) == before
    assert taf.fused_aco_run(st, 0, 32) is st
    with pytest.raises(ValueError, match="host"):
        taf.fused_aco_run(st, 1, 32, draws=[(None, None, None)])


@pytest.mark.parametrize("c,n_ants,q0,elite", [(12, 40, 0.0, 0.0),
                                               (21, 64, 0.5, 3.0)])
def test_cpu_run_matches_the_jax_fused_run(c, n_ants, q0, elite):
    # tests/test_torch_aco.py's JAX-reference case on other shapes and
    # rules: JAX's fused run in interpret mode with its host draws, and the
    # port's CPU run with the same draws handed in.
    dist, js = instance(c, seed=c)
    ts = to_port(js)
    key, draws = js.key, []
    for _ in range(3):
        key, kc = jax.random.split(key)
        draws.append(jax_fused_draws(kc, c, n_ants))
    want = jaf.fused_aco_run(js, 3, n_ants, rho=0.2, q0=q0, elite=elite,
                             rng="host", interpret=True, tile_a=64)
    out = {}
    got = taf.fused_aco_run(ts, 3, n_ants, rho=0.2, q0=q0, elite=elite,
                            rng="host", draws=draws, out=out)
    np.testing.assert_array_equal(got.best_tour.numpy(),
                                  np.asarray(want.best_tour))
    assert float(got.best_len) == float(want.best_len)
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(want.tau),
                               rtol=1e-5)
    assert int(got.iteration) == 3
    assert out["tours"].shape == (n_ants, c)
    assert torch.equal(out["lengths"],
                       taf.tour_lengths_in_order(ts.dist, out["tours"]))
