"""The port's island model (portable and fused, kernel B6's plain version)
against the JAX package.

The same numpy inputs go through both packages on the CPU.  The JAX
package's TPU kernel runs in interpret mode with host-supplied uniforms
(``rng="host"``, ``interpret=True``), as in its own tests
(``tests/test_pallas_islands.py``).

Tolerances, each with its reason:

- migration (``migrate``, ``_migrate_t``) only moves values, chosen by
  stable sorts in the order of ``jax.lax.top_k`` (lowest index first among
  equals): indices and moved values exact.
- one island step (portable or fused) from the same state with the same
  draws: ``pos``/``vel`` within ``rtol = atol = 1e-5`` (XLA on the CPU
  fuses ``a + b * c``, PyTorch rounds twice); ``pbest`` likewise where both
  took the same ``fit < pbest_fit`` decision, which may differ only where
  ``|fit - pbest_fit|`` is inside the objective band (2e-5).
- whole runs: block by block from the same state with JAX's own host uniforms
  (``fold_in(key, 0x15AD)``) and the same ``tile_n``; ``iteration`` exact;
  long runs on outcomes only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import islands_fused as jif
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu.parallel import islands as jisl
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import pso as tpso
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    islands_fused as tif,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf
from distributed_swarm_algorithm_tpu_torch.parallel import islands as tisl

HW = 5.12
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
SEED = torch.tensor([77], dtype=torch.int32)


def to_torch(jstate):
    """A JAX IslandPSOState as the port's, through numpy."""
    arrays = {f: np.array(getattr(jstate.pso, f))
              for f in tpso.PSO_TENSOR_FIELDS}
    arrays["island_iteration"] = np.array(jstate.iteration)
    return tisl.island_state_from_numpy(arrays, device="cpu")


def assert_states_close(got, want, before, name="sphere"):
    """The step's bands (module docstring) on two island states."""
    g, w = got.pso, want.pso
    np.testing.assert_allclose(g.pos.numpy(), np.asarray(w.pos), **TOL)
    np.testing.assert_allclose(g.vel.numpy(), np.asarray(w.vel), **TOL)
    fn, _ = jobj.get_objective(name)
    fit = np.asarray(fn(w.pos))
    old = np.asarray(before.pso.pbest_fit)
    close = np.isclose(fit, old, **OBJ_TOL)
    took_g, took_w = g.pbest_fit.numpy() != old, np.asarray(w.pbest_fit) != old
    assert ((took_g == took_w) | close).all()
    same = took_g == took_w
    np.testing.assert_allclose(g.pbest_fit.numpy()[same],
                               np.asarray(w.pbest_fit)[same], **OBJ_TOL)
    np.testing.assert_allclose(g.pbest_pos.numpy()[same],
                               np.asarray(w.pbest_pos)[same], **TOL)
    if same.all():
        np.testing.assert_allclose(g.gbest_fit.numpy(),
                                   np.asarray(w.gbest_fit), **OBJ_TOL)
    return same.all()


def with_ties(jstate, seed):
    """The state with its pbest_fit drawn from a few values, so that the
    selections must break ties as JAX does."""
    rng = np.random.default_rng(seed)
    fit = rng.integers(0, 5, jstate.pso.pbest_fit.shape).astype(np.float32)
    return jstate.replace(pso=jstate.pso.replace(pbest_fit=jnp.asarray(fit)))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("n_i,n,d,k", [(4, 256, 3, 5), (3, 200, 2, 4),
                                       (2, 16, 1, 1), (5, 33, 4, 8)])
def test_migrate_matches_jax(n_i, n, d, k, ties):
    js = jisl.island_init(jobj.sphere, n_islands=n_i, n_per_island=n, dim=d,
                          half_width=HW, seed=2)
    if ties:
        js = with_ties(js, n)
    want = jisl.migrate(js, k).pso
    got = tisl.migrate(to_torch(js), k).pso
    for f in ("pos", "vel", "pbest_pos", "pbest_fit", "gbest_pos",
              "gbest_fit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_selection_order_matches_top_k(ties):
    rng = np.random.default_rng(3)
    fit = (rng.integers(0, 4, (6, 40)) if ties
           else rng.normal(size=(6, 40))).astype(np.float32)
    _, best = jax.lax.top_k(-jnp.asarray(fit), 7)
    _, worst = jax.lax.top_k(jnp.asarray(fit), 7)
    t = torch.from_numpy(fit)
    np.testing.assert_array_equal(tisl.smallest_k(t, 7).numpy(),
                                  np.asarray(best))
    np.testing.assert_array_equal(tisl.largest_k(t, 7).numpy(),
                                  np.asarray(worst))


def _flat(x, n_i, n_l, d, reps):
    """[I, n, d] -> [d, I*n_l], each island padded cyclically."""
    xp = np.tile(x, (1, reps, 1))[:, :n_l]
    return np.ascontiguousarray(xp.reshape(n_i * n_l, d).T)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("n_i,n,n_l,d,k", [(3, 200, 256, 2, 4),
                                           (4, 256, 256, 3, 5),
                                           (2, 50, 128, 3, 3)])
def test_migrate_t_matches_jax_and_portable(n_i, n, n_l, d, k, ties):
    # Padded lanes must be invisible to migration: the real lanes transform
    # exactly as the portable path transforms the unpadded state, and as
    # JAX's transposed migration does.
    js = jisl.island_init(jobj.sphere, n_islands=n_i, n_per_island=n, dim=d,
                          half_width=HW, seed=7)
    if ties:
        js = with_ties(js, n_l)
    pso = js.pso
    reps = -(-n_l // n)
    flats = [_flat(np.asarray(x), n_i, n_l, d, reps)
             for x in (pso.pos, pso.vel, pso.pbest_pos)]
    bfit = np.tile(np.asarray(pso.pbest_fit), (1, reps))[:, :n_l].reshape(
        1, n_i * n_l)
    want_t = jif._migrate_t(*(jnp.asarray(a) for a in (*flats, bfit)), k,
                            n_i, n_l, n_real=n)
    got_t = tif._migrate_t(*(torch.from_numpy(a) for a in (*flats, bfit)), k,
                           n_i, n_l, n_real=n)
    for g, w in zip(got_t, want_t):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The inputs are left as they were.
    assert np.array_equal(bfit, np.tile(np.asarray(pso.pbest_fit),
                                        (1, reps))[:, :n_l].reshape(1, -1))
    want = tisl.migrate(to_torch(js), k).pso
    back = lambda x_t: x_t.T.reshape(n_i, n_l, d)[:, :n]   # noqa: E731
    assert torch.equal(back(got_t[0]), want.pos)
    assert torch.equal(back(got_t[1]), want.vel)
    assert torch.equal(back(got_t[2]), want.pbest_pos)
    assert torch.equal(got_t[3].reshape(n_i, n_l)[:, :n], want.pbest_fit)
    # gbest refresh (a separate helper here, part of migrate() there).
    gpos_ti, gfit_i = tif._island_gbest_update(
        got_t[3], got_t[2], torch.from_numpy(np.array(pso.gbest_pos).T),
        torch.from_numpy(np.array(pso.gbest_fit)), n_i, n_l)
    wpos, wfit = jif._island_gbest_update(
        want_t[3], want_t[2], pso.gbest_pos.T, pso.gbest_fit, n_i, n_l)
    np.testing.assert_array_equal(gfit_i.numpy(), np.asarray(wfit))
    np.testing.assert_array_equal(gpos_ti.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(gfit_i.numpy(), want.gbest_fit.numpy())


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "levy"])
@pytest.mark.parametrize("n_i,n_l", [(3, 128), (2, 256)])
def test_plain_island_step_matches_the_tpu_kernel_in_interpret_mode(
        name, n_i, n_l):
    d, tile_n = 6, 128
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(n_i)
    n = n_i * n_l
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    vel = (0.1 * rng.uniform(-hw, hw, (d, n))).astype(np.float32)
    bpos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    bfit = np.array(fn(jnp.asarray(bpos.T)))[None, :]
    best = bfit.reshape(n_i, n_l).argmin(1) + np.arange(n_i) * n_l
    gbest = np.ascontiguousarray(bpos[:, best])             # [D, I]
    r1 = rng.uniform(size=(d, n)).astype(np.float32)
    r2 = rng.uniform(size=(d, n)).astype(np.float32)
    want = jif._islands_step_t(
        jnp.asarray(0), *(jnp.asarray(a) for a in
                          (gbest, pos, vel, bpos, bfit, r1, r2)),
        objective_name=name, w=tpso.W, c1=tpso.C1, c2=tpso.C2,
        half_width=hw, vmax_frac=0.5, tile_n=tile_n,
        tiles_per_island=n_l // tile_n, rng="host", interpret=True,
        k_steps=1)
    got = tif._islands_step_t(
        SEED, *(torch.from_numpy(a) for a in
                (gbest, pos, vel, bpos, bfit, r1, r2)),
        objective_name=name, half_width=float(hw), lanes_per_island=n_l,
        rng="host")
    g, w = [x.numpy() for x in got], [np.asarray(x) for x in want]
    np.testing.assert_allclose(g[0], w[0], **TOL)
    np.testing.assert_allclose(g[1], w[1], **TOL)
    fit = np.asarray(fn(jnp.asarray(w[0].T)))[None, :]
    close = np.isclose(fit, bfit, **OBJ_TOL)
    took_g, took_w = g[3] != bfit, w[3] != bfit
    assert ((took_g == took_w) | close).all()
    same = (took_g == took_w)[0]
    np.testing.assert_allclose(g[3][:, same], w[3][:, same], **OBJ_TOL)
    np.testing.assert_allclose(g[2][:, same], w[2][:, same], **TOL)
    # The islands do follow different attractors.
    shared = tif._islands_step_t(
        SEED, torch.from_numpy(gbest[:, :1].repeat(n_i, 1)),
        *(torch.from_numpy(a) for a in (pos, vel, bpos, bfit, r1, r2)),
        objective_name=name, half_width=float(hw), lanes_per_island=n_l,
        rng="host")
    assert not torch.equal(shared[0], got[0])


def test_island_device_rng_block_equals_single_steps():
    n_i, n_l, d, k = 3, 50, 4, 4
    rng = np.random.default_rng(0)
    arrs = [torch.from_numpy(rng.uniform(-HW, HW, (d, n_i * n_l))
                             .astype(np.float32)) for _ in range(3)]
    bfit = tpf.OBJECTIVES_T["sphere"](arrs[2])
    gbest = arrs[2][:, [3, 60, 140]].contiguous()
    kw = dict(objective_name="sphere", lanes_per_island=n_l)
    block = tif._islands_step_t(SEED, gbest, *arrs, bfit, k_steps=k,
                                step0=8, **kw)
    state = (*arrs, bfit)
    for s in range(k):
        r1 = tpf.philox_uniforms(SEED, n_i * n_l, d, 8 + s, 0)
        r2 = tpf.philox_uniforms(SEED, n_i * n_l, d, 8 + s, 1)
        state = tif._islands_step_t(SEED, gbest, *state, r1, r2, rng="host",
                                    **kw)
    for a, b in zip(block, state):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tif.islands_step_cuda(SEED, gbest, *arrs, bfit, **kw)


def jax_island_draws(keys, shape):
    """(next keys, r1, r2), each island drawing as ``pso_step`` does."""
    def one(key):
        key, k1, k2 = jax.random.split(key, 3)
        return (key, jax.random.uniform(k1, shape, jnp.float32),
                jax.random.uniform(k2, shape, jnp.float32))
    keys, r1, r2 = jax.vmap(one)(keys)
    return keys, np.array(r1), np.array(r2)


def test_island_run_matches_jax_step_by_step():
    n_i, n, d = 3, 40, 4
    js = jisl.island_init(jobj.sphere, n_islands=n_i, n_per_island=n, dim=d,
                          half_width=HW, seed=4)
    # From the same state at every step; the cadence (every 3rd iteration
    # migrates) is the state's own counter.
    for step in range(7):
        _, r1, r2 = jax_island_draws(js.pso.key, (n, d))
        want = jisl.island_run(js, jobj.sphere, 1, migrate_every=3,
                               migrate_k=2, half_width=HW)
        got = tisl.island_run(
            to_torch(js), tobj.sphere, 1, migrate_every=3, migrate_k=2,
            half_width=HW, uniforms=(torch.from_numpy(r1[None]),
                                     torch.from_numpy(r2[None])))
        assert int(got.iteration) == int(want.iteration) == step + 1
        np.testing.assert_array_equal(got.pso.iteration.numpy(),
                                      np.asarray(want.pso.iteration))
        assert_states_close(got, want, js)
        # A migration zeroes the same velocities in both.
        np.testing.assert_array_equal(
            (got.pso.vel.numpy() == 0).all(-1),
            (np.asarray(want.pso.vel) == 0).all(-1))
        js = want


def test_island_run_free_running_outcomes():
    st = tisl.island_init(tobj.sphere, 4, 64, 5, HW, seed=0, device="cpu")
    assert st.pso.pos.shape == (4, 64, 5) and st.n_islands == 4
    assert st.pso.iteration.shape == (4,)
    out = tisl.island_run(st, tobj.sphere, 60, migrate_every=10, migrate_k=3,
                          half_width=HW)
    fit, pos = tisl.global_best(out)
    assert int(out.iteration) == 60 and float(fit) < 1e-2
    assert pos.shape == (5,)
    assert float(fit) == float(out.pso.gbest_fit.min())
    assert bool((out.pso.gbest_fit <= st.pso.gbest_fit).all())
    assert bool((out.pso.pos.abs() <= HW + 1e-5).all())


def jax_island_host_uniforms(keys, call_i, shape):
    host_key = jax.random.fold_in(keys[0], 0x15AD)
    r1, r2 = jpf.host_uniforms(host_key, call_i, shape)
    return np.array(r1), np.array(r2)


@pytest.mark.parametrize("n,n_l", [(200, 256), (128, 128)])
def test_fused_island_run_matches_jax_block_by_block(n, n_l):
    n_i, d, tile_n = 3, 5, 128
    js = jisl.island_init(jobj.sphere, n_islands=n_i, n_per_island=n, dim=d,
                          half_width=HW, seed=n)
    # migrate_every=2 with one step per launch: every second block
    # migrates, counted from the start of each call, so run two steps.
    for _ in range(3):
        draws = [jax_island_host_uniforms(js.pso.key, i, (d, n_i * n_l))
                 for i in range(2)]
        want = jif.fused_island_run(
            js, "sphere", 2, migrate_every=2, migrate_k=3, half_width=HW,
            tile_n=tile_n, rng="host", interpret=True)
        got = tif.fused_island_run(
            to_torch(js), "sphere", 2, migrate_every=2, migrate_k=3,
            half_width=HW, tile_n=tile_n, rng="host",
            uniforms=(torch.from_numpy(np.stack([r[0] for r in draws])),
                      torch.from_numpy(np.stack([r[1] for r in draws]))))
        assert int(got.iteration) == int(want.iteration)
        np.testing.assert_array_equal(got.pso.iteration.numpy(),
                                      np.asarray(want.pso.iteration))
        assert got.pso.pos.shape == (n_i, n, d)
        # Two steps and a migration of sphere values: a loose band on the
        # floats, the migrated (zero-velocity) particles exact.
        np.testing.assert_allclose(got.pso.pos.numpy(),
                                   np.asarray(want.pso.pos), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(
            (got.pso.vel.numpy() == 0).all(-1),
            (np.asarray(want.pso.vel) == 0).all(-1))
        np.testing.assert_allclose(got.pso.gbest_fit.numpy(),
                                   np.asarray(want.pso.gbest_fit), rtol=1e-4,
                                   atol=1e-5)
        js = want


@pytest.mark.parametrize("tile_n", [None, 128], ids=["no_pad", "tile_128"])
def test_fused_islands_converge_with_padding(tile_n):
    # n=200 pads to 256 lanes per island under tile_n=128.
    st = tisl.island_init(tobj.sphere, 4, 200, 5, HW, seed=0, device="cpu")
    out = tif.fused_island_run(st, "sphere", 60, migrate_every=10,
                               migrate_k=3, half_width=HW, tile_n=tile_n)
    assert out.pso.pos.shape == (4, 200, 5) and out.pso.pos.is_contiguous()
    assert int(out.iteration) == 60
    fit, _ = tisl.global_best(out)
    assert float(fit) < 1e-4
    # Per-island gbest is the min over a superset of that island's pbest.
    assert bool((out.pso.gbest_fit
                 <= out.pso.pbest_fit.min(1).values + 1e-6).all())
    assert bool((out.pso.gbest_fit <= st.pso.gbest_fit).all())


def test_fused_islands_iteration_and_domain():
    st = tisl.island_init(tobj.sphere, 2, 128, 4, HW, seed=1, device="cpu")
    out = tif.fused_island_run(st, "sphere", 17, migrate_every=5,
                               migrate_k=2, half_width=HW, rng="host")
    assert int(out.pso.iteration[0]) == 17 and int(out.iteration) == 17
    assert bool((out.pso.pos.abs() <= HW + 1e-5).all())


def test_fused_islands_migration_cadence():
    # With migrate_k = n every particle of island i+1 is replaced by island
    # i's pbest with zero velocity, which shows in the velocities: blocks of
    # 4 steps, migrate_every=8, so a migration closes blocks 2 and 4 only.
    st = tisl.island_init(tobj.sphere, 3, 8, 2, HW, seed=5, device="cpu")
    kw = dict(migrate_every=8, migrate_k=8, half_width=HW, steps_per_kernel=4)
    zero_vel = lambda s: bool((s.pso.vel == 0).all())       # noqa: E731
    assert not zero_vel(tif.fused_island_run(st, "sphere", 4, **kw))
    assert zero_vel(tif.fused_island_run(st, "sphere", 8, **kw))
    assert not zero_vel(tif.fused_island_run(st, "sphere", 12, **kw))
    assert zero_vel(tif.fused_island_run(st, "sphere", 16, **kw))


def test_island_envelope_and_converters():
    assert tif.islands_pallas_supported is tpf.pallas_supported
    st = tisl.island_init(tobj.sphere, 2, 8, 606, HW, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tif.fused_island_run(st, "sphere", 1)
    small = tisl.island_init(tobj.sphere, 2, 8, 3, HW, seed=9, device="cpu")
    arrays = tisl.island_state_to_numpy(small)
    back = tisl.island_state_from_numpy(arrays, device="cpu")
    for f in tpso.PSO_TENSOR_FIELDS:
        assert torch.equal(getattr(back.pso, f), getattr(small.pso, f)), f
    assert int(back.iteration) == 0
