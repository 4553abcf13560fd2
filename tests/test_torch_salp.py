"""The port's salp swarm (``ops/salp.py``, kernel B9's plain version in
``ops/cuda/salp_fused.py``, the ``Salp`` model) against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step, the TPU kernel in interpret mode with
host-supplied uniforms (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_salp.py`` runs it) against the port's plain version,
and whole fused runs over several launches.  The chain runs across lanes
and tiles, so the cases hold one tile and several (``tile_n=128``, N up to
512): the cross-tile link, the leader at global lane 0 only, the best
recorded at every step.  A launch of k steps (which JAX draws on the TPU
only) is held to a numpy reference of the same semantics.

Tolerances, each with its reason:

- positions ``rtol = atol = 1e-5`` (the follower rule is exact halving;
  the leader's envelope goes through the same bit-field exponential);
  fitness ``2e-5``, the JAX package's own band for its objectives.
- the fast exponential: within two ulps (``rtol = 2.4e-7``) of the JAX
  package's, run in a Pallas kernel in interpret mode (XLA on the CPU
  contracts the Horner steps into fused multiply-adds; the port rounds
  each product and sum, as its kernel does); within 3.7e-7 relative of
  ``exp2``.
- the best lane is exact: the first of equal minima in lane order.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops import salp as jsalp
from distributed_swarm_algorithm_tpu.ops.pallas import firefly_fused as jff
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu.ops.pallas import salp_fused as jsf
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import salp as tsalp
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import salp_fused as tsf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = tsalp.SALP_TENSOR_FIELDS


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def assert_state_close(got, want, label):
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **TOL,
                               err_msg=f"{label} pos")
    np.testing.assert_allclose(got.fit.numpy(), np.asarray(want.fit),
                               **OBJ_TOL, err_msg=f"{label} fit")
    np.testing.assert_allclose(float(got.best_fit), float(want.best_fit),
                               **OBJ_TOL, err_msg=f"{label} best_fit")
    np.testing.assert_allclose(got.best_pos.numpy(),
                               np.asarray(want.best_pos), **TOL,
                               err_msg=f"{label} best_pos")
    assert int(got.iteration) == int(want.iteration)


# --------------------------------------------------------------------------
# The fast exponential
# --------------------------------------------------------------------------


def test_exp2_fast_matches_the_jax_packages():
    t = np.concatenate([np.linspace(-140.0, 20.0, 1017),
                        [-126.0, -125.5, -0.5, 0.5, 2.5, 3.5]]
                       ).astype(np.float32)[None, :]
    want = pl.pallas_call(
        lambda x_ref, o_ref: o_ref.__setitem__(
            slice(None), jff.exp2_fast(x_ref[:])),
        out_shape=jax.ShapeDtypeStruct(t.shape, jnp.float32),
        interpret=True)(jnp.asarray(t))
    got = tsf.exp2_fast(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.4e-7,
                               atol=0)
    ok = t[0] > -120.0
    np.testing.assert_allclose(got.numpy()[0, ok], np.exp2(t[0, ok]),
                               rtol=3.7e-7)
    assert float(got[0, 0]) == 0.0


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "griewank"])
def test_portable_step_matches_jax(name):
    n, d = 64, 5
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jsalp.salp_init(jfn, n, d, hw, seed=2)
    for _ in range(4):
        _, k2, k3 = jax.random.split(js.key, 3)
        c2 = np.asarray(jax.random.uniform(k2, (d,), jnp.float32))
        c3 = np.asarray(jax.random.uniform(k3, (d,), jnp.float32))
        ts = tsalp.salp_state_from_numpy(to_numpy(js), device="cpu")
        want = jsalp.salp_step(js, jfn, half_width=hw, t_max=40)
        got = tsalp.salp_step(ts, tfn, half_width=hw, t_max=40,
                              c2=tt(c2)[0], c3=tt(c3)[0])
        assert_state_close(got, want, name)
        js = want


def test_portable_run_chain_and_domain():
    fn, hw = tobj.get_objective("sphere")
    st = tsalp.salp_init(fn, 48, 3, 2.0, seed=2, device="cpu")
    nxt = tsalp.salp_step(st, fn, 2.0)
    # Followers average with their predecessor.
    want = torch.clamp(0.5 * (st.pos[1:] + st.pos[:-1]), -2.0, 2.0)
    assert torch.equal(nxt.pos[1:], want)
    out = tsalp.salp_run(st, fn, 50, half_width=2.0)
    assert bool((out.pos.abs() <= 2.0).all())
    assert float(out.best_fit) <= float(st.best_fit)


# --------------------------------------------------------------------------
# Kernel B9's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def chain_t(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    food = pos[:, int(np.argmin(fit[0]))][:, None].copy()
    r2 = rng.uniform(size=(d, n)).astype(np.float32)
    r3 = rng.uniform(size=(d, n)).astype(np.float32)
    return float(hw), food, pos, fit, r2, r3


def first_best_lane(fit_in, fit_out):
    """The first lane of the least ``min(input fit, output fit)``."""
    return int(np.argmin(np.minimum(fit_in, fit_out)[0]))


@pytest.mark.parametrize("name,n,tile_n,it0", [
    ("sphere", 256, 256, 0), ("rastrigin", 512, 128, 3),
    ("ackley", 384, 128, 60), ("levy", 256, 128, 200)])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             it0):
    d = 5
    hw, food, pos, fit, r2, r3 = chain_t(name, n, d, n + it0)
    want = jsf.fused_salp_step_t(
        jnp.asarray([0, it0]), *(jnp.asarray(a) for a in
                                 (food, pos, fit, r2, r3)),
        objective_name=name, half_width=hw, t_max=100, tile_n=tile_n,
        rng="host", interpret=True)
    got = tsf.fused_salp_step_t(
        torch.tensor([0, it0], dtype=torch.int32), *tt(food, pos, fit),
        *tt(r2[:, :1], r3[:, :1]), objective_name=name, half_width=hw,
        t_max=100, tile_n=tile_n, rng="host")
    assert [tuple(g.shape) for g in got] == [(d, n), (1, n), (1, 1), (d, 1)]
    for g, w, tol in zip(got, want, (TOL, OBJ_TOL, OBJ_TOL, TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    # The best lane: exact, the first of the least running bests.
    j = first_best_lane(fit, got[1].numpy())
    src = pos if fit[0, j] <= got[1].numpy()[0, j] else got[0].numpy()
    np.testing.assert_array_equal(got[3].numpy()[:, 0], src[:, j])


def test_best_is_the_first_of_equal_minima_across_tiles():
    n, d, tile_n = 512, 3, 128
    pos = np.full((d, n), 5.0, np.float32)
    pos[:, 130] = (1.0, 0.0, 0.0)          # tile 1
    pos[:, 300] = (0.0, 1.0, 0.0)          # tile 2, the same fitness
    fit = np.asarray(jobj.sphere(jnp.asarray(pos.T)))[None, :]
    food = np.full((d, 1), 5.0, np.float32)
    r = np.full((d, n), 0.7, np.float32)
    kw = dict(objective_name="sphere", half_width=5.12, t_max=10,
              tile_n=tile_n, rng="host")
    want = jsf.fused_salp_step_t(jnp.asarray([0, 1000]), jnp.asarray(food),
                                 jnp.asarray(pos), jnp.asarray(fit),
                                 jnp.asarray(r), jnp.asarray(r),
                                 interpret=True, **kw)
    got = tsf.fused_salp_step_t(torch.tensor([0, 1000], dtype=torch.int32),
                                *tt(food, pos, fit, r[:, :1], r[:, :1]), **kw)
    assert float(got[2]) == float(np.asarray(want[2])[0, 0]) == 1.0
    np.testing.assert_array_equal(got[3].numpy()[:, 0], (1.0, 0.0, 0.0))
    np.testing.assert_array_equal(np.asarray(want[3])[:, 0], (1.0, 0.0, 0.0))


def salp_block_oracle(seed, pos, fit, food, hw, t_max, tile_n, it0, k, step0,
                      objective):
    """A numpy reference of one k-step launch: the link is the previous
    tile's last lane at the launch's start, the leader at global lane 0,
    the running best from the input fit; the draws are the port's Philox
    ones."""
    d, n = pos.shape
    n_tiles = n // tile_n
    x0 = pos.reshape(d, n_tiles, tile_n)
    link = x0[:, (np.arange(n_tiles) - 1) % n_tiles, tile_n - 1]
    x, rb_fit, rb_pos = pos.copy(), fit.copy(), pos.copy()
    for s in range(k):
        t = np.float32(it0 + s + 1)
        c1 = 2.0 * np.exp(-(4.0 * t / t_max) ** 2)
        c2 = tpf.philox_uniforms(seed, 1, d, step0 + s, 0).numpy()
        c3 = tpf.philox_uniforms(seed, 1, d, step0 + s, 1).numpy()
        leader = food + np.where(c3 >= 0.5, 1.0, -1.0) * c1 * (
            2 * hw * c2 - hw)
        xt = x.reshape(d, n_tiles, tile_n)
        prev = np.concatenate([link[:, :, None], xt[:, :, :-1]], axis=2)
        x = (0.5 * (xt + prev)).reshape(d, n)
        x[:, :1] = leader
        x = np.clip(x, -hw, hw).astype(np.float32)
        f = objective(torch.from_numpy(x)).numpy()
        better = f < rb_fit
        rb_fit = np.where(better, f, rb_fit)
        rb_pos = np.where(better, x, rb_pos)
    j = int(np.argmin(rb_fit[0]))
    return x, f, rb_fit[0, j], rb_pos[:, j]


@pytest.mark.parametrize("n,tile_n,k", [(512, 128, 16), (256, 256, 5),
                                        (384, 128, 9)])
def test_device_rng_launch_matches_the_reference(n, tile_n, k):
    d, it0, t_max = 4, 5, 40
    hw, food, pos, fit, _, _ = chain_t("rastrigin", n, d, k)
    scalars = torch.tensor([77, it0], dtype=torch.int32)
    got = tsf.fused_salp_step_t(scalars, *tt(food, pos, fit),
                                objective_name="rastrigin", half_width=hw,
                                t_max=t_max, tile_n=tile_n, rng="device",
                                k_steps=k, step0=3)
    want = salp_block_oracle(scalars[:1], pos, fit, food, hw, t_max, tile_n,
                             it0, k, 3, tsf.OBJECTIVES_T["rastrigin"])
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **OBJ_TOL)
    np.testing.assert_allclose(float(got[2]), want[2], **OBJ_TOL)
    np.testing.assert_allclose(got[3].numpy()[:, 0], want[3], **TOL)


def test_step_rejects_bad_arguments():
    hw, food, pos, fit, r2, r3 = chain_t("sphere", 256, 2, 0)
    args = (torch.tensor([0, 0], dtype=torch.int32), *tt(food, pos, fit))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tsf.fused_salp_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        tsf.fused_salp_step_t(*args, objective_name="sphere", tile_n=100)
    before = tsf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsf.fused_salp_step_cuda(*args, **kw)
    assert tsf.LAUNCHES == before
    assert tsf.salp_pallas_supported("rastrigin", torch.float32, 452)
    assert not tsf.salp_pallas_supported("rastrigin", torch.float32, 453)
    assert tsf.kernel_block(30) == 512 and tsf.kernel_block(200) == 256
    # The JAX package's tile pick: 4,096 lanes at D = 30, capped by N.
    assert family.lane_tiling(1_048_576, None, 30) == (4096, 1_048_576)
    assert family.lane_tiling(500, 128, 5) == (128, 512)
    assert family.auto_tile(32) == jpf._auto_tile(32)
    assert family.auto_tile(240) == jpf._auto_tile(240)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_uniforms(key, calls, n_pad, d):
    """What JAX's ``fused_salp_run(rng="host")`` draws for each launch; the
    leader reads column 0."""
    host_key = jax.random.fold_in(key, 0x5A1)
    out = []
    for i in range(calls):
        r2, r3 = jpf.host_uniforms(host_key, i, (d, n_pad))
        out.append(tt(np.asarray(r2)[:, :1], np.asarray(r3)[:, :1]))
    return out


@pytest.mark.parametrize("name,n,tile_n", [("sphere", 500, 128),
                                           ("rastrigin", 300, None)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n):
    d, steps = 4, 5
    jfn, hw = jobj.get_objective(name)
    js = jsalp.salp_init(jfn, n, d, hw, seed=n)
    ts = tsalp.salp_state_from_numpy(to_numpy(js), device="cpu")
    _, n_pad = family.lane_tiling(n, tile_n, d)
    want = jsf.fused_salp_run(js, name, steps, half_width=hw, t_max=50,
                              tile_n=tile_n, rng="host", interpret=True)
    got = tsf.fused_salp_run(ts, name, steps, half_width=hw, t_max=50,
                             tile_n=tile_n, rng="host",
                             uniforms=jax_run_uniforms(js.key, steps, n_pad,
                                                       d))
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, name)


def test_fused_run_converges_monotone_and_caps_launches():
    fn, hw = tobj.get_objective("sphere")
    st = tsalp.salp_init(fn, 300, 4, hw, seed=3, device="cpu")
    prev = float(st.best_fit)
    s = st
    for _ in range(3):
        s = tsf.fused_salp_run(s, "sphere", 40, half_width=hw, t_max=120)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
    assert int(s.iteration) == 120 and s.pos.shape == (300, 4)
    assert bool((s.pos.abs() <= hw + 1e-5).all())
    assert float(s.best_fit) <= float(s.fit.min()) + 1e-6
    a = tsf.fused_salp_run(st, "sphere", 20, half_width=hw, t_max=20)
    b = tsf.fused_salp_run(st.replace(gen=torch.Generator().manual_seed(0)),
                           "sphere", 20, half_width=hw, t_max=20)
    assert a.pos.shape == b.pos.shape
    host = tsf.fused_salp_run(st, "sphere", 3, half_width=hw, rng="host")
    assert int(host.iteration) == 3


def test_model_backend_switch(monkeypatch):
    # On the card by default: without one the model raises unless the CPU
    # is asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.Salp("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.Salp("sphere", n=256, dim=4, seed=0, use_pallas=True,
                    device="cpu")
    opt.run(100)
    assert opt.best < 1.0 and int(opt.state.iteration) == 100
    with pytest.raises(ValueError):
        tdsa.Salp("sphere", n=64, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.Salp(tobj.sphere, n=256, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.Salp("sphere", n=256, dim=4, t_max=0, device="cpu")
    port = tdsa.Salp("sphere", n=64, dim=4, device="cpu")
    assert port.use_pallas is False and port.t_max == tsalp.T_MAX
    port.step()
    assert int(port.state.iteration) == 1
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda."
            "salp_fused as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
