"""The port's bat algorithm (``ops/bat.py``, kernel B7's plain version in
``ops/cuda/bat_fused.py``, the ``Bat`` model) against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step, the TPU kernel in interpret mode with
host-supplied uniforms (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_bat.py`` runs it) against the port's plain version, and
whole fused runs over several launches.

Tolerances, each with its reason:

- positions, velocities: ``rtol = atol = 1e-5``; fitness ``2e-5``, the JAX
  package's own band for its transposed objectives (the port sums over
  ``d`` row by row and never fuses a multiply-add; XLA does both
  differently, by a few ulps).
- loudness: exact (a product by alpha where accepted).  Pulse: ``1e-6``
  (``exp`` of the CPU's two libraries may differ in the last bit).
- the acceptance mask is exact, except where the candidate's fitness lies
  inside the fitness band of the bat's own (a decision XLA's rounding could
  take the other way); the tests count those lanes and hold them to a
  handful.
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

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.models.bat import Bat as JBat
from distributed_swarm_algorithm_tpu.ops import bat as jbat
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import bat_fused as jbf
from distributed_swarm_algorithm_tpu_torch.ops import bat as tbat
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import bat_fused as tbf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = tbat.BAT_TENSOR_FIELDS


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def colony_t(name, n, d, seed):
    """A transposed colony a few generations in, and one step's draws."""
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    vel = rng.uniform(-1, 1, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    loud = rng.uniform(0.4, 1.0, (1, n)).astype(np.float32)
    pulse = rng.uniform(0.0, 0.6, (1, n)).astype(np.float32)
    best = pos[:, np.argmin(fit[0])][:, None].copy()
    mean_a = np.float32(loud.mean())
    draws = [rng.uniform(size=s).astype(np.float32)
             for s in ((1, n), (1, n), (d, n), (1, n))]
    return float(hw), best, mean_a, pos, vel, fit, loud, pulse, draws


def assert_colony_close(got, want, loud_before, cfit, fit_before, label):
    """The module docstring's bands on (pos, vel, fit, loud, pulse); returns
    the acceptance mask."""
    g = [np.asarray(x) for x in got]
    w = [np.asarray(x) for x in want]
    acc_g, acc_w = g[3] != loud_before, w[3] != loud_before
    near = np.isclose(cfit, fit_before, **OBJ_TOL)
    assert ((acc_g == acc_w) | near).all(), label
    assert int((acc_g != acc_w).sum()) <= 2, label
    same = (acc_g == acc_w)[0]
    for i, name, tol in ((0, "pos", TOL), (1, "vel", TOL), (2, "fit",
                                                           OBJ_TOL)):
        np.testing.assert_allclose(g[i][:, same], w[i][:, same], **tol,
                                   err_msg=f"{label} {name}")
    np.testing.assert_array_equal(g[3][:, same], w[3][:, same])
    np.testing.assert_allclose(g[4][:, same], w[4][:, same], rtol=0,
                               atol=1e-6, err_msg=f"{label} pulse")
    return acc_w


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_step_draws(jstate):
    """The draws ``ops/bat.py:bat_step`` makes from the state's key."""
    n, d = jstate.pos.shape
    _, kb, k1, ke, k2 = jax.random.split(jstate.key, 5)
    return (np.asarray(jax.random.uniform(kb, (n, 1), jnp.float32)),
            np.asarray(jax.random.uniform(k1, (n,), jnp.float32)),
            np.asarray(jax.random.uniform(ke, (n, d), jnp.float32,
                                          minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.uniform(k2, (n,), jnp.float32)))


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "rosenbrock"])
def test_portable_step_matches_jax(name):
    n, d = 96, 5
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jbat.bat_init(jfn, n, d, hw, seed=3)
    for _ in range(4):
        draws = jax_step_draws(js)
        ts = tbat.bat_state_from_numpy(to_numpy(js), device="cpu")
        want = jbat.bat_step(js, jfn, half_width=hw)
        got = tbat.bat_step(ts, tfn, half_width=hw, draws=tt(*draws))
        assert int(got.iteration) == int(want.iteration)
        beta, u_walk, eps, _ = draws
        pos, best = np.asarray(js.pos), np.asarray(js.best_pos)
        cand = np.where(
            (u_walk > np.asarray(js.pulse))[:, None],
            best + 0.1 * hw * float(np.mean(js.loudness)) * eps,
            pos + np.asarray(js.vel) + (pos - best) * (2.0 * beta))
        cand_fit = np.asarray(jfn(jnp.asarray(np.clip(cand, -hw, hw))))
        acc = assert_colony_close(
            [getattr(got, f).numpy().T if f in ("pos", "vel")
             else getattr(got, f).numpy()[None] for f in
             ("pos", "vel", "fit", "loudness", "pulse")],
            [np.asarray(getattr(want, f)).T if f in ("pos", "vel")
             else np.asarray(getattr(want, f))[None] for f in
             ("pos", "vel", "fit", "loudness", "pulse")],
            np.asarray(js.loudness)[None], cand_fit[None],
            np.asarray(js.fit)[None], name)
        np.testing.assert_allclose(float(got.best_fit), float(want.best_fit),
                                   **OBJ_TOL)
        np.testing.assert_allclose(got.best_pos.numpy(),
                                   np.asarray(want.best_pos), **TOL)
        js = want
    assert acc.any()


def test_portable_run_converges_and_adapts():
    fn, hw = tobj.get_objective("sphere")
    st = tbat.bat_init(fn, 256, 4, hw, seed=0, device="cpu")
    out = tbat.bat_run(st, fn, 60, half_width=hw)
    assert float(out.best_fit) < float(st.best_fit)
    assert int(out.iteration) == 60
    assert float(out.loudness.min()) < 1.0 and float(out.pulse.max()) > 0.0
    assert bool((out.pos.abs() <= hw + 1e-6).all())


# --------------------------------------------------------------------------
# Kernel B7's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "ackley",
                                  "griewank", "michalewicz"])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name):
    n, d = 256, 6
    hw, best, mean_a, pos, vel, fit, loud, pulse, draws = colony_t(
        name, n, d, 0)
    want = jbf.fused_bat_step_t(
        jnp.asarray([0, 7]), jnp.asarray(best), jnp.asarray(mean_a),
        *(jnp.asarray(a) for a in (pos, vel, fit, loud, pulse, *draws)),
        objective_name=name, half_width=hw, tile_n=128, rng="host",
        interpret=True)
    got = tbf.fused_bat_step_t(
        torch.tensor([0, 7], dtype=torch.int32), *tt(best),
        torch.tensor([mean_a]), *tt(pos, vel, fit, loud, pulse, *draws),
        objective_name=name, half_width=hw, rng="host")
    assert len(got) == 5 and got[0].shape == (d, n)
    # The candidate's fitness decides; recompute it from JAX's inputs.
    walk = draws[1] > pulse
    cand = np.where(walk, best + 0.1 * hw * mean_a * (2 * draws[2] - 1),
                    pos + vel + (pos - best) * (2.0 * draws[0]))
    fn, _ = jobj.get_objective(name)
    cfit = np.asarray(fn(jnp.asarray(np.clip(cand, -hw, hw).T)))[None]
    acc = assert_colony_close(got, want, loud, cfit, fit, name)
    assert acc.any() and not acc.all()
    # Accepted bats' pulse is r0 (1 - exp(-gamma (t0 + 1))).
    want_pulse = 0.5 * (1.0 - np.exp(-0.9 * 8.0))
    np.testing.assert_allclose(got[4].numpy()[acc], want_pulse, atol=1e-6)


def test_device_rng_block_equals_single_steps_with_its_uniforms():
    n, d, k = 130, 6, 5
    hw, best, mean_a, pos, vel, fit, loud, pulse, _ = colony_t(
        "rastrigin", n, d, 4)
    scalars = torch.tensor([99, 3], dtype=torch.int32)
    args = tt(best) + (torch.tensor([mean_a]),)
    state = tt(pos, vel, fit, loud, pulse)
    kw = dict(objective_name="rastrigin", half_width=hw)
    block = tbf.fused_bat_step_t(scalars, *args, *state, rng="device",
                                 k_steps=k, step0=11, **kw)
    for s in range(k):
        rows = tpf.philox_uniforms(scalars[:1], n, 4, 11 + s, 1)
        eps = tpf.philox_uniforms(scalars[:1], n, d, 11 + s, 0)
        state = tbf.fused_bat_step_t(
            torch.tensor([99, 3 + s], dtype=torch.int32), *args, *state,
            rows[0:1], rows[1:2], eps, rows[2:3], rng="host", **kw)
    for a, b in zip(block, state):
        assert torch.equal(a, b)
    other = tbf.fused_bat_step_t(scalars, *args, *tt(pos, vel, fit, loud,
                                                     pulse),
                                 rng="device", k_steps=k, step0=12, **kw)
    assert not torch.equal(other[0], block[0])
    assert float(block[0].abs().max()) <= np.float32(hw)
    assert bool((block[2] <= tt(fit)[0]).all())


def test_step_rejects_bad_arguments():
    hw, best, mean_a, pos, vel, fit, loud, pulse, draws = colony_t(
        "sphere", 16, 2, 0)
    args = (torch.tensor([0, 0], dtype=torch.int32), *tt(best),
            torch.tensor([mean_a]), *tt(pos, vel, fit, loud, pulse))
    with pytest.raises(ValueError, match="every draw"):
        tbf.fused_bat_step_t(*args, objective_name="sphere", rng="host")
    with pytest.raises(ValueError, match="k_steps=1 only"):
        tbf.fused_bat_step_t(*args, *tt(*draws), objective_name="sphere",
                             rng="host", k_steps=2)
    with pytest.raises(ValueError, match="rng must be"):
        tbf.fused_bat_step_t(*args, objective_name="sphere", rng="tpu")
    with pytest.raises(TypeError, match="unexpected"):
        tbf.fused_bat_step_t(*args, objective_name="sphere", beta=1.0)
    before = tbf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbf.fused_bat_step_cuda(*args, objective_name="sphere")
    assert tbf.LAUNCHES == before


def test_supported_matrix_and_envelope():
    assert tbf.bat_pallas_supported("rastrigin", torch.float32)
    assert not tbf.bat_pallas_supported("rastrigin", torch.bfloat16)
    assert not tbf.bat_pallas_supported("nope", torch.float32)
    assert tbf.bat_pallas_supported("rastrigin", torch.float32, 605)
    assert not tbf.bat_pallas_supported("rastrigin", torch.float32, 606)
    assert not tbf.bat_pallas_supported("michalewicz", torch.float32, 101)
    assert tbf.kernel_block(30) == 128 and tbf.kernel_block(152) == 64
    fn, hw = tobj.get_objective("sphere")
    st = tbat.bat_init(fn, 8, 606, hw, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tbf.fused_bat_run(st, "sphere", 1)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_uniforms(key, calls, n_pad, d):
    """What JAX's ``fused_bat_run(rng="host")`` draws for each launch."""
    host_key = jax.random.fold_in(key, 0xBA7)
    return [tt(*jbf.bat_host_uniforms(host_key, i, (1, n_pad), (d, n_pad)))
            for i in range(calls)]


@pytest.mark.parametrize("name,n", [("sphere", 200), ("rastrigin", 256)])
def test_fused_run_matches_jax_over_several_launches(name, n):
    d, steps, tile_n = 4, 4, 128
    jfn, hw = jobj.get_objective(name)
    js = jbat.bat_init(jfn, n, d, hw, seed=n)
    ts = tbat.bat_state_from_numpy(to_numpy(js), device="cpu")
    want = jbf.fused_bat_run(js, name, steps, half_width=hw, tile_n=tile_n,
                             rng="host", interpret=True)
    got = tbf.fused_bat_run(ts, name, steps, half_width=hw, tile_n=tile_n,
                            rng="host",
                            uniforms=jax_run_uniforms(js.key, steps, 256, d))
    assert int(got.iteration) == int(want.iteration) == steps
    assert got.pos.shape == (n, d)
    np.testing.assert_array_equal(got.loudness.numpy(),
                                  np.asarray(want.loudness))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **TOL)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), **TOL)
    np.testing.assert_allclose(got.fit.numpy(), np.asarray(want.fit),
                               **OBJ_TOL)
    np.testing.assert_allclose(got.pulse.numpy(), np.asarray(want.pulse),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.best_fit), float(want.best_fit),
                               **OBJ_TOL)
    np.testing.assert_allclose(got.best_pos.numpy(),
                               np.asarray(want.best_pos), **TOL)


def test_fused_run_converges_and_is_monotone():
    fn, hw = tobj.get_objective("sphere")
    st = tbat.bat_init(fn, 256, 4, hw, seed=0, device="cpu")
    prev = float(st.best_fit)
    s = st
    for _ in range(3):
        s = tbf.fused_bat_run(s, "sphere", 20, half_width=hw)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
    assert prev < 1.0 and int(s.iteration) == 60
    assert float(s.loudness.min()) < 1.0 and float(s.pulse.max()) > 0.0
    host = tbf.fused_bat_run(st, "sphere", 10, half_width=hw, rng="host")
    assert float(host.best_fit) <= float(st.best_fit)


def test_fused_run_pads_non_tile_multiples():
    fn, hw = tobj.get_objective("sphere")
    st = tbat.bat_init(fn, 200, 3, hw, seed=1, device="cpu")
    out = tbf.fused_bat_run(st, "sphere", 10, half_width=hw)
    assert out.pos.shape == (200, 3) and out.fit.shape == (200,)
    assert float(out.best_fit) <= float(st.best_fit)
    np.testing.assert_allclose(fn(out.pos).numpy(), out.fit.numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match='rng="host"'):
        tbf.fused_bat_run(st, "sphere", 1, uniforms=[()])


def test_model_backend_switch(monkeypatch):
    # On the card by default: without one the model raises unless the CPU
    # is asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.Bat("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.Bat("sphere", n=256, dim=4, seed=0, use_pallas=True,
                   device="cpu")
    assert opt.use_pallas and opt.device.type == "cpu"
    opt.run(60)
    assert opt.best < 1.0
    assert int(opt.state.iteration) == 60
    port = tdsa.Bat("sphere", n=64, dim=4, seed=0, device="cpu")
    assert port.use_pallas is False
    port.step()
    assert int(port.state.iteration) == 1
    with pytest.raises(ValueError):
        tdsa.Bat(tobj.sphere, n=16, dim=2, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.Bat("sphere", n=16, dim=2, f_min=3.0, device="cpu")
    # The JAX model's constructor arguments carry over.
    j = JBat("sphere", n=16, dim=2, seed=0)
    t = tdsa.Bat("sphere", n=16, dim=2, seed=0, device="cpu")
    for attr in ("half_width", "f_min", "f_max", "alpha", "gamma", "r0",
                 "sigma_local", "steps_per_kernel"):
        assert getattr(j, attr) == getattr(t, attr), attr


def test_state_numpy_round_trip_and_no_build_at_import():
    fn, hw = tobj.get_objective("sphere")
    st = tbat.bat_init(fn, 32, 3, hw, seed=2, device="cpu")
    back = tbat.bat_state_from_numpy(tbat.bat_state_to_numpy(st),
                                     device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    with pytest.raises(ValueError, match="missing"):
        tbat.bat_state_from_numpy({"pos": np.zeros((2, 2))}, device="cpu")
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda.bat_fused"
            " as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
