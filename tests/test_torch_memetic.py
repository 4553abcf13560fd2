"""The port's memetic (gradient-hybrid) PSO against the JAX package.

The same numpy inputs go through both packages on the CPU; draws are
injected (the JAX key chain's uniforms).

Tolerances, each with its reason:

- gradients of ``sum(f)`` by ``torch.autograd`` against ``jax.grad``, for
  both objective registries: ``rtol = atol = 1e-5`` relative to the
  gradient's scale (XLA fuses ``a + b * c`` and the libraries' ``sin`` and
  ``cos`` differ by ulps); schwefel's ``sqrt(|x|)`` has no gradient at 0,
  which both packages guard the same way.
- ``gd_refine`` after a few steps: ``rtol = atol = 1e-4`` (the gradient
  band times the step count and ``lr``).
- ``refine_pbest`` and the runs: monotone, and the cadence exact: a
  refinement fires exactly when the iteration counter reaches a multiple
  of ``refine_every``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import memetic as jmem
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops import pso as jpso
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu_torch.ops import memetic as tmem
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import pso as tpso
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf

NAMES = sorted(jobj.OBJECTIVES)


def points(name, n, d, seed):
    _, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    # Inside the domain, away from its edge and from schwefel's kink at 0.
    x = rng.uniform(-0.8 * hw, 0.8 * hw, (n, d)).astype(np.float32)
    return np.where(np.abs(x) < 1e-3 * hw, 0.01 * hw, x).astype(np.float32)


def torch_grad(fn, x):
    p = torch.from_numpy(x).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(p).sum(), p)
    return g.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    jfn, _ = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    x = points(name, 48, 7, seed=1)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jfn(p)))(jnp.asarray(x)))
    got = torch_grad(tfn, x)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                               atol=1e-5)
    # The transposed registry, which the fused composition differentiates.
    want_t = np.asarray(jax.grad(
        lambda p: jnp.sum(jpf.OBJECTIVES_T[name](p)))(jnp.asarray(x.T)))
    got_t = torch_grad(tpf.OBJECTIVES_T[name], np.ascontiguousarray(x.T))
    np.testing.assert_allclose(got_t / scale, want_t / scale, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["sphere", "rosenbrock", "rastrigin",
                                  "styblinski_tang"])
def test_gd_refine_matches_jax(name):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    x = points(name, 32, 5, seed=2)
    lr = 1e-3
    want = np.asarray(jmem.gd_refine(jnp.asarray(x), jfn, 4, lr, hw))
    got = tmem.gd_refine(torch.from_numpy(x), tfn, 4, lr, float(hw))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert float(got.abs().max()) <= hw
    # Descent: the refined points are no worse on a smooth objective.
    if name == "sphere":
        assert bool((tfn(got) <= tfn(torch.from_numpy(x))).all())
    # The transposed layout runs through the same function.
    got_t = tmem.gd_refine(torch.from_numpy(np.ascontiguousarray(x.T)),
                           tpf.OBJECTIVES_T[name], 4, lr, float(hw))
    np.testing.assert_allclose(got_t.numpy().T, want, rtol=1e-4, atol=1e-4)


def test_gd_refine_guards_non_finite_gradients():
    # sqrt(|x|) has an infinite slope at 0; the step there is 0, as in JAX.
    x = np.array([[0.0, 100.0], [50.0, 0.0]], np.float32)
    jfn, hw = jobj.get_objective("schwefel")
    tfn, _ = tobj.get_objective("schwefel")
    want = np.asarray(jmem.gd_refine(jnp.asarray(x), jfn, 2, 0.01, hw))
    got = tmem.gd_refine(torch.from_numpy(x), tfn, 2, 0.01, float(hw))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert got[0, 0] == 0.0 and got[1, 1] == 0.0


def jax_state(name, n, d, seed, iteration=0):
    jfn, hw = jobj.get_objective(name)
    s = jpso.pso_init(jfn, n=n, dim=d, half_width=hw, seed=seed)
    return s.replace(iteration=jnp.asarray(iteration, jnp.int32))


def to_torch(js):
    return tpso.pso_state_from_numpy(
        {f: np.array(getattr(js, f)) for f in tpso.PSO_TENSOR_FIELDS},
        device="cpu")


def test_refine_pbest_matches_jax_and_is_monotone():
    jfn, hw = jobj.get_objective("rosenbrock")
    tfn, _ = tobj.get_objective("rosenbrock")
    js = jax_state("rosenbrock", 64, 4, seed=3)
    want = jmem.refine_pbest(js, jfn, 5, 1e-3, hw)
    ts = to_torch(js)
    got = tmem.refine_pbest(ts, tfn, 5, 1e-3, float(hw))
    assert bool((got.pbest_fit <= ts.pbest_fit).all())
    assert float(got.gbest_fit) <= float(ts.gbest_fit)
    assert bool((got.pbest_fit < ts.pbest_fit).any())
    np.testing.assert_allclose(got.pbest_fit.numpy(),
                               np.asarray(want.pbest_fit), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(got.gbest_fit), float(want.gbest_fit),
                               rtol=1e-4, atol=1e-4)
    # Positions and velocities are not touched.
    assert torch.equal(got.pos, ts.pos) and torch.equal(got.vel, ts.vel)


@pytest.mark.parametrize("start,every,steps", [(0, 4, 10), (3, 4, 10),
                                               (7, 5, 9), (0, 1, 3)])
def test_memetic_run_cadence_is_exact(start, every, steps, monkeypatch):
    # A refinement fires when the iteration counter (not the step count of
    # this call) reaches a multiple of refine_every, as in JAX's scan.
    tfn, hw = tobj.get_objective("sphere")
    ts = to_torch(jax_state("sphere", 32, 3, seed=4, iteration=start))
    fired = []
    real = tmem.refine_pbest

    def spy(state, *a, **k):
        fired.append(int(state.iteration))
        return real(state, *a, **k)

    monkeypatch.setattr(tmem, "refine_pbest", spy)
    out = tmem.memetic_run(ts, tfn, steps, refine_every=every,
                           half_width=hw)
    want = [i for i in range(start + 1, start + steps + 1) if i % every == 0]
    assert fired == want
    assert int(out.iteration) == start + steps
    with pytest.raises(ValueError, match="refine_every"):
        tmem.memetic_run(ts, tfn, 1, refine_every=0)


def test_memetic_run_matches_jax_with_injected_draws():
    n, d, steps = 48, 4, 6
    jfn, hw = jobj.get_objective("sphere")
    tfn, _ = tobj.get_objective("sphere")
    js = jax_state("sphere", n, d, seed=5)
    key, r1s, r2s = js.key, [], []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        r1s.append(np.array(jax.random.uniform(k1, (n, d), jnp.float32)))
        r2s.append(np.array(jax.random.uniform(k2, (n, d), jnp.float32)))
    want = jmem.memetic_run(js, jfn, steps, refine_every=3, refine_steps=2,
                            lr=0.05, half_width=hw)
    got = tmem.memetic_run(
        to_torch(js), tfn, steps, refine_every=3, refine_steps=2, lr=0.05,
        half_width=hw, uniforms=(torch.from_numpy(np.stack(r1s)),
                                 torch.from_numpy(np.stack(r2s))))
    assert int(got.iteration) == int(want.iteration) == steps
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.pbest_fit.numpy(),
                               np.asarray(want.pbest_fit), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.gbest_fit), float(want.gbest_fit),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("steps,every,spk,launches,refines",
                         [(20, 5, 8, 4, 4), (23, 10, 8, 5, 2),
                          (7, 10, 8, 1, 0), (12, 4, 2, 6, 3)])
def test_fused_memetic_run_schedule(steps, every, spk, launches, refines,
                                    monkeypatch):
    tfn, hw = tobj.get_objective("rastrigin")
    st = tpso.pso_init(tfn, 96, 5, hw, seed=6, device="cpu")
    calls, refined = [], []
    real_step, real_refine = tpf.fused_pso_step_t, tmem.gd_refine

    def step_spy(*a, **k):
        calls.append((k["step0"], k["k_steps"]))
        return real_step(*a, **k)

    def refine_spy(pos, *a, **k):
        refined.append(tuple(pos.shape))
        return real_refine(pos, *a, **k)

    monkeypatch.setattr(tpf, "fused_pso_step_t", step_spy)
    monkeypatch.setattr(tmem, "gd_refine", refine_spy)
    out = tmem.fused_memetic_run(st, "rastrigin", tfn, steps,
                                 refine_every=every, half_width=hw,
                                 steps_per_kernel=spk)
    assert len(calls) == launches and refined == [(5, 96)] * refines
    # The launches tile the run: each starts where the last one ended.
    assert [c[0] for c in calls] == list(np.cumsum([0] + [c[1] for c in
                                                          calls])[:-1])
    assert sum(c[1] for c in calls) == steps
    assert int(out.iteration) == steps and out.pos.shape == (96, 5)
    assert bool((out.pbest_fit <= st.pbest_fit).all())
    assert float(out.gbest_fit) <= float(out.pbest_fit.min()) + 1e-6
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    with pytest.raises(ValueError, match="refine_every"):
        tmem.fused_memetic_run(st, "rastrigin", tfn, 1, refine_every=0)


def test_memetic_model_on_the_cpu():
    opt = tdsa.MemeticPSO("rosenbrock", n=128, dim=4, refine_every=5,
                          seed=0, device="cpu")
    assert opt.use_pallas is False
    first = opt.best
    opt.run(40)
    assert opt.best < first and int(opt.state.iteration) == 40
    plain = tdsa.PSO("rosenbrock", n=128, dim=4, seed=0, device="cpu")
    plain.run(40)
    assert opt.best <= plain.best * 10       # the refinement does not hurt
    # step() refines on the same schedule as run().
    before = opt.state.pbest_fit.clone()
    for _ in range(5):
        opt.step()
    assert int(opt.state.iteration) == 45
    assert bool((opt.state.pbest_fit <= before).all())
    fused = tdsa.MemeticPSO("sphere", n=128, dim=4, refine_every=4, seed=1,
                            use_pallas=True, device="cpu")
    fused.run(20)
    assert fused.best < 1e-2
    with pytest.raises(ValueError, match="refine_every"):
        tdsa.MemeticPSO("sphere", n=8, dim=2, refine_every=0, device="cpu")
    with pytest.raises(ValueError):
        tdsa.MemeticPSO(tobj.sphere, n=8, dim=2, use_pallas=True,
                        device="cpu")
