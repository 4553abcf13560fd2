"""The port's CMA-ES (``ops/cmaes.py``, ``models/cmaes.py``, the CLI's
``cmaes``) against the JAX package.

The JAX run is compiled (``cmaes_run``), so each generation is held to
``jax.jit(cmaes_step)`` from the same state, with JAX's own draws (its
normals ``z``), JAX's eigenbasis (``jnp.linalg.eigh`` of the same
covariance: an eigenbasis is not a contract between libraries) and JAX's
params (XLA's f32 ``log`` and its sum order give weights a few ulps off
PyTorch's correctly rounded ones).

Tolerances, each with its reason:

- the stall gate ``h_sigma``, the selected samples, the iteration: exact;
- the params against JAX's own: integers exact, weights and constants
  ``1e-6`` relative (XLA's ``log`` and sum order), the weights also
  ``1e-7`` absolute (the last weight, ``log(mu + 1/2) - log(mu)``, cancels:
  XLA's ulp of ``log(7)`` is 1.7e-6 of it at mu = 7);
- mean, paths, covariance, sigma ``rtol = 2e-5``, ``atol = 1e-6``: the
  [lambda, D] and [D, D] products and the norms sum in another order, and
  ``exp`` and ``pow`` are each library's own;
- the best fitness ``2e-5``, the JAX package's band for its objectives.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu.ops import cmaes as jc
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu_torch.models.cmaes import CMAES
from distributed_swarm_algorithm_tpu_torch.ops import cmaes as tc
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj

REPO = Path(__file__).resolve().parent.parent
STATE_TOL = dict(rtol=2e-5, atol=1e-6)
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
jstep = jax.jit(jc.cmaes_step,
                static_argnames=("objective", "params", "half_width"))


def t(a):
    return torch.from_numpy(np.array(a))


def port_state(js):
    return tc.cmaes_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in tc.CMAES_TENSOR_FIELDS},
        device="cpu")


def jax_draws(js, params):
    _, k_z = jax.random.split(js.key)
    z = jax.random.normal(k_z, (params.popsize, js.mean.shape[0]),
                          jnp.float32)
    vals, vecs = jnp.linalg.eigh(js.cov)
    return (t(vals), t(vecs)), t(z)


def assert_state_close(got, want):
    for f in ("mean", "sigma", "cov", "p_sigma", "p_c", "best_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **STATE_TOL,
                                   err_msg=f)
    np.testing.assert_allclose(float(got.best_fit), float(want.best_fit),
                               **OBJ_TOL)
    assert int(got.iteration) == int(want.iteration)


def test_default_popsize_and_param_checks():
    for d in (2, 5, 10, 30, 100):
        assert tc.default_popsize(d) == jc.default_popsize(d)
    assert tc.default_popsize(10) == 4 + int(3 * math.log(10))
    with pytest.raises(ValueError, match="popsize"):
        tc.cmaes_params(10, popsize=3)


@pytest.mark.parametrize("dim,lam", [(2, None), (6, None), (10, 14),
                                     (30, None), (30, 64), (100, 200)])
def test_params_match_jax(dim, lam):
    got, want = tc.cmaes_params(dim, lam), jc.cmaes_params(dim, lam)
    assert (got.popsize, got.mu) == (want.popsize, want.mu)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-6,
                               atol=1e-7)
    for f in ("mu_eff", "c_sigma", "d_sigma", "c_c", "c_1", "c_mu",
              "chi_n"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6)


def test_params_weights_normalized():
    p = tc.cmaes_params(12)
    w = torch.tensor(p.weights)
    assert p.mu == p.popsize // 2
    assert abs(float(w.sum()) - 1.0) < 1e-6
    assert bool((w[:-1] >= w[1:]).all())
    assert 1.0 <= p.mu_eff <= p.mu + 1e-6


@pytest.mark.parametrize("t_iter", [0, 1, 3, 10, 50])
def test_stall_gate_matches_the_compiled_jax_form(t_iter):
    # h_sigma reads |p_sigma| / sqrt(1 - (1 - c)^(2t)) / chi_n, which the
    # compiled step divides by chi_n as a product with its f32 reciprocal.
    # Paths scaled across the threshold, densely near it.
    p = jc.cmaes_params(30)
    thr = (1.4 + 2.0 / 31.0) * p.chi_n * math.sqrt(
        1.0 - (1.0 - p.c_sigma) ** (2.0 * (t_iter + 1)))
    rng = np.random.default_rng(t_iter)
    u = rng.normal(size=(4000, 30)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = thr * (1.0 + np.linspace(-1e-5, 1e-5, 4000))
    paths = (u * scale[:, None]).astype(np.float32)

    @jax.jit
    def jgate(ps):
        norm = jnp.linalg.norm(ps)
        tt = jnp.asarray(t_iter + 1, jnp.float32)
        return jnp.where(
            norm / jnp.sqrt(1.0 - (1.0 - p.c_sigma) ** (2.0 * tt))
            / p.chi_n < 1.4 + 2.0 / 31.0, 1.0, 0.0)

    it = torch.tensor(t_iter, dtype=torch.int32)
    tp = tc.CMAESParams(*p)
    got = [float(tc.stall_gate(t(row), it, tp)[0]) for row in paths]
    want = [float(jgate(jnp.asarray(row))) for row in paths[::40]]
    assert got[::40] == want
    assert 0.0 < np.mean(got) < 1.0


@pytest.mark.parametrize("name,dim,lam,hw", [("sphere", 5, None, 5.12),
                                             ("rosenbrock", 6, None, 5.0),
                                             ("rastrigin", 8, 16, 5.12),
                                             ("ackley", 4, None, None)])
def test_three_generations_match_the_compiled_jax_step(name, dim, lam, hw):
    jfn, _ = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    jp = jc.cmaes_params(dim, lam)
    tp = tc.CMAESParams(*jp)
    mean = np.random.default_rng(dim).uniform(-1, 1, dim).astype(np.float32)
    js = jc.cmaes_init(dim, sigma=1.5, mean=jnp.asarray(mean), seed=dim)
    for _ in range(3):
        eig, z = jax_draws(js, jp)
        got = tc.cmaes_step(port_state(js), tfn, tp, hw, eig=eig, z=z)
        js_next = jstep(js, jfn, jp, half_width=hw)
        assert_state_close(got, js_next)
        # h_sigma exact: where it is 0 the covariance path only decays.
        h, _ = tc.stall_gate(got.p_sigma, port_state(js).iteration, tp)
        jh = float(jnp.linalg.norm(js_next.p_sigma) / jnp.sqrt(
            1.0 - (1.0 - jp.c_sigma) ** (2.0 * (int(js.iteration) + 1)))
            / jp.chi_n < 1.4 + 2.0 / (dim + 1.0))
        assert float(h) == jh
        js = js_next


def test_the_model_steps_match_jax_with_a_handed_eigenbasis():
    jfn, hw = jobj.get_objective("rosenbrock")
    opt = CMAES("rosenbrock", dim=5, seed=2, device="cpu")
    jp = jc.cmaes_params(5)
    opt.params = tc.CMAESParams(*jp)
    js = jc.cmaes_init(5, sigma=float(opt.state.sigma),
                       mean=jnp.asarray(opt.state.mean.numpy()), seed=2)
    for _ in range(3):
        opt.state = port_state(js)
        eig, z = jax_draws(js, jp)
        opt.step(eig=eig, z=z)
        js = jstep(js, jfn, jp, half_width=hw)
        assert_state_close(opt.state, js)
    assert opt.best == pytest.approx(float(js.best_fit), rel=2e-5)


def test_init_and_the_model_defaults():
    st = tc.cmaes_init(4, sigma=0.5, device="cpu")
    js = jc.cmaes_init(4, sigma=0.5)
    for f in tc.CMAES_TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    opt = CMAES("rastrigin", dim=6, seed=1, device="cpu")
    assert opt.half_width == 5.12
    assert float(opt.state.sigma) == pytest.approx(0.3 * 2 * 5.12)
    assert float(opt.state.mean.abs().max()) <= 0.5 * 5.12
    assert opt.params.popsize == tc.default_popsize(6)
    assert CMAES(lambda x: (x * x).sum(1), dim=3,
                 device="cpu").half_width is None


def test_sphere_converges_deeply():
    opt = CMAES("sphere", dim=10, seed=0, device="cpu")
    opt.run(400)
    assert opt.best < 1e-8


def test_rosenbrock_converges():
    opt = CMAES("rosenbrock", dim=6, seed=1, device="cpu")
    opt.run(800)
    assert opt.best < 1e-3


def test_custom_callable_objective():
    fn, _ = tobj.get_objective("sphere")
    opt = CMAES(lambda x: fn(x - 2.0), dim=4, sigma=1.0, seed=2,
                device="cpu")
    opt.run(300)
    assert opt.best < 1e-6
    assert bool(torch.allclose(opt.state.mean, torch.full((4,), 2.0),
                               atol=1e-2))


def test_sigma_shrinks_and_cov_stays_valid():
    opt = CMAES("sphere", dim=6, seed=3, device="cpu")
    sigma0 = float(opt.state.sigma)
    opt.run(300)
    assert float(opt.state.sigma) < sigma0 * 0.1
    opt = CMAES("rastrigin", dim=8, seed=4, device="cpu")
    opt.run(200)
    c = opt.state.cov
    assert bool(torch.isfinite(c).all()) and torch.equal(c, c.T)
    assert bool((torch.linalg.eigvalsh(c) > 0).all())


def test_determinism_best_monotone_and_in_domain():
    a = CMAES("ackley", dim=6, seed=7, device="cpu")
    b = CMAES("ackley", dim=6, seed=7, device="cpu")
    a.run(60)
    b.run(60)
    assert a.best == b.best
    opt = CMAES("rastrigin", dim=5, seed=8, device="cpu")
    prev = opt.best
    for _ in range(50):
        opt.step()
        assert opt.best <= prev
        prev = opt.best
    assert float(opt.state.best_pos.abs().max()) <= opt.half_width


def test_run_is_the_loop_of_steps():
    fn, hw = tobj.get_objective("sphere")
    p = tc.cmaes_params(5)
    a = tc.cmaes_init(5, sigma=1.0, seed=5, device="cpu")
    b = tc.cmaes_init(5, sigma=1.0, seed=5, device="cpu")
    a = tc.cmaes_run(a, fn, p, 10, half_width=hw)
    for _ in range(10):
        b = tc.cmaes_step(b, fn, p, half_width=hw)
    for f in tc.CMAES_TENSOR_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_bad_mean_shape_raises():
    with pytest.raises(ValueError, match="mean"):
        tc.cmaes_init(4, mean=torch.zeros(3), device="cpu")


def test_cli_cmaes_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_swarm_algorithm_tpu_torch",
         "cmaes", "--device", "cpu", "--dim", "6", "--steps", "60"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["objective"] == "rosenbrock"
    assert row["popsize"] == tc.default_popsize(6)
    assert row["path"] == "portable" and row["backend"] == "torch-cpu"
    assert row["sigma"] > 0.0 and np.isfinite(row["best"])
