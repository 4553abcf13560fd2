"""The port's OpenAI-ES (``ops/es.py``, ``models/es.py``) and MAP-Elites
(``ops/map_elites.py``, ``models/map_elites.py``) against the JAX package.

The same numpy inputs and JAX's own draws from its key chain (ES's
[n/2, D] normals; MAP-Elites' Gumbel noise and mutation normals) go through
the JAX function and the port's.  The JAX generations run compiled, where
XLA multiplies by the f32 reciprocal of a static divisor (ES's rank scale
and gradient scale, MAP-Elites' descriptor); the port computes that form.

Tolerances, each with its reason:

- cells, parents, archive rows (which batch row fills which cell), ranks'
  order, the best's index: exact;
- the objectives ``2e-5`` (the JAX package's own band: ``cos``, ``exp``
  and the sums are each library's own);
- ES's mean and momentum ``1e-5`` relative: the gradient's dot product
  over n samples sums in another order;
- MAP-Elites' archive positions ``1e-6``: inside its fused generation XLA
  rounds the mutation ``parent + c * noise`` (with the normal draw) a few
  ulps off PyTorch's separate operations (neither two roundings nor one
  multiply-add reproduces it); the archive's rows from JAX's own children
  are exact.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu.ops import es as jes
from distributed_swarm_algorithm_tpu.ops import map_elites as jme
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu_torch.models.es import ES
from distributed_swarm_algorithm_tpu_torch.models.map_elites import MAPElites
from distributed_swarm_algorithm_tpu_torch.ops import es as tes
from distributed_swarm_algorithm_tpu_torch.ops import map_elites as tme
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
ES_TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "distributed_swarm_algorithm_tpu_torch",
         *args, "--device", "cpu"], capture_output=True, text=True,
        cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_constants_are_the_jax_packages():
    assert (tes.SIGMA, tes.LR, tes.MOMENTUM) == (jes.SIGMA, jes.LR,
                                                 jes.MOMENTUM)
    assert tme.SIGMA_MUT == jme.SIGMA_MUT


# ----------------------------------------------------------------------- es


def test_centered_ranks_invariance_and_range():
    fit = torch.tensor([3.0, 1.0, 2.0, 10.0])
    r = tes.centered_ranks(fit).numpy()
    np.testing.assert_allclose(sorted(r), [-0.5, -1 / 6, 1 / 6, 0.5],
                               atol=1e-6)
    assert r[1] == -0.5 and r[3] == 0.5
    np.testing.assert_array_equal(r, tes.centered_ranks(fit ** 3).numpy())
    assert abs(r.sum()) < 1e-6


@pytest.mark.parametrize("n", [2, 7, 64, 256])
def test_centered_ranks_match_the_compiled_jax_function(n):
    fit = np.random.default_rng(n).normal(size=n).astype(np.float32)
    fit[: n // 3] = fit[0]                   # ties keep index order
    want = np.asarray(jax.jit(jes.centered_ranks)(jnp.asarray(fit)))
    np.testing.assert_array_equal(tes.centered_ranks(t(fit)).numpy(), want)


def es_jax_eps(js, n):
    _, kd = jax.random.split(js.key)
    return t(jax.random.normal(kd, (n // 2, js.mean.shape[0]),
                               js.mean.dtype))


def es_port_state(js):
    return tes.es_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in tes.ES_TENSOR_FIELDS},
        device="cpu")


@pytest.mark.parametrize("name,n,d", [("rastrigin", 64, 5),
                                      ("sphere", 256, 6),
                                      ("ackley", 32, 3)])
def test_three_es_generations_match_jax(name, n, d):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jes.es_init(jfn, d, hw, seed=n)
    ps = tes.es_init(tfn, d, hw, device="cpu", mean=t(np.asarray(js.mean)))
    np.testing.assert_allclose(float(ps.best_fit), float(js.best_fit),
                               **OBJ_TOL)
    for k in range(3):
        eps = es_jax_eps(js, n)
        ps = tes.es_step(es_port_state(js), tfn, n=n, half_width=hw,
                         eps_half=eps)
        js = jes.es_step(js, jfn, n=n, half_width=hw)
        for f in ("mean", "mom", "best_pos"):
            np.testing.assert_allclose(getattr(ps, f).numpy(),
                                       np.asarray(getattr(js, f)), **ES_TOL,
                                       err_msg=f)
        np.testing.assert_allclose(float(ps.best_fit), float(js.best_fit),
                                   **OBJ_TOL)
        assert int(ps.iteration) == k + 1


def test_es_model_steps_match_jax_with_handed_draws():
    jfn, hw = jobj.get_objective("rastrigin")
    opt = ES("rastrigin", n=32, dim=4, seed=3, device="cpu")
    js = jes.es_init(jfn, 4, hw, seed=3)
    opt.state = es_port_state(js)
    for _ in range(3):
        eps = es_jax_eps(js, 32)
        js = jes.es_step(js, jfn, n=32, half_width=hw)
        opt.step(eps_half=eps)
        np.testing.assert_allclose(opt.state.mean.numpy(),
                                   np.asarray(js.mean), **ES_TOL)
    assert opt.best == pytest.approx(float(js.best_fit), rel=2e-5)


def test_es_converges_on_sphere():
    opt = ES("sphere", n=256, dim=6, seed=0, device="cpu")
    opt.run(300)
    assert opt.best < 1e-2


def test_es_best_is_monotone_and_mean_in_domain():
    fn, _ = tobj.get_objective("rastrigin")
    st = tes.es_init(fn, 5, 5.12, seed=1, device="cpu")
    prev = float(st.best_fit)
    for _ in range(30):
        st = tes.es_step(st, fn, n=128, half_width=5.12)
        assert float(st.best_fit) <= prev
        prev = float(st.best_fit)
    assert float(st.mean.abs().max()) <= 5.12


def test_es_is_deterministic_and_rejects_odd_populations():
    a = ES("rastrigin", n=64, dim=4, seed=7, device="cpu")
    b = ES("rastrigin", n=64, dim=4, seed=7, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best == b.best
    with pytest.raises(ValueError):
        ES("sphere", n=33, dim=2, device="cpu")


def test_cli_es_on_the_cpu():
    row = cli("es", "--objective", "sphere", "--n", "64", "--dim", "4",
              "--steps", "40")
    assert row["samples"] == 64 and row["path"] == "portable"
    assert row["backend"] == "torch-cpu" and row["best"] < 10.0


# --------------------------------------------------------------- map-elites


def test_cell_index_mapping():
    desc = t(np.float32([[0, 0], [0.99, 0.99], [0.5, 0], [-1, 2]]))
    assert tme.cell_index(desc, bins=4, lo=0.0, hi=1.0).tolist() == [
        0, 15, 8, 3]


@pytest.mark.parametrize("bins,lo,hi", [(16, 0.0, 1.0), (24, 0.0, 1.0),
                                        (7, -1.0, 2.5)])
def test_cell_index_matches_the_compiled_jax_function_on_bin_edges(bins, lo,
                                                                   hi):
    # Descriptors on and one ulp either side of every bin edge, and out of
    # range (clamped), through the compiled program me_step runs.
    edges = lo + (hi - lo) * np.arange(-2, bins + 3) / bins
    near = np.concatenate([np.nextafter(edges.astype(np.float32), -np.inf),
                           edges.astype(np.float32),
                           np.nextafter(edges.astype(np.float32), np.inf),
                           np.float32([-1e30, 1e30, -np.inf, np.inf])])
    desc = np.stack([near, near[::-1]], 1).astype(np.float32)
    want = np.asarray(jax.jit(jme.cell_index, static_argnums=(1, 2, 3))(
        jnp.asarray(desc), bins, lo, hi))
    np.testing.assert_array_equal(
        tme.cell_index(t(desc), bins, lo, hi).numpy(), want)


def test_default_descriptor_is_the_compiled_one():
    # (x + hw) / (2 hw) on the bin edges of x: compiled, a product with
    # f32(1 / (2 hw)), which the eager quotient is not.  The cells agree
    # with the compiled program's except within an ulp of a bin edge,
    # where XLA folds that product with the bin count into one constant
    # (one rounding, not two; ROADMAP Queue C).
    hw, bins = 5.12, 24
    opt = MAPElites("rastrigin", dim=2, bins=bins, seed=0, device="cpu",
                    n_init=4)
    x = np.float32(-hw + 2 * hw * np.arange(bins + 1) / bins)
    edges = np.concatenate([np.nextafter(x, -np.inf), x,
                            np.nextafter(x, np.inf)])
    inner = np.random.default_rng(0).uniform(-hw, hw, 100000).astype(
        np.float32)

    def jdesc(p):
        return (p[:, :2] + hw) / (2.0 * hw)

    for xs in (edges, inner):
        pos = np.stack([xs, xs[::-1]], 1).astype(np.float32)
        want = np.asarray(jax.jit(jdesc)(pos))
        got = opt.descriptor(t(pos)).numpy()
        np.testing.assert_array_equal(got, want)
    assert (np.asarray(jdesc(jnp.asarray(pos))) != want).any()
    want_cells = np.asarray(jax.jit(
        lambda p: jme.cell_index(jdesc(p), bins, 0.0, 1.0))(pos))
    np.testing.assert_array_equal(
        tme.cell_index(t(got), bins, 0.0, 1.0).numpy(), want_cells)


def test_insert_is_elitist_and_deterministic():
    a_pos = torch.zeros((4, 2))
    a_fit = torch.tensor([np.inf, 5.0, 1.0, np.inf])
    pos = t(np.float32([[1, 1], [2, 2], [3, 3], [4, 4]]))
    fit = torch.tensor([3.0, 3.0, 4.0, 2.0])
    new_pos, new_fit = tme.insert(a_pos, a_fit, pos, fit,
                                  torch.tensor([1, 1, 2, 3]))
    np.testing.assert_array_equal(new_fit.numpy(), [np.inf, 3.0, 1.0, 2.0])
    np.testing.assert_array_equal(new_pos[1].numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(new_pos[2].numpy(), [0.0, 0.0])


@pytest.mark.parametrize("c,k,seed", [(16, 64, 0), (64, 512, 1),
                                      (576, 256, 2), (9, 3, 3)])
def test_insert_matches_jax_with_ties(c, k, seed):
    rng = np.random.default_rng(seed)
    a_pos = rng.normal(size=(c, 3)).astype(np.float32)
    a_fit = rng.choice(np.float32([np.inf, 0.5, 1.0, 2.0]), c)
    pos = rng.normal(size=(k, 3)).astype(np.float32)
    fit = rng.choice(np.float32([0.25, 0.5, 1.0, 1.5, 3.0]), k)
    cells = rng.integers(0, c, k).astype(np.int32)
    want = jax.jit(jme.insert)(*map(jnp.asarray, (a_pos, a_fit, pos, fit,
                                                  cells)))
    got = tme.insert(t(a_pos), t(a_fit), t(pos), t(fit), t(cells))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def me_jax_draws(js, batch):
    c, d = js.archive_pos.shape
    _, kg, km = jax.random.split(js.key, 3)
    return (t(jax.random.gumbel(kg, (batch, c), js.archive_pos.dtype)),
            t(jax.random.normal(km, (batch, d), js.archive_pos.dtype)))


def me_port_state(js):
    return tme.me_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in tme.ME_TENSOR_FIELDS},
        device="cpu")


@jax.jit
def jax_me_children(state, hw, sigma_mut):
    c, d = state.archive_pos.shape
    _, kg, km = jax.random.split(state.key, 3)
    logits = jnp.where(jnp.isfinite(state.archive_fit), 0.0, -jnp.inf)
    gumbel = jax.random.gumbel(kg, (256, c), state.archive_pos.dtype)
    parents = jnp.argmax(logits[None, :] + gumbel, axis=1)
    kids = state.archive_pos[parents] + sigma_mut * hw * jax.random.normal(
        km, (256, d), state.archive_pos.dtype)
    return parents, jnp.clip(kids, -hw, hw)


@pytest.mark.parametrize("name,d,bins", [("rastrigin", 6, 16),
                                         ("sphere", 3, 6)])
def test_three_me_generations_match_jax(name, d, bins):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)

    def jdesc(x):
        return (x[:, :2] + hw) / (2.0 * hw)

    tdesc = MAPElites(name, dim=d, bins=bins, device="cpu",
                      n_init=2).descriptor
    js = jme.me_init(jfn, jdesc, d, bins, 2, hw, seed=d)
    for k in range(3):
        draws = me_jax_draws(js, 256)
        ps = me_port_state(js)
        parents, jkids = jax_me_children(js, hw, jme.SIGMA_MUT)
        filled = torch.isfinite(ps.archive_fit)
        logits = torch.where(filled, 0.0, -float("inf"))
        np.testing.assert_array_equal(
            torch.argmax(logits[None] + draws[0], 1).numpy(),
            np.asarray(parents))
        got = tme.me_step(ps, tfn, tdesc, bins, hw, batch=256, draws=draws)
        js = jme.me_step(js, jfn, jdesc, bins, hw, batch=256)
        np.testing.assert_allclose(got.archive_pos.numpy(),
                                   np.asarray(js.archive_pos), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.archive_fit.numpy(),
                                   np.asarray(js.archive_fit), **OBJ_TOL)
        # The archive rows from JAX's own children: cells and winners exact.
        kids = t(np.asarray(jkids))
        want_cells = np.asarray(jax.jit(
            lambda x: jme.cell_index(jdesc(x), bins, 0.0, 1.0))(jkids))
        cells = tme.cell_index(tdesc(kids), bins, 0.0, 1.0)
        np.testing.assert_array_equal(cells.numpy(), want_cells)
        # (The objective compiled alone rounds a few ulps off the one fused
        # into JAX's step: the rows exact, the fitness within its band.)
        fit = t(np.asarray(jax.jit(jfn)(jkids)))
        a_pos, a_fit = tme.insert(ps.archive_pos, ps.archive_fit, kids, fit,
                                  cells)
        np.testing.assert_array_equal(a_pos.numpy(),
                                      np.asarray(js.archive_pos))
        np.testing.assert_allclose(a_fit.numpy(),
                                   np.asarray(js.archive_fit), **OBJ_TOL)
        assert int(got.iteration) == k + 1


def test_me_init_matches_jax_from_the_same_positions():
    jfn, hw = jobj.get_objective("rastrigin")
    tfn, _ = tobj.get_objective("rastrigin")
    js = jme.me_init(jfn, lambda x: (x[:, :2] + hw) / (2.0 * hw), 6, 16, 2,
                     hw, seed=5)
    # JAX's init is eager; the same positions with its own quotients.
    pos = np.asarray(jax.random.uniform(jax.random.split(
        jax.random.PRNGKey(5))[1], (256, 6), jnp.float32, minval=-hw,
        maxval=hw))
    ps = tme.me_init(tfn, lambda x: (x[:, :2] + hw) / (2.0 * hw), 6, 16, 2,
                     hw, device="cpu", pos=t(pos))
    np.testing.assert_array_equal(np.isfinite(ps.archive_fit.numpy()),
                                  np.isfinite(np.asarray(js.archive_fit)))
    np.testing.assert_array_equal(ps.archive_pos.numpy(),
                                  np.asarray(js.archive_pos))
    np.testing.assert_allclose(ps.archive_fit.numpy(),
                               np.asarray(js.archive_fit), **OBJ_TOL)


def test_me_model_steps_match_jax_with_handed_draws():
    jfn, hw = jobj.get_objective("rastrigin")
    opt = MAPElites("rastrigin", dim=4, bins=8, seed=0, batch=64,
                    device="cpu")
    js = jme.me_init(jfn, lambda x: (x[:, :2] + hw) / (2.0 * hw), 4, 8, 2,
                     hw, seed=0)
    opt.state = me_port_state(js)
    for _ in range(3):
        draws = (me_jax_draws(js, 64)[0],
                 t(jax.random.normal(jax.random.split(js.key, 3)[2], (64, 4))))
        js = jme.me_step(js, jfn, lambda x: (x[:, :2] + hw) / (2.0 * hw), 8,
                         hw, batch=64)
        opt.step(draws=draws)
        np.testing.assert_allclose(opt.state.archive_fit.numpy(),
                                   np.asarray(js.archive_fit), **OBJ_TOL)
    assert opt.coverage == float(jme.coverage(js))
    assert opt.qd_score(100.0) == pytest.approx(
        float(jme.qd_score(js, 100.0)), rel=1e-5)
    pos, fit = opt.elites()
    assert pos.shape[0] == fit.shape[0] == int(opt.coverage * 64)


def test_map_elites_illuminates_rastrigin():
    opt = MAPElites("rastrigin", dim=4, bins=8, seed=0, batch=128,
                    device="cpu")
    cov0 = opt.coverage
    opt.run(100)
    assert opt.coverage > cov0 and opt.coverage > 0.9
    assert opt.best < 10.0
    pos, fit = opt.elites()
    assert pos.shape[0] == fit.shape[0] == int(opt.coverage * 64)
    fn, _ = tobj.get_objective("rastrigin")
    np.testing.assert_allclose(fn(t(pos)).numpy(), fit, atol=1e-4)


def test_map_elites_archive_monotone_per_cell():
    opt = MAPElites("sphere", dim=3, bins=6, seed=1, batch=64, device="cpu")
    prev = opt.state.archive_fit.clone()
    for _ in range(10):
        opt.step()
        assert bool((opt.state.archive_fit <= prev).all())
        prev = opt.state.archive_fit.clone()


def test_map_elites_is_deterministic_and_checks_its_arguments():
    a = MAPElites("rastrigin", dim=4, bins=8, seed=7, batch=64, device="cpu")
    b = MAPElites("rastrigin", dim=4, bins=8, seed=7, batch=64, device="cpu")
    a.run(20)
    b.run(20)
    assert torch.equal(a.state.archive_fit, b.state.archive_fit)
    with pytest.raises(ValueError):
        MAPElites("sphere", dim=4, bins=0, device="cpu")
    with pytest.raises(ValueError):
        MAPElites("sphere", dim=1, device="cpu")


def test_cli_mapelites_on_the_cpu():
    row = cli("mapelites", "--n", "64", "--dim", "4", "--bins", "6",
              "--steps", "20")
    assert row["batch"] == 64 and row["bins"] == 6
    assert 0.0 < row["coverage"] <= 1.0 and row["backend"] == "torch-cpu"
