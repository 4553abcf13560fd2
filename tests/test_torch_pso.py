"""The port's portable PSO path against the JAX package.

The same numpy inputs go through the JAX functions (on the CPU) and
through the port's, which run on CPU tensors here.  Draws are injected:
the tests compute the JAX key chain's uniforms (``ops/pso.py:99-103``) and
hand them to the port.

Tolerances, each with its reason:

- objectives: ``rtol = atol = 2e-5``, the JAX package's own band between
  its two registries (``tests/test_pallas_pso.py``).  XLA expands ``**20``
  into a product chain and fuses ``a + b * c`` on the CPU, and the two
  libraries' ``cos``/``sin``/``exp`` differ by ulps.
- one PSO step from the same state with the same draws: floats within
  ``rtol = atol = 1e-5`` (the same contraction).  ``improved`` (which
  particles took a new personal best) must agree except where
  ``|fit - pbest_fit|`` is inside the objective band, since an ulp can flip
  the comparison there.
- the neighbour selection of the ring and von Neumann topologies reads
  only the given fitness values: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import constraints as jcon
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops import pso as jpso
from distributed_swarm_algorithm_tpu.ops import topology as jtopo
from distributed_swarm_algorithm_tpu_torch import cli as tcli
from distributed_swarm_algorithm_tpu_torch.ops import constraints as tcon
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import pso as tpso
from distributed_swarm_algorithm_tpu_torch.ops import topology as ttopo

OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = sorted(jobj.OBJECTIVES)


def jax_state(name, n, d, seed):
    """A JAX PSOState a few steps into a run, from numpy draws."""
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (n, d)).astype(np.float32)
    vel = (0.1 * rng.uniform(-hw, hw, (n, d))).astype(np.float32)
    bpos = rng.uniform(-hw, hw, (n, d)).astype(np.float32)
    bfit = np.asarray(fn(jnp.asarray(bpos)))
    best = int(np.argmin(bfit))
    return jpso.PSOState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        pbest_pos=jnp.asarray(bpos), pbest_fit=jnp.asarray(bfit),
        gbest_pos=jnp.asarray(bpos[best]), gbest_fit=jnp.asarray(bfit[best]),
        key=jax.random.PRNGKey(seed), iteration=jnp.asarray(3, jnp.int32),
    )


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f))
            for f in tpso.PSO_TENSOR_FIELDS}


def jax_draws(key, shape):
    """(next key, r1, r2) as ``pso_step`` draws them."""
    key, k1, k2 = jax.random.split(key, 3)
    return (key, np.array(jax.random.uniform(k1, shape, jnp.float32)),
            np.array(jax.random.uniform(k2, shape, jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_objectives_match_jax(name):
    jfn, hw = jobj.get_objective(name)
    tfn, thw = tobj.get_objective(name)
    assert thw == pytest.approx(float(hw))
    rng = np.random.default_rng(1)
    for scale in (2.0, float(hw)):
        x = rng.uniform(-scale, scale, (64, 12)).astype(np.float32)
        want = np.asarray(jfn(jnp.asarray(x)))
        got = tfn(torch.from_numpy(x)).numpy()
        # Schwefel and griewank reach thousands on their own domains: the
        # band is relative there.
        np.testing.assert_allclose(got, want, **OBJ_TOL)
    batched = tfn(torch.from_numpy(x).reshape(4, 16, 12))
    assert batched.shape == (4, 16)
    np.testing.assert_array_equal(batched.reshape(-1).numpy(), got)


def test_get_objective_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown objective"):
        tobj.get_objective("nope")
    assert sorted(tobj.OBJECTIVES) == NAMES


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "ackley",
                                  "rosenbrock"])
@pytest.mark.parametrize(
    "topology,radius,cols",
    [("gbest", 1, 0), ("ring", 1, 0), ("ring", 2, 0), ("vonneumann", 1, 0),
     ("vonneumann", 1, 8)],
)
def test_pso_step_matches_jax(name, topology, radius, cols):
    n, d = 96, 6
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jax_state(name, n, d, seed=5)
    ts = tpso.pso_state_from_numpy(to_numpy(js), device="cpu")
    _, r1, r2 = jax_draws(js.key, (n, d))
    want = jpso.pso_step(js, jfn, half_width=hw, topology=topology,
                         ring_radius=radius, grid_cols=cols)
    got = tpso.pso_step(ts, tfn, half_width=hw, topology=topology,
                        ring_radius=radius, grid_cols=cols,
                        r1=torch.from_numpy(r1), r2=torch.from_numpy(r2))
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    assert int(got.iteration) == int(want.iteration) == 4
    assert got.iteration.dtype == torch.int32
    # improved: equal except where the new fitness is within the band of
    # the old personal best.
    fit = np.asarray(jfn(want.pos))
    close = np.isclose(fit, np.asarray(js.pbest_fit), **OBJ_TOL)
    improved_j = np.asarray(want.pbest_fit) != np.asarray(js.pbest_fit)
    improved_t = got.pbest_fit.numpy() != ts.pbest_fit.numpy()
    assert ((improved_j == improved_t) | close).all()
    same = improved_j == improved_t
    np.testing.assert_allclose(got.pbest_fit.numpy()[same],
                               np.asarray(want.pbest_fit)[same], **OBJ_TOL)
    np.testing.assert_allclose(got.pbest_pos.numpy()[same],
                               np.asarray(want.pbest_pos)[same], **TOL)
    np.testing.assert_allclose(float(got.gbest_fit), float(want.gbest_fit),
                               **OBJ_TOL)


@pytest.mark.parametrize(
    "topology,radius,cols",
    [("gbest", 1, 0), ("ring", 1, 0), ("ring", 2, 0), ("ring", 5, 0),
     ("vonneumann", 1, 0), ("vonneumann", 1, 4), ("vonneumann", 1, 30)],
)
def test_neighbor_best_selection_is_exact(topology, radius, cols):
    rng = np.random.default_rng(9)
    n, d = 120, 3
    # Few distinct values: many ties, which go to the first shift.
    fit = rng.integers(0, 6, n).astype(np.float32)
    pos = rng.normal(size=(n, d)).astype(np.float32)
    wp, wf = jtopo.neighbor_best(jnp.asarray(fit), jnp.asarray(pos),
                                 topology, radius=radius, cols=cols)
    gp, gf = ttopo.neighbor_best(torch.from_numpy(fit),
                                 torch.from_numpy(pos), topology,
                                 radius=radius, cols=cols)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_topology_errors_and_default_cols():
    fit, pos = torch.zeros(10), torch.zeros(10, 2)
    with pytest.raises(ValueError, match="radius"):
        ttopo.ring_best(fit, pos, 0)
    with pytest.raises(ValueError, match="must divide"):
        ttopo.von_neumann_best(fit, pos, 3)
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.neighbor_best(fit, pos, "star")
    for n in (1, 12, 97, 120, 1024):
        assert ttopo._default_cols(n) == jtopo._default_cols(n)
    assert ttopo.TOPOLOGIES == jtopo.TOPOLOGIES


def test_argmin_takes_the_first_of_equal_minima_like_jax():
    x = np.array([3.0, 1.0, 5.0, 1.0, 1.0, 7.0], np.float32)
    assert int(torch.argmin(torch.from_numpy(x))) == int(
        jnp.argmin(jnp.asarray(x))) == 1
    m = np.array([[2, 0, 0], [1, 1, 1], [4, 3, 3]], np.float32)
    np.testing.assert_array_equal(
        torch.argmin(torch.from_numpy(m), dim=1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(m), axis=1)))


def test_pso_run_matches_jax_step_by_step_draws():
    n, d, steps = 64, 5, 6
    jfn, hw = jobj.get_objective("sphere")
    tfn, _ = tobj.get_objective("sphere")
    js = jax_state("sphere", n, d, seed=2)
    ts = tpso.pso_state_from_numpy(to_numpy(js), device="cpu")
    key, r1s, r2s = js.key, [], []
    for _ in range(steps):
        key, r1, r2 = jax_draws(key, (n, d))
        r1s.append(r1)
        r2s.append(r2)
    want = jpso.pso_run(js, jfn, steps, half_width=hw)
    got = tpso.pso_run(ts, tfn, steps, half_width=hw,
                       uniforms=(torch.from_numpy(np.stack(r1s)),
                                 torch.from_numpy(np.stack(r2s))))
    # Sphere is smooth, so six steps stay within a loose band.
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got.gbest_fit), float(want.gbest_fit),
                               rtol=1e-4, atol=1e-5)
    assert int(got.iteration) == int(want.iteration)


def test_pso_init_and_own_draws():
    fn, hw = tobj.get_objective("rastrigin")
    s = tpso.pso_init(fn, 128, 7, hw, seed=3, device="cpu")
    assert s.pos.shape == (128, 7) and s.pos.dtype == torch.float32
    assert float(s.pos.abs().max()) <= hw
    assert float(s.vel.abs().max()) <= 0.1 * hw + 1e-6
    assert float(s.gbest_fit) == float(s.pbest_fit.min())
    again = tpso.pso_init(fn, 128, 7, hw, seed=3, device="cpu")
    assert torch.equal(s.pos, again.pos)
    out = tpso.pso_run(s, fn, 40, half_width=hw)
    assert float(out.gbest_fit) <= float(s.gbest_fit)
    assert bool((out.pbest_fit <= s.pbest_fit).all())
    assert float(out.pos.abs().max()) <= hw + 1e-6
    assert int(out.iteration) == 40


def test_state_converters_round_trip():
    js = jax_state("levy", 16, 4, seed=8)
    arrays = to_numpy(js)
    ts = tpso.pso_state_from_numpy(arrays, device="cpu")
    back = tpso.pso_state_to_numpy(ts)
    assert set(back) == set(tpso.PSO_TENSOR_FIELDS)
    for f in back:
        np.testing.assert_array_equal(back[f], arrays[f])
        assert back[f].dtype == arrays[f].dtype
    with pytest.raises(ValueError, match="missing fields"):
        tpso.pso_state_from_numpy({"pos": arrays["pos"]}, device="cpu")
    assert (tpso.W, tpso.C1, tpso.C2) == (jpso.W, jpso.C1, jpso.C2)


def test_constraints_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    jg = [lambda v: 1.0 - v[:, 0], lambda v: v[:, 1] - 0.5]
    jh = [lambda v: v[:, 2] + v[:, 0]]
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        tcon.violation(xt, jg, jh).numpy(),
        np.asarray(jcon.violation(xj, jg, jh)), **TOL)
    np.testing.assert_array_equal(
        tcon.feasible_mask(xt, jg, jh, tol=0.3).numpy(),
        np.asarray(jcon.feasible_mask(xj, jg, jh, tol=0.3)))
    want = jcon.penalized(jobj.sphere, jg, jh, rho=50.0)(xj)
    got = tcon.penalized(tobj.sphere, jg, jh, rho=50.0)(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # Feasible points pay nothing.
    assert float(tcon.violation(torch.tensor([[2.0, 0.0, -2.0]]), jg, jh)) == 0


def test_pso_model_on_the_cpu():
    opt = tdsa.PSO("sphere", n=256, dim=4, seed=0, device="cpu")
    assert opt.use_pallas is False and opt.device.type == "cpu"
    first = opt.best
    opt.run(60)
    assert opt.best < 1e-3 < first
    opt.step()
    assert int(opt.state.iteration) == 61
    ring = tdsa.PSO("rastrigin", n=120, dim=5, seed=1, topology="ring",
                    ring_radius=2, device="cpu")
    start = ring.best
    ring.run(30)
    assert ring.best <= start
    with pytest.raises(ValueError, match="unknown topology"):
        tdsa.PSO("sphere", n=8, dim=2, topology="star", device="cpu")
    # A callable objective gets the default domain.
    custom = tdsa.PSO(tobj.sphere, n=32, dim=3, device="cpu")
    assert custom.half_width == 5.12 and custom.objective_name is None


def test_pso_model_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.PSO("sphere", n=8, dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.MemeticPSO("sphere", n=8, dim=2)


@pytest.mark.parametrize(
    "extra,key,value",
    [([], "path", "portable"),
     (["--topology", "ring", "--ring-radius", "2"], "topology", "ring"),
     (["--refine-every", "5"], "memetic", True),
     (["--islands", "4", "--migrate-every", "5", "--migrate-k", "2"],
      "islands", 4)],
    ids=["gbest", "ring", "memetic", "islands"],
)
def test_cli_pso_on_the_cpu(capsys, extra, key, value):
    rc = tcli.main(["pso", "--device", "cpu", "--objective", "sphere",
                    "--n", "128", "--dim", "4", "--steps", "40", *extra])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out[key] == value and out["backend"] == "torch-cpu"
    assert out["best"] < 0.5 and out["iters"] == 40
    if "islands" in out:
        assert out["particles_per_island"] == 32 and out["path"] == "portable"


def test_cli_pso_rejects_what_the_jax_cli_rejects(capsys, monkeypatch):
    for bad in (["--islands", "0"], ["--islands", "2", "--topology", "ring"],
                ["--islands", "2", "--refine-every", "3"],
                ["--islands", "64", "--n", "8"]):
        with pytest.raises(SystemExit):
            tcli.main(["pso", "--device", "cpu", *bad])
    assert tcli.main(["pso", "--device", "cpu", "--objective", "nope"]) == 2
    assert "unknown objective" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["pso", "--n", "8", "--steps", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert tcli.main(["pso", "--islands", "2", "--n", "8", "--steps",
                      "1"]) == 2
