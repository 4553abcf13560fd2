"""The port's grey wolf optimizer (``ops/gwo.py``, kernel B8's plain version
in ``ops/cuda/gwo_fused.py``, the ``GWO`` model) against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step, the TPU kernel in interpret mode with
host-supplied uniforms (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_gwo.py`` runs it) against the port's plain version, and
whole fused runs over several launches with the leader re-rank between
them.

Tolerances, each with its reason:

- positions ``rtol = atol = 1e-5``: the update is a handful of products
  and sums, rounded alike; a few ulps where XLA fuses a multiply-add.
- fitness ``2e-5``, the JAX package's own band for its objectives (the
  port sums row by row).
- the leaders' indices are exact: the re-rank is ``lax.top_k``'s stable
  order (fitness, then position in ``incumbents ++ pack``), held under
  heavy ties; the leaders' fitness and positions then carry the bands
  above.
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
from distributed_swarm_algorithm_tpu.ops import gwo as jgwo
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import gwo_fused as jgf
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu_torch.ops import gwo as tgwo
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import gwo_fused as tgf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = tgwo.GWO_TENSOR_FIELDS


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def assert_state_close(got, want, label):
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **TOL,
                               err_msg=f"{label} pos")
    np.testing.assert_allclose(got.fit.numpy(), np.asarray(want.fit),
                               **OBJ_TOL, err_msg=f"{label} fit")
    np.testing.assert_allclose(got.leader_fit.numpy(),
                               np.asarray(want.leader_fit), **OBJ_TOL,
                               err_msg=f"{label} leader_fit")
    np.testing.assert_allclose(got.leaders.numpy(), np.asarray(want.leaders),
                               **TOL, err_msg=f"{label} leaders")
    assert int(got.iteration) == int(want.iteration)


# --------------------------------------------------------------------------
# The stable re-rank
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "ties", "all_equal", "signed_zero",
                                  "inf"])
def test_stable_top3_is_lax_top_k(case):
    rng = np.random.default_rng(7)
    fit = {
        "random": rng.normal(size=300),
        "ties": rng.integers(0, 4, 300).astype(np.float64),
        "all_equal": np.full(300, 2.5),
        "signed_zero": np.where(rng.random(300) < 0.5, -0.0, 0.0),
        "inf": np.where(rng.random(300) < 0.9, np.inf, 1.0),
    }[case].astype(np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(fit), 3)
    got = tgwo.stable_top3(torch.from_numpy(fit))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got64 = tgwo.stable_top3(torch.from_numpy(fit.astype(np.float64)))
    np.testing.assert_array_equal(got64.numpy(), np.asarray(want))


def test_rerank_keeps_incumbents_on_ties_and_gathers_columns():
    d, m = 4, 50
    leaders = torch.arange(12, dtype=torch.float32).reshape(3, d)
    leader_fit = torch.tensor([1.0, 2.0, 2.0])
    pack_t = torch.arange(d * m, dtype=torch.float32).reshape(d, m) + 100
    pack_fit = torch.full((m,), 2.0)
    pack_fit[10] = 1.0                      # ties alpha, comes after it
    new, new_fit = tgwo.rerank_leaders(leaders, leader_fit, pack_t, pack_fit)
    assert torch.equal(new_fit, torch.tensor([1.0, 1.0, 2.0]))
    assert torch.equal(new[0], leaders[0])
    assert torch.equal(new[1], pack_t[:, 10])
    assert torch.equal(new[2], leaders[1])


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "levy"])
def test_portable_step_matches_jax(name):
    n, d = 96, 5
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jgwo.gwo_init(jfn, n, d, hw, seed=5)
    ts = tgwo.gwo_state_from_numpy(to_numpy(js), device="cpu")
    top = tgwo.stable_top3(ts.fit)
    assert torch.equal(ts.leaders, ts.pos[top])
    for _ in range(4):
        _, kr = jax.random.split(js.key)
        r = np.asarray(jax.random.uniform(kr, (2, 3, n, d), jnp.float32))
        ts = tgwo.gwo_state_from_numpy(to_numpy(js), device="cpu")
        want = jgwo.gwo_step(js, jfn, half_width=hw, t_max=10)
        got = tgwo.gwo_step(ts, tfn, half_width=hw, t_max=10,
                            r=tt(r)[0])
        assert_state_close(got, want, name)
        js = want


def test_portable_init_and_run():
    fn, hw = tobj.get_objective("sphere")
    st = tgwo.gwo_init(fn, 256, 4, hw, seed=0, device="cpu")
    lf = st.leader_fit
    assert bool(lf[0] <= lf[1]) and bool(lf[1] <= lf[2])
    out = tgwo.gwo_run(st, fn, 60, half_width=hw, t_max=60)
    assert float(out.leader_fit[0]) < 1e-2
    with pytest.raises(ValueError, match="t_max"):
        tgwo.gwo_step(st, fn, t_max=0)


# --------------------------------------------------------------------------
# Kernel B8's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def pack_t(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))
    leaders = pos.T[np.argsort(fit, kind="stable")[:3]].copy()
    ra = rng.uniform(size=(3 * d, n)).astype(np.float32)
    rc = rng.uniform(size=(3 * d, n)).astype(np.float32)
    return float(hw), leaders, pos, ra, rc


@pytest.mark.parametrize("name,t0,t_max", [
    ("sphere", 42, 500), ("rastrigin", 0, 100), ("schwefel", 250, 100),
    ("zakharov", 7, 3), ("styblinski_tang", 99, 1000)])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, t0,
                                                             t_max):
    n, d = 256, 5
    hw, leaders, pos, ra, rc = pack_t(name, n, d, t0)
    want = jgf.fused_gwo_step_t(
        jnp.asarray([0, t0]), jnp.asarray(leaders), jnp.asarray(pos),
        jnp.asarray(ra), jnp.asarray(rc), objective_name=name,
        half_width=hw, t_max=t_max, tile_n=128, rng="host", interpret=True)
    got = tgf.fused_gwo_step_t(
        torch.tensor([0, t0], dtype=torch.int32), *tt(leaders, pos, ra, rc),
        objective_name=name, half_width=hw, t_max=t_max, rng="host")
    assert got[0].shape == (d, n) and got[1].shape == (1, n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)


def test_device_rng_block_equals_single_steps_with_its_uniforms():
    n, d, k = 130, 7, 5
    hw, leaders, pos, _, _ = pack_t("rastrigin", n, d, 1)
    kw = dict(objective_name="rastrigin", half_width=hw, t_max=20)
    scalars = torch.tensor([5, 9], dtype=torch.int32)
    block = tgf.fused_gwo_step_t(scalars, *tt(leaders, pos), rng="device",
                                 k_steps=k, step0=4, **kw)
    x = tt(pos)[0]
    for s in range(k):
        ua = tpf.philox_uniforms(scalars[:1], n, 3 * d, 4 + s, 0)
        uc = tpf.philox_uniforms(scalars[:1], n, 3 * d, 4 + s, 1)
        x, fit = tgf.fused_gwo_step_t(
            torch.tensor([5, 9 + s], dtype=torch.int32), tt(leaders)[0], x,
            ua, uc, rng="host", **kw)
    assert torch.equal(block[0], x) and torch.equal(block[1], fit)
    assert float(block[0].abs().max()) <= np.float32(hw)


def test_step_rejects_bad_arguments():
    hw, leaders, pos, ra, rc = pack_t("sphere", 16, 2, 0)
    args = (torch.tensor([0, 0], dtype=torch.int32), *tt(leaders, pos))
    with pytest.raises(ValueError, match="every draw"):
        tgf.fused_gwo_step_t(*args, objective_name="sphere", rng="host")
    with pytest.raises(ValueError, match="k_steps=1 only"):
        tgf.fused_gwo_step_t(*args, *tt(ra, rc), objective_name="sphere",
                             rng="host", k_steps=3)
    before = tgf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgf.fused_gwo_step_cuda(*args, objective_name="sphere")
    assert tgf.LAUNCHES == before
    assert tgf.gwo_pallas_supported("rastrigin", torch.float32, 908)
    assert not tgf.gwo_pallas_supported("rastrigin", torch.float32, 909)
    assert not tgf.gwo_pallas_supported("rastrigin", torch.float16)
    assert tgf.kernel_block(30) == 128 and tgf.kernel_block(228) == 64


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_uniforms(key, calls, n_pad, d):
    """What JAX's ``fused_gwo_run(rng="host")`` draws for each launch."""
    host_key = jax.random.fold_in(key, 0x6E0)
    return [tt(*jpf.host_uniforms(host_key, i, (3 * d, n_pad)))
            for i in range(calls)]


@pytest.mark.parametrize("name,n,seed", [("sphere", 200, 0),
                                         ("rastrigin", 256, 1)])
def test_fused_run_matches_jax_over_several_launches(name, n, seed):
    d, steps, tile_n = 4, 4, 128
    jfn, hw = jobj.get_objective(name)
    js = jgwo.gwo_init(jfn, n, d, hw, seed=seed)
    ts = tgwo.gwo_state_from_numpy(to_numpy(js), device="cpu")
    want = jgf.fused_gwo_run(js, name, steps, half_width=hw, t_max=10,
                             tile_n=tile_n, rng="host", interpret=True)
    got = tgf.fused_gwo_run(ts, name, steps, half_width=hw, t_max=10,
                            tile_n=tile_n, rng="host",
                            uniforms=jax_run_uniforms(js.key, steps, 256, d))
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, name)


def test_fused_run_converges_and_leaders_monotone():
    fn, hw = tobj.get_objective("sphere")
    st = tgwo.gwo_init(fn, 256, 4, hw, seed=0, device="cpu")
    prev = st.leader_fit.clone()
    s = st
    for _ in range(4):
        s = tgf.fused_gwo_run(s, "sphere", 25, half_width=hw, t_max=100)
        assert bool((s.leader_fit <= prev).all())
        prev = s.leader_fit.clone()
    lf = s.leader_fit.numpy()
    assert lf[0] <= lf[1] <= lf[2] and lf[0] < 1e-2
    np.testing.assert_allclose(fn(s.leaders).numpy(), lf, atol=1e-4)
    assert int(s.iteration) == 100


def test_fused_run_pads_non_tile_multiples():
    fn, hw = tobj.get_objective("sphere")
    st = tgwo.gwo_init(fn, 200, 3, hw, seed=1, device="cpu")
    out = tgf.fused_gwo_run(st, "sphere", 10, half_width=hw)
    assert out.pos.shape == (200, 3)
    assert float(out.leader_fit[0]) <= float(st.leader_fit[0])
    np.testing.assert_allclose(fn(out.pos).numpy(), out.fit.numpy(),
                               atol=1e-4)
    host = tgf.fused_gwo_run(st, "sphere", 3, half_width=hw, rng="host")
    assert int(host.iteration) == 3


def test_model_backend_switch_and_cli_defaults(monkeypatch):
    # On the card by default: without one the model raises unless the CPU
    # is asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.GWO("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.GWO("sphere", n=256, dim=4, seed=0, t_max=100,
                   use_pallas=True, device="cpu")
    opt.run(100)
    assert opt.best < 1e-2
    assert tdsa.GWO("sphere", n=16, dim=2, device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.GWO(tobj.sphere, n=16, dim=2, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.GWO("sphere", n=16, dim=2, t_max=0, device="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "distributed_swarm_algorithm_tpu_torch",
         "gwo", "--device", "cpu", "--objective", "sphere", "--n", "64",
         "--dim", "3", "--steps", "20"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    import json
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["wolves"] == 64 and rec["path"] == "portable"
    assert rec["backend"] == "torch-cpu" and rec["best"] < 1.0
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda.gwo_fused"
            " as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
