"""The port's SHADE (``ops/shade.py``, kernel B14's plain version and the
SHADE-R driver in ``ops/cuda/shade_fused.py``, the ``SHADE`` model) against
the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step with all nine draws of JAX's key split (F
and CR, the pbest pick, both donors, the crossover, ``j_rand``, the archive
slots), the TPU kernel in interpret mode with host-supplied uniforms
(``rng="host"``, ``interpret=True``, as ``tests/test_pallas_shade.py`` runs
it) against the port's plain version, the elite pool of per-tile champions
under ties and signed zeros, and whole fused runs over several generations
with JAX's per-generation draws handed in through the ``draws=`` hook.

Tolerances, each with its reason:

- positions ``rtol = atol = 1e-5``: XLA on the CPU fuses ``m + s * z`` (F,
  CR) and the mutant's products and sums into multiply-adds; where the
  mutant cancels (terms up to ``4 hw``), an absolute band of a few ulps of
  the largest term, ``4e-6 hw``, as for the whale;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- the success memory ``rtol = 1e-5``: its sums run over N in another
  order, a few ulps a generation.  A CR that lands within those ulps of a
  crossover uniform flips that gene, so whole fused runs are compared over
  three generations;
- discrete results are exact: the acceptance and success masks, the pbest
  pool, the archive's fill count and slot pointer, the elite columns.
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
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops import shade as jsh
from distributed_swarm_algorithm_tpu.ops.pallas import shade_fused as jsf
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import shade as tsh
from distributed_swarm_algorithm_tpu_torch.ops._numerics import top_k
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import shade_fused as tsf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def pos_tol(hw):
    return dict(rtol=1e-5, atol=max(1e-5, 4e-6 * hw))


FIELDS = tsh.SHADE_TENSOR_FIELDS


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def assert_state_close(got, want, label):
    for f in ("pos", "archive", "best_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f"{label} {f}")
    for f in ("fit", "best_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **OBJ_TOL,
                                   err_msg=f"{label} {f}")
    for f in ("m_f", "m_cr"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{label} {f}")
    for f in ("mem_k", "archive_n", "iteration"):
        assert int(getattr(got, f)) == int(getattr(want, f)), (label, f)


# --------------------------------------------------------------------------
# lax.top_k's order
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "ties", "signed_zero", "inf",
                                  "float64"])
def test_top_k_is_lax_top_k(case):
    rng = np.random.default_rng(1)
    x = rng.normal(size=300).astype(np.float32)
    if case == "ties":
        x = rng.integers(0, 5, 300).astype(np.float32)
    elif case == "signed_zero":
        x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), 300)
    elif case == "inf":
        x[::7] = np.inf
        x[::11] = -np.inf
    elif case == "float64":
        x = rng.integers(0, 3, 300).astype(np.float64)
        x[::5] = -0.0
    for k in (1, 2, 3, 128, 300):
        for v in (x, -x):
            with jax.enable_x64(case == "float64"):
                _, want = jax.lax.top_k(jnp.asarray(v), k)
            np.testing.assert_array_equal(
                top_k(torch.from_numpy(v), k).numpy(), np.asarray(want),
                err_msg=f"{case} k={k}")


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_step_draws(js, p_best=jsh.P_BEST):
    n, d = js.pos.shape
    dt = js.pos.dtype
    (_, k_mem, k_f, k_cr, k_pb, k_r1, k_r2, k_cross, k_jr,
     k_slot) = jax.random.split(js.key, 10)
    n_top = max(2, int(round(p_best * n)))
    return tt(jax.random.randint(k_mem, (n,), 0, jsh.H),
              jax.random.cauchy(k_f, (n,), dt),
              jax.random.normal(k_cr, (n,), dt),
              jax.random.randint(k_pb, (n,), 0, n_top),
              jax.random.randint(k_r1, (n,), 0, n),
              jax.random.randint(k_r2, (n,), 0, n + js.archive_n),
              jax.random.uniform(k_cross, (n, d), dt),
              jax.random.randint(k_jr, (n,), 0, d),
              jax.random.randint(k_slot, (n,), 0, n))


@pytest.mark.parametrize("name,n,d,steps,p_best", [
    ("sphere", 64, 5, 4, jsh.P_BEST), ("rastrigin", 48, 4, 4, 0.2),
    ("ackley", 16, 3, 12, jsh.P_BEST)])
def test_portable_step_matches_jax(name, n, d, steps, p_best):
    # 16 x 12 fills the archive and then replaces random slots, some twice
    # in one generation.
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jsh.shade_init(jfn, n, d, hw, seed=n)
    for i in range(steps):
        draws = jax_step_draws(js, p_best)
        ts = tsh.shade_state_from_numpy(to_numpy(js), device="cpu")
        want = jsh.shade_step(js, jfn, half_width=hw, p_best=p_best)
        got = tsh.shade_step(ts, tfn, half_width=hw, p_best=p_best,
                             draws=draws)
        assert_state_close(got, want, f"{name} step {i}")
        np.testing.assert_array_equal(
            (got.pos != ts.pos).any(1).numpy(),
            np.asarray((want.pos != js.pos).any(1)))
        js = want
    assert int(js.archive_n) > 0


def test_last_write_scatter_keeps_the_later_row():
    dst = torch.zeros(4, 2)
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    slots = torch.tensor([1, 4, 1, 3, 7, 3])
    out = tsh.last_write_scatter(dst, slots, rows)
    want = np.asarray(jnp.zeros((4, 2)).at[jnp.asarray(slots.numpy())].set(
        jnp.asarray(rows.numpy()), mode="drop"))
    np.testing.assert_array_equal(out.numpy(), want)


def test_portable_shade_converges_and_adapts():
    fn, hw = tobj.get_objective("sphere")
    st = tsh.shade_init(fn, 64, 5, hw, seed=0, device="cpu")
    out = tsh.shade_run(st, fn, 150, half_width=hw)
    assert float(out.best_fit) < 1e-3
    assert int(out.archive_n) > 0
    assert not torch.equal(out.m_f, st.m_f)
    assert bool((out.pos.abs() <= hw).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    with pytest.raises(ValueError, match="at least 5"):
        tsh.shade_init(fn, 4, 2, hw, device="cpu")


# --------------------------------------------------------------------------
# Kernel B14's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def shade_inputs(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    arch = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    elite = rng.uniform(-hw, hw, (d, 128)).astype(np.float32)
    return (float(hw), pos, fit, 0.01 + 0.99 * u(1, n), u(1, n), arch,
            elite, u(d, n), u(1, n))


@pytest.mark.parametrize("name,n,tile_n,scalars", [
    ("sphere", 512, 128, (1, 2, 3, 0, 0, 0, 0, 32768)),
    ("rastrigin", 512, 128, (3, 1, 2, 100, 5, 127, 77, 32768)),
    ("griewank", 768, 256, (4, 2, 1, 250, 1, 37, 127, 16384)),
    ("schwefel", 640, 128, (1, 1, 4, 7, 300, 9, 3, 65536))])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n,
                                                             tile_n,
                                                             scalars):
    d = 5
    hw, *arrays = shade_inputs(name, n, d, n + scalars[3])
    want = jsf.fused_shade_step_t(
        jnp.asarray([0, *scalars]), *(jnp.asarray(a) for a in arrays),
        objective_name=name, half_width=hw, tile_n=tile_n, rng="host",
        interpret=True)
    got = tsf.fused_shade_step_t(
        torch.tensor([0, *scalars], dtype=torch.int32), *tt(*arrays),
        objective_name=name, half_width=hw, tile_n=tile_n, rng="host")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **pos_tol(hw))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    moved = (got[0].numpy() != arrays[0]).any(0)
    np.testing.assert_array_equal(
        moved, (np.asarray(want[0]) != arrays[0]).any(0))
    assert moved.any() and not moved.all()


def shade_oracle(pos, fit, f_row, cr_row, arch, elite, r_cross, r_src,
                 objective, hw, tile_n, s):
    """A numpy reference of one generation with np.roll's direction."""
    d, n = pos.shape
    n_tiles = n // tile_n

    def roll(x, t, l):
        tiles = x.reshape(d, n_tiles, tile_n)[:, (np.arange(n_tiles) + t)
                                              % n_tiles, :]
        return np.roll(tiles, l, axis=2).reshape(d, n)

    r1 = roll(pos, s[0], s[3])
    r2 = np.where(r_src < np.float32(s[7] / 65536), roll(arch, s[2], s[5]),
                  roll(pos, s[1], s[4]))
    pb = np.tile(np.roll(elite, s[6], axis=1), (1, n // 128))
    mutant = np.clip(pos + f_row * (pb - pos) + f_row * (r1 - r2), -hw, hw)
    trial = np.where(r_cross < cr_row, mutant, pos).astype(np.float32)
    tfit = objective(trial)
    return np.where(tfit <= fit, trial, pos)


@pytest.mark.parametrize("rng_mode", ["host", "device"])
def test_plain_step_matches_the_np_roll_reference(rng_mode):
    name, n, tile_n, d = "rastrigin", 512, 128, 4
    s = (3, 1, 2, 100, 5, 127, 77, 40000)
    hw, pos, fit, f_row, cr_row, arch, elite, r_cross, r_src = \
        shade_inputs(name, n, d, 9)
    scalars = torch.tensor([5, *s], dtype=torch.int32)
    draws = (r_cross, r_src) if rng_mode == "host" else ()
    got = tsf.fused_shade_step_t(
        scalars, *tt(pos, fit, f_row, cr_row, arch, elite, *draws),
        objective_name=name, half_width=hw, tile_n=tile_n, rng=rng_mode,
        step=3)
    if rng_mode == "device":
        r_cross = tsf.philox_uniforms(scalars[:1], n, d, 3, 0).numpy()
        r_src = tsf.philox_uniforms(scalars[:1], n, 1, 3, 1).numpy()
    objective = lambda x: tsf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(x)).numpy()
    ref = shade_oracle(pos, fit, f_row, cr_row, arch, elite, r_cross,
                       r_src, objective, hw, tile_n, s)
    np.testing.assert_allclose(got[0].numpy(), ref, **TOL)
    other = shade_oracle(pos, fit, f_row, cr_row, arch, elite, r_cross,
                         r_src, objective, hw, tile_n,
                         tuple(-v - 1 for v in s[:7]) + (s[7],))
    assert not np.allclose(other, ref, **TOL)


@pytest.mark.parametrize("case", ["random", "ties", "signed_zero",
                                  "few_tiles"])
def test_tile_champion_elite_is_the_jax_packages(case):
    rng = np.random.default_rng(2)
    d, tile_n = 3, 128
    n_tiles = 6 if case == "few_tiles" else 200
    n = n_tiles * tile_n
    fit = rng.normal(size=n).astype(np.float32)
    if case == "ties":
        fit = rng.integers(0, 3, n).astype(np.float32)
    elif case == "signed_zero":
        # Every tile's champion is a zero of either sign, at several lanes:
        # jnp.argmin takes the first, lax.top_k(-fit) ranks -(+0) below
        # -(-0).
        fit = np.abs(fit) + 1.0
        for t in range(n_tiles):
            lanes = rng.choice(tile_n, 3, replace=False)
            fit[t * tile_n + lanes] = rng.choice(
                np.array([0.0, -0.0], np.float32), 3)
    pos = rng.normal(size=(d, n)).astype(np.float32)
    pos[:, ::5] = -0.0
    want = np.asarray(jsf._tile_champion_elite(
        jnp.asarray(pos), jnp.asarray(fit), n_tiles, tile_n))
    got = tsf.tile_champion_elite(*tt(pos, fit), n_tiles, tile_n).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_step_rejects_bad_arguments():
    hw, *arrays = shade_inputs("sphere", 512, 2, 0)
    args = (torch.zeros(9, dtype=torch.int32), *tt(*arrays[:6]))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tsf.fused_shade_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="multiple"):
        tsf.fused_shade_step_t(*args, objective_name="sphere", tile_n=64)
    before = tsf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsf.fused_shade_step_cuda(*args, **kw)
    assert tsf.LAUNCHES == before
    assert tsf.shade_pallas_supported("rastrigin", torch.float32, 363)
    assert not tsf.shade_pallas_supported("rastrigin", torch.float32, 364)
    # Blocks of 128 lanes while the x and trial tiles fit, then 64.
    assert tsf.kernel_block(30) == 128 and tsf.kernel_block(350) == 64
    assert tsf.kernel_block(364) == 0


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_draws(key, steps, n_pad, d, tile_n):
    """What JAX's ``fused_shade_run(rng="host")`` draws per generation, in
    the port's ``SHADEGenDraws`` order."""
    base_key = jax.random.fold_in(key, 0x5AADE)
    n_tiles = n_pad // tile_n
    out = []
    for g in range(steps):
        kk = jax.random.fold_in(base_key, g)
        (k_slot, k_f, k_cr, k_sh, k_ln, k_win, k_hc,
         k_hs) = jax.random.split(kk, 8)
        lanes = jax.random.randint(k_ln, (4,), 0, tile_n)
        lanes = lanes.at[3].set(jax.random.randint(k_hs, (), 0, 128))
        kc1, kc2 = jax.random.split(k_hc)
        out.append(tt(
            jax.random.randint(k_slot, (n_pad,), 0, jsh.H),
            jax.random.cauchy(k_f, (n_pad,), jnp.float32),
            jax.random.normal(k_cr, (n_pad,), jnp.float32),
            jax.random.randint(k_sh, (3,), 1, max(n_tiles, 2)),
            lanes,
            jax.random.randint(k_win, (), 0, n_pad // 128),
            jax.random.uniform(kc1, (d, n_pad), jnp.float32),
            jax.random.uniform(kc2, (1, n_pad), jnp.float32)))
    return out


@pytest.mark.parametrize("name,n,tile_n,portable_steps", [
    ("sphere", 700, 128, 0), ("rastrigin", 1024, None, 1)])
def test_fused_run_matches_jax_over_several_generations(name, n, tile_n,
                                                        portable_steps):
    # D = 30, where no lane fails to cross every gene: such a lane compares
    # f(x) with its stored fitness, and a last bit of the objective (which
    # XLA rounds its own way for each shape) would decide its success.
    d, steps = 30, 3
    jfn, hw = jobj.get_objective(name)
    js = jsh.shade_init(jfn, n, d, hw, seed=n)
    # A partly filled archive: rows past archive_n alias the population.
    js = jsh.shade_run(js, jfn, portable_steps, half_width=hw)
    assert portable_steps == 0 or 0 < int(js.archive_n) < n
    ts = tsh.shade_state_from_numpy(to_numpy(js), device="cpu")
    tile, _ = family.lane_tiling(n, tile_n, d)
    tile, n_pad, _ = family.shrink_tile_for_donors(n, tile)
    draws = jax_run_draws(js.key, steps, n_pad, d, tile)
    want = jsf.fused_shade_run(js, name, steps, half_width=hw,
                               tile_n=tile_n, rng="host", interpret=True)
    got = tsf.fused_shade_run(ts, name, steps, half_width=hw, tile_n=tile_n,
                              rng="host", draws=draws)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, name)


def test_fused_run_converges_adapts_and_is_deterministic():
    fn, hw = tobj.get_objective("sphere")
    st = tsh.shade_init(fn, 1000, 6, hw, seed=0, device="cpu")
    out = tsf.fused_shade_run(st, "sphere", 150, half_width=hw)
    assert out.pos.shape == (1000, 6) and int(out.iteration) == 150
    assert float(out.best_fit) < 1e-3
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    assert int(out.archive_n) == 1000 and not torch.equal(out.m_f, st.m_f)
    prev, s = float(st.best_fit), st
    for _ in range(3):
        s = tsf.fused_shade_run(s, "sphere", 10, half_width=hw)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
    runs = [tsf.fused_shade_run(tsh.shade_state_from_numpy(
        tsh.shade_state_to_numpy(st), device="cpu", seed=4), "sphere", 6,
        half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    small = tsh.shade_init(fn, 64, 5, hw, seed=2, device="cpu")
    with pytest.raises(ValueError, match="rotational"):
        tsf.fused_shade_run(small, "sphere", 5, half_width=hw)


def test_model_backend_switch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.SHADE("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.SHADE("sphere", n=1024, dim=4, seed=0, use_pallas=True,
                     device="cpu")
    opt.run(60)
    assert opt.best < 1e-2
    assert tdsa.SHADE("sphere", n=256, dim=2,
                      device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.SHADE("sphere", n=64, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.SHADE("sphere", n=1024, dim=4, p_best=0.2, use_pallas=True,
                   device="cpu")
    with pytest.raises(ValueError, match="p_best"):
        tdsa.SHADE("sphere", n=64, dim=4, p_best=0.0, device="cpu")
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda."
            "shade_fused as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
