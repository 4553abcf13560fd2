"""The port's differential evolution (``ops/de.py``, kernel B10's plain
version in ``ops/cuda/de_fused.py``, the ``DE`` model) against the JAX
package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (the donor indices of ``_distinct3``, the
crossover uniforms and ``j_rand`` from JAX's key chain), the TPU kernel in
interpret mode with host-supplied uniforms (``rng="host"``,
``interpret=True``, as ``tests/test_pallas_de.py`` runs it) against the
port's plain version, and whole fused runs over several launches with JAX's
own tile and lane shifts.  The donors come from other tiles, rolled within
them, so the cases hold at least 4 tiles (``tile_n=128``) and shifts that
wrap.  A launch of k steps (which JAX draws on the TPU only) is held to a
numpy reference of the same semantics with ``np.roll``.

Tolerances, each with its reason:

- positions ``rtol = atol = 1e-5``: XLA on the CPU fuses the mutant's
  ``a + F (b - c)`` into one multiply-add, the port rounds twice;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- the acceptance masks (``f(trial) <= f(x)``) and the donor indices are
  discrete and exact.
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
from distributed_swarm_algorithm_tpu.ops import de as jde
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import de_fused as jdf
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu_torch.ops import de as tde
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import de_fused as tdf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = tde.DE_TENSOR_FIELDS


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


def test_lane_shifts_are_shared_and_the_jax_packages():
    from distributed_swarm_algorithm_tpu_torch.ops.cuda import woa_fused
    assert family.LANE_SHIFTS == jdf._LANE_SHIFTS
    assert woa_fused.LANE_SHIFTS is family.LANE_SHIFTS


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 5, 64, 257])
def test_distinct3_all_distinct(n):
    g = torch.Generator().manual_seed(n)
    for _ in range(5):
        a, b, c = (x.numpy() for x in tde.distinct3(g, n, "cpu"))
        i = np.arange(n)
        for x in (a, b, c):
            assert ((x >= 0) & (x < n)).all()
        assert ((a != i) & (b != i) & (c != i) & (a != b) & (a != c)
                & (b != c)).all()


def jax_step_draws(js):
    n, d = js.pos.shape
    _, k_idx, k_cr, k_jr = jax.random.split(js.key, 4)
    a, b, c = jde._distinct3(k_idx, n)
    r = jax.random.uniform(k_cr, (n, d), js.pos.dtype)
    j_rand = jax.random.randint(k_jr, (n,), 0, d)
    return tt(a, b, c, r, j_rand)


@pytest.mark.parametrize("name,variant", [
    ("sphere", "rand1bin"), ("rastrigin", "rand1bin"),
    ("ackley", "best1bin"), ("griewank", "best1bin")])
def test_portable_step_matches_jax(name, variant):
    n, d = 64, 5
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jde.de_init(jfn, n, d, hw, seed=4)
    for _ in range(4):
        draws = jax_step_draws(js)
        ts = tde.de_state_from_numpy(to_numpy(js), device="cpu")
        want = jde.de_step(js, jfn, half_width=hw, variant=variant)
        got = tde.de_step(ts, tfn, half_width=hw, variant=variant,
                          draws=draws)
        assert_state_close(got, want, name)
        # The acceptances: where a row changed, both changed it.
        np.testing.assert_array_equal(
            (got.pos != ts.pos).any(1).numpy(),
            np.asarray((want.pos != js.pos).any(1)))
        js = want


def test_portable_run_converges_and_checks():
    fn, hw = tobj.get_objective("sphere")
    st = tde.de_init(fn, 64, 5, hw, seed=0, device="cpu")
    prev = float(st.best_fit)
    s = st
    for _ in range(4):
        s = tde.de_run(s, fn, 50, half_width=hw)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
        assert float(s.best_fit) <= float(s.fit.min()) + 1e-6
    assert prev < 1e-4 and int(s.iteration) == 200
    assert bool((s.pos.abs() <= hw).all())
    np.testing.assert_allclose(s.fit.numpy(), fn(s.pos).numpy())
    best = tde.de_run(st, fn, 100, half_width=hw, variant="best1bin")
    assert float(best.best_fit) < 1e-2
    with pytest.raises(ValueError, match="variant"):
        tde.de_step(st, fn, variant="nope")
    with pytest.raises(ValueError, match="at least 4"):
        tde.de_init(fn, 3, 2, hw, device="cpu")


# --------------------------------------------------------------------------
# Kernel B10's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def pop_t(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    r = rng.uniform(size=(d, n)).astype(np.float32)
    return float(hw), pos, fit, r


def de_block_oracle(pos, fit, draws_of, objective, hw, f, cr, tile_n,
                    tshifts, lshifts, k):
    """A numpy reference of one k-step launch: donor k of lane j in tile i
    is lane (j - s) mod tile_n of tile (i + tshift_k) mod n_tiles of the
    launch's input, s = lshift_k + LANE_SHIFTS[step % 8][k] (np.roll's
    direction).  Returns the positions and the acceptance masks."""
    d, n = pos.shape
    n_tiles = n // tile_n
    tiles = pos.reshape(d, n_tiles, tile_n)
    src = [tiles[:, (np.arange(n_tiles) + t) % n_tiles, :] for t in tshifts]
    x, fx = pos.copy(), fit.copy()
    masks = []
    for s in range(k):
        sched = family.LANE_SHIFTS[s % 8]
        a, b, c = (np.roll(src[j], lshifts[j] + sched[j], axis=2)
                   .reshape(d, n) for j in range(3))
        mutant = np.clip(a + np.float32(f) * (b - c), -hw, hw)
        trial = np.where(draws_of(s) < np.float32(cr), mutant,
                         x).astype(np.float32)
        tfit = objective(trial)
        better = tfit <= fx
        x = np.where(better, trial, x)
        fx = np.where(better, tfit, fx)
        masks.append(better)
    return x, fx, masks


@pytest.mark.parametrize("name,n,tile_n,shifts", [
    ("sphere", 512, 128, (1, 2, 3, 0, 0, 0)),
    ("rastrigin", 512, 128, (3, 1, 2, 100, 5, 127)),
    ("griewank", 640, 128, (4, 2, 1, 250, 1, 37)),
    ("schwefel", 1024, 256, (1, 3, 2, 7, 300, 9))])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             shifts):
    d = 5
    hw, pos, fit, r = pop_t(name, n, d, n + shifts[3])
    want = jdf.fused_de_step_t(
        jnp.asarray([0, *shifts]), jnp.asarray(pos), jnp.asarray(fit),
        jnp.asarray(r), objective_name=name, half_width=hw, tile_n=tile_n,
        rng="host", interpret=True)
    got = tdf.fused_de_step_t(
        torch.tensor([0, *shifts], dtype=torch.int32), *tt(pos, fit, r),
        objective_name=name, half_width=hw, tile_n=tile_n, rng="host")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    # The acceptances and the donors each lane reads, with jnp.roll's
    # direction: the np.roll reference agrees, the other direction not.
    objective = lambda x: tpf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(x)).numpy()
    ref, _, masks = de_block_oracle(pos, fit, lambda s: r, objective, hw,
                                    tdf.F, tdf.CR, tile_n, shifts[:3],
                                    shifts[3:], 1)
    assert masks[0].any() and not masks[0].all()
    np.testing.assert_array_equal(
        (got[0].numpy() != pos).any(0), (np.asarray(want[0]) != pos).any(0))
    np.testing.assert_allclose(got[0].numpy(), ref, **TOL)
    other, _, _ = de_block_oracle(pos, fit, lambda s: r, objective, hw,
                                  tdf.F, tdf.CR, tile_n,
                                  [-t for t in shifts[:3]],
                                  [-s - 2 for s in shifts[3:]], 1)
    assert not np.allclose(other, ref, **TOL)


@pytest.mark.parametrize("n,tile_n,k,shifts", [
    (512, 128, 8, (3, 2, 1, 126, 40, 0)), (640, 128, 11, (1, 4, 2, 0, 9, 60)),
    (1024, 256, 32, (2, 3, 1, 300, 7, 255))])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, shifts):
    d = 6
    hw, pos, fit, _ = pop_t("rastrigin", n, d, k)
    scalars = torch.tensor([21, *shifts], dtype=torch.int32)
    got = tdf.fused_de_step_t(scalars, *tt(pos, fit),
                              objective_name="rastrigin", half_width=hw,
                              tile_n=tile_n, rng="device", k_steps=k,
                              step0=6)
    objective = lambda x: tpf.OBJECTIVES_T["rastrigin"](  # noqa: E731
        torch.from_numpy(x)).numpy()
    ref, ref_fit, masks = de_block_oracle(
        pos, fit, lambda s: tpf.philox_uniforms(scalars[:1], n, d, 6 + s,
                                                0).numpy(),
        objective, hw, tdf.F, tdf.CR, tile_n, shifts[:3], shifts[3:], k)
    assert any(m.any() for m in masks)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), ref_fit, **OBJ_TOL)
    assert bool((got[1] <= torch.from_numpy(fit)).all())


def test_step_rejects_bad_arguments():
    hw, pos, fit, r = pop_t("sphere", 512, 2, 0)
    args = (torch.zeros(7, dtype=torch.int32), *tt(pos, fit))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tdf.fused_de_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        tdf.fused_de_step_t(*args, objective_name="sphere", tile_n=100)
    before = tdf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdf.fused_de_step_cuda(*args, **kw)
    assert tdf.LAUNCHES == before
    assert tdf.de_pallas_supported("rastrigin", torch.float32, 908)
    assert not tdf.de_pallas_supported("rastrigin", torch.float32, 909)
    assert not tdf.de_pallas_supported("rastrigin", torch.float64, 8)
    assert tdf.kernel_block(30) == 128 and tdf.kernel_block(500) == 32


# --------------------------------------------------------------------------
# Tiling and the tile shifts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,tile_n", [(1000, 4096), (700, 4096),
                                      (512, 128), (5000, 1024), (3000, 384)])
def test_shrink_tile_for_donors_is_the_jax_packages(n, tile_n):
    assert family.shrink_tile_for_donors(n, tile_n) == \
        jdf.shrink_tile_for_donors(n, tile_n)


def test_tiny_population_rejected():
    with pytest.raises(ValueError, match="rotational"):
        family.shrink_tile_for_donors(300, 128)
    fn, hw = tobj.get_objective("sphere")
    st = tde.de_init(fn, 64, 5, hw, seed=2, device="cpu")
    with pytest.raises(ValueError, match="rotational"):
        tdf.fused_de_run(st, "sphere", 5, half_width=hw)


@pytest.mark.parametrize("n_tiles", [4, 5, 8, 256])
def test_distinct_tile_shifts(n_tiles):
    g = torch.Generator().manual_seed(n_tiles)
    seen = set()
    for _ in range(40):
        s = family.distinct_tile_shifts(g, n_tiles, "cpu")
        vals = set(s.tolist())
        assert s.dtype == torch.int32 and len(vals) == 3
        assert all(1 <= v < n_tiles for v in vals)
        seen |= vals
    if n_tiles <= 8:
        assert seen == set(range(1, n_tiles))


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_inputs(key, calls, n_pad, d, tile_n):
    """What JAX's ``fused_de_run(rng="host")`` draws for each launch: the
    crossover uniforms and the six shifts."""
    host_key = jax.random.fold_in(key, 0xDE)
    shift_key = jax.random.fold_in(key, 0x5F1F7)
    n_tiles = n_pad // tile_n
    uniforms, shifts = [], []
    for i in range(calls):
        uniforms.append(tt(jpf.host_uniforms(host_key, i, (d, n_pad))[0])[0])
        kk = jax.random.fold_in(shift_key, i)
        sa, sb, sc = jdf._distinct_tile_shifts(kk, n_tiles)
        lanes = jax.random.randint(jax.random.fold_in(kk, 1), (3,), 0,
                                   tile_n)
        shifts.append([int(sa), int(sb), int(sc), *map(int, lanes)])
    return uniforms, torch.tensor(shifts, dtype=torch.int32)


@pytest.mark.parametrize("name,n,tile_n", [("sphere", 700, 128),
                                           ("rastrigin", 1000, None)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n):
    d, steps = 4, 4
    jfn, hw = jobj.get_objective(name)
    js = jde.de_init(jfn, n, d, hw, seed=n)
    ts = tde.de_state_from_numpy(to_numpy(js), device="cpu")
    tile, _ = family.lane_tiling(n, tile_n, d)
    tile, n_pad, n_tiles = family.shrink_tile_for_donors(n, tile)
    assert n_tiles >= 4
    uniforms, shifts = jax_run_inputs(js.key, steps, n_pad, d, tile)
    want = jdf.fused_de_run(js, name, steps, half_width=hw, tile_n=tile_n,
                            rng="host", interpret=True)
    got = tdf.fused_de_run(ts, name, steps, half_width=hw, tile_n=tile_n,
                           rng="host", uniforms=uniforms, shifts=shifts)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, name)


def test_fused_run_converges_monotone_and_pads():
    # The JAX package's case: one step a launch, 150 generations.
    fn, hw = tobj.get_objective("sphere")
    st = tde.de_init(fn, 1000, 6, hw, seed=0, device="cpu")  # not aligned
    out = tdf.fused_de_run(st, "sphere", 150, half_width=hw, rng="host")
    assert out.pos.shape == (1000, 6) and int(out.iteration) == 150
    assert float(out.best_fit) < 1e-4
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    # Launches of 8 steps (block-start donors mix slower): monotone.
    prev = float(st.best_fit)
    s = st
    for _ in range(3):
        s = tdf.fused_de_run(s, "sphere", 40, half_width=hw)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
    assert prev < 1e-2
    # Deterministic: the same state and generator give the same run.
    runs = [tdf.fused_de_run(tde.de_state_from_numpy(
        tde.de_state_to_numpy(st), device="cpu", seed=5), "sphere", 12,
        half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)


def test_model_backend_switch(monkeypatch):
    # On the card by default: without one the model raises unless the CPU
    # is asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.DE("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.DE("sphere", n=1024, dim=4, seed=0, use_pallas=True,
                  device="cpu")
    opt.run(60)
    assert opt.best < 1e-3
    assert tdsa.DE("sphere", n=256, dim=2, device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.DE("sphere", n=64, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.DE(tobj.sphere, n=1024, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.DE("sphere", n=1024, dim=4, variant="best1bin",
                use_pallas=True, device="cpu")
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda.de_fused"
            " as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_swarm_algorithm_tpu_torch", "de",
         "--device", "cpu", "--objective", "sphere", "--n", "600", "--dim",
         "4", "--steps", "20"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    import json
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["path"] == "portable" and rec["variant"] == "rand1bin"
    assert rec["population"] == 600 and rec["backend"] == "torch-cpu"
