"""The port's genetic algorithm (``ops/nsga2.py``'s variation operators,
``ops/ga.py``, kernel B15's plain version in ``ops/cuda/ga_fused.py``, the
``GA`` model) against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (the tournaments' index pairs, SBX's and the
mutation's uniforms from JAX's key chain), the TPU kernel in interpret mode
with host-supplied uniforms (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_ga.py`` runs it) against the port's plain version, and
whole fused runs over several launches with JAX's own tile and lane
shifts.  A launch of k generations (which JAX draws on the TPU only) is
held to a numpy reference of the same semantics: ``np.roll`` over the
tile's current generation for parent A, over the block-start tiles for
parent B, and the per-tile elitism at every generation.

Tolerances, each with its reason:

- positions ``rtol = 1e-5``, ``atol = max(1e-5, 4e-6 hw)``: XLA on the CPU
  contracts the Horner steps of the bit-field ``log2`` and ``2^x``
  polynomials and SBX's blend into multiply-adds (``pow`` in the portable
  step is each library's own), a few ulps of the largest term;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- the polynomials themselves against JAX's: ``log2`` within 2 ulps of its
  value plus 4 ulps of the polynomial's largest term (6.07), ``2e-6``;
  the powers within ``5e-7`` relative;
- discrete results are exact: the tournament winners (parents equal up to
  the band), the replaced lane of each tile and its elite, bit for bit
  (its ``-0`` made ``+0``).
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
from distributed_swarm_algorithm_tpu.ops import ga as jga
from distributed_swarm_algorithm_tpu.ops import nsga2 as jnsga2
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import cuckoo_fused as jcf
from distributed_swarm_algorithm_tpu.ops.pallas import ga_fused as jgf
from distributed_swarm_algorithm_tpu_torch.ops import ga as tga
from distributed_swarm_algorithm_tpu_torch.ops import nsga2 as tnsga2
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import ga_fused as tgf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = tga.GA_TENSOR_FIELDS


def pos_tol(hw):
    return dict(rtol=1e-5, atol=max(1e-5, 4e-6 * hw))


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def assert_state_close(got, want, hw, label):
    for f in ("pos", "best_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   **pos_tol(hw), err_msg=f"{label} {f}")
    for f in ("fit", "best_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **OBJ_TOL,
                                   err_msg=f"{label} {f}")
    assert int(got.iteration) == int(want.iteration)


def test_constants_are_the_jax_packages():
    assert (tnsga2.ETA_C, tnsga2.ETA_M, tnsga2.P_CROSS) == (
        jnsga2.ETA_C, jnsga2.ETA_M, jnsga2.P_CROSS)
    assert tga.N_ELITE == jga.N_ELITE
    assert tgf.LOG2_C == jcf._LOG2_C


@pytest.mark.parametrize("lo,hi", [(1e-12, 1e-6), (1e-6, 1.0), (0.5, 2.0),
                                   (1.0, 1e6)])
def test_fast_log2_and_pow_match_the_jax_polynomials(lo, hi):
    # The JAX helpers bitcast with Mosaic: run them in a kernel, interpreted.
    from jax.experimental import pallas as pl

    def in_kernel(fn, x):
        def kernel(x_ref, o_ref):
            o_ref[...] = fn(x_ref[...])
        return np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            interpret=True)(jnp.asarray(x)))

    x = np.geomspace(lo, hi, 4096).astype(np.float32).reshape(8, 512)
    got = tgf.log2_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, in_kernel(jcf._log2_fast, x),
                               rtol=2.5e-7, atol=2e-6)
    assert np.abs(got - np.log2(x)).max() < 2e-5
    for inv in (1 / 16, 1 / 21):
        got = tgf.pow_fast(torch.from_numpy(x), inv).numpy()
        want = in_kernel(lambda v: jgf._pow_fast(v, inv), x)
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-6)


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_step_draws(js):
    n, d = js.pos.shape
    half = (n + 1) // 2
    dt = js.pos.dtype
    _, kt1, kt2, kx, km = jax.random.split(js.key, 5)
    ku, kdo = jax.random.split(kx)
    mu, mdo = jax.random.split(km)
    return (tt(jax.random.randint(kt1, (2, half), 0, n))[0],
            tt(jax.random.randint(kt2, (2, half), 0, n))[0],
            tt(jax.random.uniform(ku, (half, d), dt),
               jax.random.uniform(kdo, (half, 1), dt)),
            tt(jax.random.uniform(mu, (n, d), dt),
               jax.random.uniform(mdo, (n, d), dt)))


@pytest.mark.parametrize("name,n,d,n_elite", [
    ("sphere", 64, 5, 2), ("rastrigin", 63, 4, 2), ("ackley", 32, 6, 0),
    ("griewank", 48, 3, 5)])
def test_portable_step_matches_jax(name, n, d, n_elite):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jga.ga_init(jfn, n, d, hw, seed=n)
    for _ in range(4):
        draws = jax_step_draws(js)
        ts = tga.ga_state_from_numpy(to_numpy(js), device="cpu")
        want = jga.ga_step(js, jfn, half_width=hw, n_elite=n_elite)
        got = tga.ga_step(ts, tfn, half_width=hw, n_elite=n_elite,
                          draws=draws)
        assert_state_close(got, want, hw, name)
        # The elites land in the same rows, bit for bit.
        for e in np.argsort(np.asarray(js.fit), kind="stable")[:n_elite]:
            row = np.asarray(js.pos)[e]
            np.testing.assert_array_equal(
                np.nonzero((got.pos.numpy() == row).all(1))[0],
                np.nonzero((np.asarray(want.pos) == row).all(1))[0])
        js = want


def test_portable_elitism_never_loses_the_best():
    fn, hw = tobj.get_objective("rastrigin")
    st = tga.ga_init(fn, 64, 5, hw, seed=1, device="cpu")
    prev = float(st.best_fit)
    for _ in range(30):
        st = tga.ga_step(st, fn, hw)
        cur = float(st.best_fit)
        assert cur <= prev + 1e-7
        assert float(st.fit.min()) <= prev + 1e-7
        prev = cur


def test_portable_converges_and_stays_in_domain():
    fn, hw = tobj.get_objective("sphere")
    opt = tdsa.GA("sphere", n=128, dim=4, seed=0, device="cpu")
    opt.run(300)
    assert opt.best < 1e-2
    st = tga.ga_run(tga.ga_init(fn, 48, 3, 2.0, seed=2, device="cpu"), fn,
                    50, half_width=2.0)
    assert float(st.pos.abs().max()) <= 2.0 + 1e-6
    np.testing.assert_allclose(fn(st.pos).numpy(), st.fit.numpy(),
                               atol=1e-5)
    a = tdsa.GA("rastrigin", n=32, dim=4, seed=7, device="cpu")
    b = tdsa.GA("rastrigin", n=32, dim=4, seed=7, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best == b.best
    with pytest.raises(ValueError):
        tdsa.GA("sphere", n=16, dim=2, n_elite=16, device="cpu")


# --------------------------------------------------------------------------
# Kernel B15's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def ga_inputs(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    pos[0] = -0.0             # every elite has a -0 coordinate
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return float(hw), pos, fit, [u(d, n), u(1, n), u(d, n), u(d, n)]


def elite_lanes(pos_in, fit_in, pos_out, tile_n):
    """Per tile, the lanes whose output is the tile's elite (its first
    least input fitness) bit for bit, -0 made +0: the replaced worst child,
    and any child that copied the elite."""
    d, n = pos_in.shape
    n_tiles = n // tile_n
    jb = fit_in[0].reshape(n_tiles, tile_n).argmin(1)
    lanes = []
    for t in range(n_tiles):
        elite = pos_in[:, t * tile_n + jb[t]] + np.float32(0.0)
        cols = pos_out[:, t * tile_n:(t + 1) * tile_n]
        same = (cols.view(np.int32) == elite.view(np.int32)[:, None]).all(0)
        lanes.append(tuple(np.nonzero(same)[0]))
    return lanes


@pytest.mark.parametrize("name,n,tile_n,shifts", [
    ("sphere", 512, 128, (1, 2, 0, 0, 0)),
    ("rastrigin", 512, 128, (3, 3, 100, 5, 127)),
    ("griewank", 640, 128, (4, 2, 250, 1, 37)),
    ("ackley", 1024, 256, (1, 3, 7, 300, 9))])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             shifts):
    d = 5
    hw, pos, fit, draws = ga_inputs(name, n, d, n + shifts[2])
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n,
              p_mut=0.2, rng="host")
    want = jgf.fused_ga_step_t(
        jnp.asarray([0, *shifts]), jnp.asarray(pos), jnp.asarray(fit),
        *(jnp.asarray(r) for r in draws), interpret=True, **kw)
    got = tgf.fused_ga_step_t(torch.tensor([0, *shifts], dtype=torch.int32),
                              *tt(pos, fit, *draws), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **pos_tol(hw))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    # Where each tile's elite went, exact.
    mine = elite_lanes(pos, fit, got[0].numpy(), tile_n)
    theirs = elite_lanes(pos, fit, np.asarray(want[0]), tile_n)
    assert mine == theirs and sum(map(len, mine)) >= 1


def ga_block_oracle(pos, fit, draws_of, name, hw, tile_n, s, k, p_mut):
    """A numpy reference of one k-generation launch: parent A from np.roll
    over each tile's current generation, parent B from np.roll over the
    block-start tiles (i + ts_a, i + ts_b), the variation through the
    port's polynomials, and the per-tile elitism.  Returns the positions,
    the fitness and, per generation, the replaced lane of each tile (or
    -1)."""
    d, n = pos.shape
    nt = n // tile_n
    c = tgf._constants(hw, tgf.ETA_C, tgf.ETA_M, tgf.P_CROSS, p_mut)
    obj = lambda x: tgf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x))).numpy()
    powf = lambda x, e: tgf.pow_fast(  # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x, np.float32)), e).numpy()

    def tiles(x, shift=0):
        t = x.reshape(x.shape[0], nt, tile_n)
        return t[:, (np.arange(nt) + shift) % nt, :]

    def roll(t, lane_shift):
        return np.roll(t, lane_shift, axis=2).reshape(t.shape[0], n)

    snap = [(tiles(pos, s[j]), tiles(fit, s[j])) for j in (0, 1)]
    x, fx = pos.copy(), fit.copy()
    replaced = []
    for step in range(k):
        la, lc, le = family.LANE_SHIFTS[step % 8]
        o1, f1 = roll(tiles(x), s[2] + la), roll(tiles(fx), s[2] + la)
        o2, f2 = roll(tiles(x), s[3] + lc), roll(tiles(fx), s[3] + lc)
        pa = np.where(f1 <= f2, o1, o2)
        b1, g1 = (roll(t, s[4] + le) for t in snap[0])
        b2, g2 = (roll(t, s[2] + le) for t in snap[1])
        pb = np.where(g1 <= g2, b1, b2)
        u, uc, um, ud = draws_of(step)
        beta = np.where(u <= 0.5, powf(2.0 * u + np.float32(1e-12),
                                       c["inv_c"]),
                        powf(np.float32(1.0) / (2.0 * (1.0 - u)
                                                + np.float32(1e-12)),
                             c["inv_c"]))
        c1 = 0.5 * ((1.0 + beta) * pa + (1.0 - beta) * pb)
        c2 = 0.5 * ((1.0 - beta) * pa + (1.0 + beta) * pb)
        child = np.where(uc < np.float32(c["cross_lo"]), c1,
                         np.where(uc < np.float32(c["cross_hi"]), c2, pa))
        delta = np.where(um < 0.5, powf(2.0 * um + np.float32(1e-12),
                                        c["inv_m"]) - 1.0,
                         1.0 - powf(2.0 * (1.0 - um) + np.float32(1e-12),
                                    c["inv_m"]))
        child = child + np.where(ud < np.float32(c["p_mut"]),
                                 delta * np.float32(c["width"]), 0.0)
        child = np.clip(child, -hw, hw).astype(np.float32)
        cf = obj(child)
        lanes = []
        for t in range(nt):
            sl = slice(t * tile_n, (t + 1) * tile_n)
            jb, jw = fx[0, sl].argmin(), cf[0, sl].argmax()
            if fx[0, sl][jb] < cf[0, sl][jw]:
                child[:, t * tile_n + jw] = x[:, t * tile_n + jb] + 0.0
                cf[0, t * tile_n + jw] = fx[0, sl][jb]
                lanes.append(int(jw))
            else:
                lanes.append(-1)
        replaced.append(lanes)
        x, fx = child, cf
    return x, fx, replaced


@pytest.mark.parametrize("n,tile_n,k,shifts", [
    (512, 128, 8, (3, 2, 126, 40, 0)), (640, 128, 5, (1, 4, 0, 9, 60)),
    (1024, 256, 8, (2, 2, 300, 7, 255)), (512, 128, 1, (1, 3, 5, 6, 7))])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, shifts):
    d, name = 6, "rastrigin"
    hw, pos, fit, _ = ga_inputs(name, n, d, k)
    scalars = torch.tensor([21, *shifts], dtype=torch.int32)
    got = tgf.fused_ga_step_t(scalars, *tt(pos, fit), objective_name=name,
                              half_width=hw, tile_n=tile_n, rng="device",
                              k_steps=k, step0=6, p_mut=0.3)

    def draws_of(s):
        u, um, ud = (tgf.philox_uniforms(scalars[:1], n, d, 6 + s,
                                         j).numpy() for j in range(3))
        uc = tgf.philox_uniforms(scalars[:1], n, 1, 6 + s, 3).numpy()
        return u, uc, um, ud

    ref, ref_fit, replaced = ga_block_oracle(pos, fit, draws_of, name, hw,
                                             tile_n, shifts, k, 0.3)
    assert any(lane >= 0 for lanes in replaced for lane in lanes)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(got[1].numpy(), ref_fit)
    # Parent A reads the CURRENT generation: rolling the block-start
    # population instead gives another launch.
    if k > 1:
        stale = tgf.fused_ga_step_t(scalars, *tt(pos, fit),
                                    objective_name=name, half_width=hw,
                                    tile_n=tile_n, rng="device", k_steps=1,
                                    step0=6, p_mut=0.3)
        assert not torch.equal(stale[0], got[0])


def test_step_rejects_bad_arguments():
    hw, pos, fit, draws = ga_inputs("sphere", 512, 2, 0)
    args = (torch.zeros(6, dtype=torch.int32), *tt(pos, fit))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tgf.fused_ga_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="k_steps=1"):
        tgf.fused_ga_step_t(*args, *tt(*draws), rng="host", k_steps=2, **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        tgf.fused_ga_step_t(*args, objective_name="sphere", tile_n=100)
    before = tgf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgf.fused_ga_step_cuda(*args, **kw)
    assert tgf.LAUNCHES == before
    assert tgf.ga_pallas_supported("rastrigin", torch.float32, 5000)
    assert not tgf.ga_pallas_supported("michalewicz", torch.float32, 101)
    assert tgf.tile_threads(4096) == 512 and tgf.tile_threads(128) == 128
    assert tgf.tile_threads(100) == 128 and tgf.tile_threads(8192) == 512


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_inputs(key, calls, n_pad, d, tile_n):
    """What JAX's ``fused_ga_run(rng="host")`` draws for each launch: the
    four uniforms and the five shifts."""
    host_key = jax.random.fold_in(key, 0x6A)
    shift_key = jax.random.fold_in(key, 0x6A5F)
    n_tiles = n_pad // tile_n
    uniforms, shifts = [], []
    for i in range(calls):
        uniforms.append(tt(*jgf.host_draws(host_key, i, (d, n_pad),
                                           (1, n_pad))))
        kk = jax.random.fold_in(shift_key, i)
        ts = jax.random.randint(kk, (2,), 1, max(n_tiles, 2))
        lanes = jax.random.randint(jax.random.fold_in(kk, 1), (3,), 0,
                                   tile_n)
        shifts.append([*map(int, ts), *map(int, lanes)])
    return uniforms, torch.tensor(shifts, dtype=torch.int32)


@pytest.mark.parametrize("name,n,tile_n", [("sphere", 700, 128),
                                           ("rastrigin", 1024, None)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n):
    d, steps = 4, 4
    jfn, hw = jobj.get_objective(name)
    js = jga.ga_init(jfn, n, d, hw, seed=n)
    ts = tga.ga_state_from_numpy(to_numpy(js), device="cpu")
    tile, _ = family.lane_tiling(n, tile_n, d)
    tile, n_pad, _ = family.shrink_tile_for_donors(n, tile)
    uniforms, shifts = jax_run_inputs(js.key, steps, n_pad, d, tile)
    want = jgf.fused_ga_run(js, name, steps, half_width=hw, tile_n=tile_n,
                            rng="host", interpret=True)
    got = tgf.fused_ga_run(ts, name, steps, half_width=hw, tile_n=tile_n,
                           rng="host", uniforms=uniforms, shifts=shifts)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, hw, name)


def test_fused_run_converges_monotone_and_pads():
    # The JAX package's cases: one generation a launch.
    fn, hw = tobj.get_objective("sphere")
    st = tga.ga_init(fn, 1000, 6, hw, seed=0, device="cpu")
    out = tgf.fused_ga_run(st, "sphere", 150, half_width=hw, rng="host")
    assert out.pos.shape == (1000, 6) and int(out.iteration) == 150
    assert float(out.best_fit) < 1e-3
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    rfn, _ = tobj.get_objective("rastrigin")
    s = tga.ga_init(rfn, 512, 6, hw, seed=5, device="cpu")
    prev_min = float(s.fit.min())
    for _ in range(5):     # per-tile elitism keeps the population's best
        s = tgf.fused_ga_run(s, "rastrigin", 1, half_width=hw, rng="host")
        assert float(s.fit.min()) <= prev_min + 1e-5
        prev_min = float(s.fit.min())
    prev, s = float(st.best_fit), st
    for _ in range(3):     # launches of 8 generations
        s = tgf.fused_ga_run(s, "sphere", 16, half_width=hw)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
    runs = [tgf.fused_ga_run(tga.ga_state_from_numpy(
        tga.ga_state_to_numpy(st), device="cpu", seed=4), "sphere", 10,
        half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    small = tga.ga_init(fn, 64, 5, hw, seed=2, device="cpu")
    with pytest.raises(ValueError, match="rotational"):
        tgf.fused_ga_run(small, "sphere", 5, half_width=hw)


def test_model_backend_switch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.GA("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.GA("sphere", n=1024, dim=4, seed=0, use_pallas=True,
                  device="cpu")
    opt.run(60)
    assert opt.best < 1e-2
    assert tdsa.GA("sphere", n=256, dim=2, device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.GA("sphere", n=64, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.GA(tobj.sphere, n=1024, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.GA("sphere", n=1024, dim=4, n_elite=3, use_pallas=True,
                device="cpu")
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda.ga_fused"
            " as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
