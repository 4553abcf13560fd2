"""The port's cuckoo search (``ops/cuckoo.py``, kernel B12's plain version in
``ops/cuda/cuckoo_fused.py``, the shared fast math of
``ops/cuda/fast_math.py``, the ``Cuckoo`` model and the CLI) against the
JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (the Levy normals, egg targets, abandonment
uniforms, peer permutations and walk uniforms from JAX's key chain), the
TPU kernel in interpret mode with host-supplied draws (``rng="host"``,
``interpret=True``, as ``tests/test_pallas_cuckoo.py`` runs it) against the
port's plain version, and whole fused runs over several launches with
JAX's own tile and lane shifts.  A launch of k generations (which JAX draws
on the TPU only) is held to a numpy reference of the same semantics: the
egg rolled with ``np.roll`` over the tile's candidates of the *same*
generation, the peers over the block-start tiles.

Tolerances, each with its reason:

- positions ``rtol = 1e-5``, ``atol = max(1e-5, 4e-6 hw)``: XLA on the CPU
  contracts the Horner steps of the bit-field ``log2`` and ``2^x``
  polynomials and the flight ``x + (s levy)(x - best)`` into multiply-adds
  (the portable step's ``pow`` is each library's own), a few ulps of the
  largest term;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- the Box-Muller pair against JAX's chain within ``1e-6 (1 + |n|) + 3e-6 /
  r``: the ``log2`` band of ``tests/test_torch_ga.py`` (2e-6, 4 ulps of the
  polynomial's largest term) moves ``r^2 = -2 ln2 log2(1 - u1)`` by 2.8e-6,
  so ``r`` by 1.4e-6 / r; the Levy power ``2^(-log2(|n2|) / beta)``
  within ``2e-6`` relative (that band times ``ln 2 / beta``, and 2 ulps of
  the ``2^x`` polynomial);
- discrete results are exact: which nests took an egg and which were
  abandoned.  An egg decision reads the Levy chain; the lanes whose egg
  lies within ``1e-6`` relative of the nest it meets (8 ulps) are counted
  and left out of the comparison, and there are none at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import cuckoo as jck
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import cuckoo_fused as jcf
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu_torch.cli import main as cli_main
from distributed_swarm_algorithm_tpu_torch.ops import cuckoo as tck
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import cuckoo_fused as tcf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import fast_math as tfm

OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = tck.CUCKOO_TENSOR_FIELDS


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


def in_kernel(fn, *xs):
    """``fn`` of the JAX package's Mosaic helpers, run inside an
    interpreted ``pallas_call`` (they bitcast with Mosaic)."""
    from jax.experimental import pallas as pl

    def kernel(*refs):
        outs = fn(*(r[...] for r in refs[:len(xs)]))
        outs = outs if isinstance(outs, tuple) else (outs,)
        for o_ref, o in zip(refs[len(xs):], outs):
            o_ref[...] = o

    shapes = jax.eval_shape(lambda *a: fn(*a), *(jnp.asarray(x) for x in xs))
    shapes = shapes if isinstance(shapes, tuple) else (shapes,)
    out = pl.pallas_call(
        kernel, out_shape=tuple(jax.ShapeDtypeStruct(s.shape, jnp.float32)
                                for s in shapes),
        interpret=True)(*(jnp.asarray(x) for x in xs))
    return tuple(np.asarray(o) for o in out)


def test_constants_are_the_jax_packages():
    assert (tck.PA, tck.STEP_SCALE, tck.LEVY_BETA) == (
        jck.PA, jck.STEP_SCALE, jck.LEVY_BETA)
    for beta in (1.5, 1.2, 1.9):
        assert tck.mantegna_sigma(beta) == jck._mantegna_sigma(beta)
    assert tfm.LOG2_C == jcf._LOG2_C and tfm.LN2 == jcf._LN2
    assert tcf.MAX_STEPS_PER_KERNEL == 8


def test_box_muller_and_levy_power_match_the_jax_chain():
    # JAX's _normal_pair draws its uniforms on the chip: its chain is run
    # here from the same uniforms, through its own helpers.
    g = np.random.default_rng(0)
    u1 = g.uniform(size=(8, 512)).astype(np.float32)
    u2 = g.uniform(size=(8, 512)).astype(np.float32)
    u1[0, :4] = [0.0, 1e-7, 0.999999, 0.5]

    def chain(a, b):
        r = jnp.sqrt(-2.0 * jcf._LN2 * jcf._log2_fast(1.0 - a))
        return r * jpf._cos2pi(b), r * jpf._sin2pi(b)

    want = in_kernel(chain, u1, u2)
    got = [a.numpy() for a in tfm.normal_pair(*tt(u1, u2))]
    # u1 = 0 meets log2_fast(1) = +5e-6 > 0: NaN in both, as on the chip.
    assert np.isnan(got[0][0, 0]) and np.isnan(want[0][0, 0])
    r = np.hypot(*got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = np.isnan(a) | (np.abs(a - b) <= 1e-6 * np.abs(b) + 1e-6
                            + 3e-6 / r)
        assert ok.all(), np.abs(a - b)[~ok].max()
    n2 = g.standard_normal((8, 512)).astype(np.float32)
    inv = 1.0 / 1.5
    want = in_kernel(lambda v: jcf._exp2_fast(
        -inv * jcf._log2_fast(jnp.abs(v) + 1e-12)), n2)[0]
    np.testing.assert_allclose(tfm.levy_power(torch.from_numpy(n2),
                                              inv).numpy(), want,
                               rtol=2e-6, atol=1e-6)


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_step_draws(js):
    n, d = js.pos.shape
    dt = js.pos.dtype
    _, kl, kt, ka, kp1, kp2, ku = jax.random.split(js.key, 7)
    ku_, kv_ = jax.random.split(kl)
    return tt(jax.random.normal(ku_, (n, d), dt),
              jax.random.normal(kv_, (n, d), dt),
              jax.random.randint(kt, (n,), 0, n),
              jax.random.uniform(ka, (n,), dt),
              jax.random.permutation(kp1, n),
              jax.random.permutation(kp2, n),
              jax.random.uniform(ku, (n, d), dt))


@pytest.mark.parametrize("name,n,d,pa", [
    ("sphere", 64, 5, 0.25), ("rastrigin", 63, 4, 0.0), ("ackley", 32, 6,
                                                         0.5),
    ("griewank", 48, 3, 0.25)])
def test_portable_step_matches_jax(name, n, d, pa):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jck.cuckoo_init(jfn, n, d, hw, seed=n)
    for _ in range(3):
        draws = jax_step_draws(js)
        ts = tck.cuckoo_state_from_numpy(to_numpy(js), device="cpu")
        want = jck.cuckoo_step(js, jfn, half_width=hw, pa=pa)
        got = tck.cuckoo_step(ts, tfn, half_width=hw, pa=pa, draws=draws)
        assert_state_close(got, want, hw, name)
        # Which nests took an egg or were rebuilt, exact.
        np.testing.assert_array_equal(
            got.fit.numpy() != np.asarray(js.fit),
            np.asarray(want.fit) != np.asarray(js.fit))
        js = want


def test_egg_conflicts_go_to_the_best_egg_then_the_lowest_row():
    cand = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    cand_fit = torch.tensor([3.0, 1.0, 1.0, 5.0, 0.5, 2.0])
    target = torch.tensor([2, 2, 2, 0, 5, 5])
    fit = torch.tensor([4.0, 0.0, 2.0, 0.0, 9.0, 9.0])
    accept, egg, seg = tck.egg_drop(cand, cand_fit, target, fit)
    assert accept.tolist() == [False, False, True, False, False, True]
    assert seg.tolist() == [5.0, float("inf"), 1.0, float("inf"),
                            float("inf"), 0.5]
    assert egg[2].tolist() == cand[1].tolist()      # rows 1, 2 tie: row 1
    assert egg[5].tolist() == cand[4].tolist()


def test_portable_search_mirrors_the_jax_cases():
    fn, _ = tobj.get_objective("sphere")
    opt = tdsa.Cuckoo("sphere", n=64, dim=4, seed=0, device="cpu")
    opt.run(400)
    assert opt.best < 1e-2
    st = tck.cuckoo_init(fn, 32, 5, 5.12, seed=1, device="cpu")
    prev = float(st.best_fit)
    for _ in range(20):
        nxt = tck.cuckoo_step(st, fn, 5.12, pa=0.0)
        assert float(nxt.best_fit) <= prev + 1e-7
        assert bool((nxt.fit <= st.fit + 1e-7).all())   # greedy
        prev, st = float(nxt.best_fit), nxt
    st = tck.cuckoo_run(tck.cuckoo_init(fn, 48, 3, 2.0, seed=3,
                                        device="cpu"), fn, 40,
                        half_width=2.0)
    assert float(st.pos.abs().max()) <= 2.0 + 1e-6
    np.testing.assert_allclose(fn(st.pos).numpy(), st.fit.numpy(),
                               atol=1e-5)
    steps = tck.levy_steps(torch.Generator().manual_seed(0), (20000,), 1.5,
                           torch.float32, "cpu").numpy()
    iqr = np.subtract(*np.percentile(steps, [75, 25]))
    assert np.max(np.abs(steps)) / iqr > 50.0
    a = tdsa.Cuckoo("rastrigin", n=32, dim=4, seed=7, device="cpu")
    b = tdsa.Cuckoo("rastrigin", n=32, dim=4, seed=7, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best == b.best


# --------------------------------------------------------------------------
# Kernel B12's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def cuckoo_inputs(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    best = pos[:, fit[0].argmin()][:, None].copy()
    draws = [rng.standard_normal((d, n)).astype(np.float32),
             rng.standard_normal((d, n)).astype(np.float32),
             rng.uniform(size=(1, n)).astype(np.float32),
             rng.uniform(size=(d, n)).astype(np.float32)]
    return float(hw), pos, fit, best, draws


def egg_band_lanes(pos, fit, best, draws, name, hw, tile_n, l_egg):
    """[1, N]: lanes whose egg's fitness lies within 1e-6 relative of the
    nest's, the egg decisions a few ulps of the Levy chain could flip."""
    d, n = pos.shape
    cand = tcf.levy_flight(*tt(pos, best, draws[0], draws[1]),
                           tck.mantegna_sigma(1.5), 0.01, 1.5, hw)
    cf = tcf.OBJECTIVES_T[name](cand).numpy()
    egg = np.roll(cf.reshape(n // tile_n, tile_n), l_egg + 1, 1).reshape(1, n)
    return np.abs(egg - fit) <= 1e-6 * np.abs(fit)


@pytest.mark.parametrize("name,n,tile_n,shifts", [
    ("sphere", 512, 128, (1, 2, 0, 0, 0)),
    ("rastrigin", 512, 128, (3, 3, 100, 5, 127)),
    ("griewank", 640, 128, (4, 2, 250, 1, 37)),
    ("ackley", 1024, 256, (1, 3, 7, 300, 9))])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             shifts):
    d = 5
    hw, pos, fit, best, draws = cuckoo_inputs(name, n, d, n + shifts[2])
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n, rng="host")
    want = jcf.fused_cuckoo_step_t(
        jnp.asarray([0, *shifts]), jnp.asarray(best), jnp.asarray(pos),
        jnp.asarray(fit), *(jnp.asarray(r) for r in draws), interpret=True,
        **kw)
    got = tcf.fused_cuckoo_step_t(
        torch.tensor([0, *shifts], dtype=torch.int32),
        *tt(best, pos, fit, *draws), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **pos_tol(hw))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    # The egg winners and the abandoned nests, exact outside the band.
    near = egg_band_lanes(pos, fit, best, draws, name, hw, tile_n,
                          shifts[2])
    assert int(near.sum()) == 0
    keep = ~(draws[2] < tcf.PA) & ~near
    changed = lambda f: np.asarray(f) != fit  # noqa: E731
    np.testing.assert_array_equal(changed(got[1]) & keep,
                                  changed(want[1]) & keep)
    assert (changed(got[1]) & keep).any()


def cuckoo_block_oracle(pos, fit, best, draws_of, name, hw, tile_n, s, k):
    """A numpy reference of one k-generation launch: the candidates through
    the port's Levy flight, the egg from np.roll over each tile's candidates
    of the same generation, the peers from np.roll over the block-start
    tiles (i + s1, i + s2).  Returns the positions, the fitness and the
    number of eggs taken at each generation."""
    d, n = pos.shape
    nt = n // tile_n
    obj = lambda x: tcf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x))).numpy()

    def tiles(x, shift=0):
        t = x.reshape(x.shape[0], nt, tile_n)
        return t[:, (np.arange(nt) + shift) % nt, :]

    def roll(t, lane_shift):
        return np.roll(t, lane_shift, axis=2).reshape(t.shape[0], n)

    p1, p2 = tiles(pos, s[0]), tiles(pos, s[1])
    x, fx = pos.copy(), fit.copy()
    taken = []
    for step in range(k):
        sa, sb, sc = family.LANE_SHIFTS[step % 8]
        n1, n2, u_ab, u_walk = draws_of(step)
        cand = tcf.levy_flight(*tt(x, best, n1, n2), tck.mantegna_sigma(1.5),
                               0.01, 1.5, hw).numpy()
        cf = obj(cand)
        egg, ef = roll(tiles(cand), s[2] + sa), roll(tiles(cf), s[2] + sa)
        accept = ef < fx
        taken.append(int(accept.sum()))
        x = np.where(accept, egg, x)
        fx = np.where(accept, ef, fx)
        fresh = np.clip(x + u_walk * (roll(p1, s[3] + sb)
                                      - roll(p2, s[4] + sc)), -hw, hw)
        abandon = u_ab < np.float32(0.25)
        x = np.where(abandon, fresh, x).astype(np.float32)
        fx = np.where(abandon, obj(fresh), fx)
    return x, fx, taken


@pytest.mark.parametrize("n,tile_n,k,shifts", [
    (512, 128, 8, (3, 3, 126, 40, 0)), (640, 128, 5, (1, 4, 0, 9, 60)),
    (1024, 256, 8, (2, 2, 300, 7, 255)), (512, 128, 1, (1, 3, 5, 6, 7))])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, shifts):
    d, name = 6, "rastrigin"
    hw, pos, fit, best, _ = cuckoo_inputs(name, n, d, k)
    scalars = torch.tensor([21, *shifts], dtype=torch.int32)
    got = tcf.fused_cuckoo_step_t(scalars, *tt(best, pos, fit),
                                  objective_name=name, half_width=hw,
                                  tile_n=tile_n, rng="device", k_steps=k,
                                  step0=6)
    draws_of = lambda s: [r.numpy() for r in tcf.device_draws(  # noqa
        scalars[:1], n, d, 6 + s)]
    ref, ref_fit, taken = cuckoo_block_oracle(pos, fit, best, draws_of, name,
                                              hw, tile_n, shifts, k)
    assert all(t > 0 for t in taken)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(got[1].numpy(), ref_fit)
    # The egg reads the CURRENT generation's candidates: rolling the
    # block-start candidates instead gives another launch.
    if k > 1:
        stale = tcf.fused_cuckoo_step_t(scalars, *tt(best, pos, fit),
                                        objective_name=name, half_width=hw,
                                        tile_n=tile_n, rng="device",
                                        k_steps=1, step0=6)
        assert not torch.equal(stale[0], got[0])


def test_step_rejects_bad_arguments():
    hw, pos, fit, best, draws = cuckoo_inputs("sphere", 512, 2, 0)
    args = (torch.zeros(6, dtype=torch.int32), *tt(best, pos, fit))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tcf.fused_cuckoo_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="k_steps=1"):
        tcf.fused_cuckoo_step_t(*args, *tt(*draws), rng="host", k_steps=2,
                                **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        tcf.fused_cuckoo_step_t(*args, objective_name="sphere", tile_n=100)
    before = tcf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcf.fused_cuckoo_step_cuda(*args, **kw)
    assert tcf.LAUNCHES == before
    assert tcf.cuckoo_pallas_supported("rastrigin", torch.float32, 5000)
    assert not tcf.cuckoo_pallas_supported("rastrigin", torch.bfloat16)
    assert not tcf.cuckoo_pallas_supported("michalewicz", torch.float32, 101)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_inputs(key, calls, n_pad, d, tile_n):
    """What JAX's ``fused_cuckoo_run(rng="host")`` draws for each launch:
    the four host draws and the five shifts."""
    host_key = jax.random.fold_in(key, 0xC0C)
    shift_key = jax.random.fold_in(key, 0xC1C)
    n_tiles = n_pad // tile_n
    draws, shifts = [], []
    for i in range(calls):
        draws.append(tt(*jcf.host_draws(host_key, i, (d, n_pad),
                                        (1, n_pad))))
        kk = jax.random.fold_in(shift_key, i)
        ts = jax.random.randint(kk, (2,), 1, max(n_tiles, 2))
        lanes = jax.random.randint(jax.random.fold_in(kk, 1), (3,), 0,
                                   tile_n)
        shifts.append([*map(int, ts), *map(int, lanes)])
    return draws, torch.tensor(shifts, dtype=torch.int32)


@pytest.mark.parametrize("name,n,tile_n", [("sphere", 700, 128),
                                           ("rastrigin", 1024, None)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n):
    d, steps = 4, 3
    jfn, hw = jobj.get_objective(name)
    js = jck.cuckoo_init(jfn, n, d, hw, seed=n)
    ts = tck.cuckoo_state_from_numpy(to_numpy(js), device="cpu")
    tile, _ = family.lane_tiling(n, tile_n, d)
    tile, n_pad, _ = family.shrink_tile_for_donors(n, tile)
    draws, shifts = jax_run_inputs(js.key, steps, n_pad, d, tile)
    want = jcf.fused_cuckoo_run(js, name, steps, half_width=hw,
                                tile_n=tile_n, rng="host", interpret=True)
    got = tcf.fused_cuckoo_run(ts, name, steps, half_width=hw,
                               tile_n=tile_n, rng="host", uniforms=draws,
                               shifts=shifts)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, hw, name)


def test_fused_run_converges_monotone_and_pads():
    # The JAX package's cases (tests/test_pallas_cuckoo.py), one generation
    # a launch, at the sizes its tests use.
    fn, hw = tobj.get_objective("sphere")
    st = tck.cuckoo_init(fn, 1024, 6, hw, seed=0, device="cpu")
    out = tcf.fused_cuckoo_run(st, "sphere", 150, half_width=hw, rng="host")
    assert out.pos.shape == (1024, 6) and int(out.iteration) == 150
    assert float(out.best_fit) < 1e-3
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    rfn, _ = tobj.get_objective("rastrigin")
    s = tck.cuckoo_init(rfn, 512, 6, hw, seed=3, device="cpu")
    prev = float(s.best_fit)
    for _ in range(3):      # launches of 8 generations
        s = tcf.fused_cuckoo_run(s, "rastrigin", 10, half_width=hw)
        assert float(s.best_fit) <= prev + 1e-6
        prev = float(s.best_fit)
    runs = [tcf.fused_cuckoo_run(tck.cuckoo_state_from_numpy(
        tck.cuckoo_state_to_numpy(s), device="cpu", seed=4), "rastrigin",
        12, half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    padded = tcf.fused_cuckoo_run(
        tck.cuckoo_init(fn, 700, 5, hw, seed=2, device="cpu"), "sphere", 16,
        half_width=hw)
    assert padded.pos.shape == (700, 5)
    small = tck.cuckoo_init(fn, 64, 5, hw, seed=2, device="cpu")
    with pytest.raises(ValueError, match="rotational"):
        tcf.fused_cuckoo_run(small, "sphere", 5, half_width=hw)


def test_model_backend_switch_and_cli(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.Cuckoo("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.Cuckoo("sphere", n=1024, dim=4, seed=0, use_pallas=True,
                      device="cpu")
    opt.run(80)
    assert opt.best < 1e-2
    assert tdsa.Cuckoo("sphere", n=1024, dim=2,
                       device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.Cuckoo("sphere", n=64, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.Cuckoo(tobj.sphere, n=1024, dim=4, use_pallas=True,
                    device="cpu")
    with pytest.raises(ValueError, match="pa"):
        tdsa.Cuckoo("sphere", n=64, dim=4, pa=1.5, device="cpu")
    assert cli_main(["cuckoo", "--device", "cpu", "--objective", "sphere",
                     "--n", "256", "--dim", "4", "--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert '"path": "portable"' in out and '"nests": 256' in out
