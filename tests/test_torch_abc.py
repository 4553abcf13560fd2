"""The port's artificial bee colony (``ops/abc.py``, kernel B17's plain
version in ``ops/cuda/abc_fused.py``, the ``ABC`` model and the CLI) against
the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (both mutations' partner draws, dimensions
and phis from JAX's key chain, the onlookers' categorical choice taken from
JAX on its own post-employed fitness, the scouts' plane), the TPU kernel
in interpret mode with host-supplied draws (``rng="host"``,
``interpret=True``, as ``tests/test_pallas_abc.py`` runs it) against the
port's plain version, and whole fused runs over several launches with
JAX's own tile and lane shifts.  A launch of k cycles (which JAX draws on
the TPU only) is held to a numpy reference of the same semantics: the
employed partner rolled with ``np.roll`` over the tile's *current*
sources, the onlooker gate over the tile's current maximum quality, the
onlooker partner over the block-start tile.  The scouts are held at a
small ``limit``, where they fire.

Tolerances, each with its reason:

- positions ``rtol = 1e-5``, ``atol = max(1e-5, 4e-6 hw)``: the one moved
  coordinate ``x + phi (x - p)`` may be contracted into a multiply-add by
  XLA on the CPU;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- discrete results are exact: the trial counters (each accepted probe sets
  0, each rejected one adds 1, a scout resets), and so every accept, probe
  and exhaustion.  The onlooker gate compares a uniform with ``q /
  max(q)``, a quotient of the objective's values: the lanes within ``1e-6``
  of the gate are counted, and there are none at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import abc as jabc
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import abc_fused as jaf
from distributed_swarm_algorithm_tpu_torch.cli import main as cli_main
from distributed_swarm_algorithm_tpu_torch.ops import abc as tabc
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import abc_fused as taf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family

OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = tabc.ABC_TENSOR_FIELDS


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
    np.testing.assert_array_equal(got.trials.numpy(),
                                  np.asarray(want.trials),
                                  err_msg=f"{label} trials")
    assert int(got.iteration) == int(want.iteration)


def test_constants_and_quality_are_the_jax_packages():
    assert taf.MAX_STEPS_PER_KERNEL == 8
    f = np.array([-3.0, -0.0, 0.0, 1e-8, 0.5, 7.0, 1e6], np.float32)
    np.testing.assert_array_equal(tabc.quality(torch.from_numpy(f)).numpy(),
                                  np.asarray(jaf._quality(jnp.asarray(f))))


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def mutate_draws(key, s, d, dt):
    kk, kj, kphi = jax.random.split(key, 3)
    return tt(jax.random.randint(kk, (s,), 0, s - 1),
              jax.random.randint(kj, (s,), 0, d),
              jax.random.uniform(kphi, (s,), dt, -1.0, 1.0))


def jax_step_draws(js, jfn, hw):
    """One cycle's draws from JAX's key chain; the onlookers' choice from
    JAX's own employed phase and categorical draw."""
    s, d = js.pos.shape
    dt = js.pos.dtype
    _, ke, ko, ksel, ks = jax.random.split(js.key, 5)
    cand = jabc._mutate(js.pos, jnp.arange(s), ke, hw)
    _, fit, _ = jabc._greedy(js.pos, js.fit, js.trials, cand, jfn(cand))
    quality = 1.0 / (1.0 + jnp.where(fit >= 0, fit, 0.0)) + jnp.where(
        fit < 0, -fit, 0.0)
    chosen = jax.random.categorical(ksel, jnp.log(quality + 1e-12),
                                    shape=(s,))
    return (mutate_draws(ke, s, d, dt), tt(chosen)[0],
            mutate_draws(ko, s, d, dt),
            tt(jax.random.uniform(ks, (s, d), dt, -hw, hw))[0])


@pytest.mark.parametrize("name,n,d,limit", [
    ("sphere", 64, 5, 20), ("rastrigin", 63, 4, 1), ("ackley", 32, 6, 0),
    ("griewank", 48, 3, 3)])
def test_portable_step_matches_jax(name, n, d, limit):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jabc.abc_init(jfn, n, d, hw, seed=n)
    for _ in range(4):
        draws = jax_step_draws(js, jfn, hw)
        ts = tabc.abc_state_from_numpy(to_numpy(js), device="cpu")
        want = jabc.abc_step(js, jfn, half_width=hw, limit=limit)
        got = tabc.abc_step(ts, tfn, half_width=hw, limit=limit,
                            draws=draws)
        assert_state_close(got, want, hw, name)
        js = want
    if limit <= 1:       # scouts fired
        assert int(np.asarray(js.trials).max()) <= limit


def test_onlooker_conflicts_and_trial_rules():
    # Two onlookers on source 0 (row 1's candidate is the better one and
    # wins), none on source 1, source 2 probed by a worse candidate: 0
    # accepts (trials 0), 1 keeps its counter, 2 adds 1.
    fn = lambda x: (x * x).sum(-1)  # noqa: E731
    pos = torch.tensor([[3.0, 3.0], [1.0, 1.0], [0.5, 0.5]])
    state = tabc.ABCState(
        pos=pos, fit=fn(pos), trials=torch.tensor([5, 5, 5],
                                                  dtype=torch.int32),
        best_pos=pos[2], best_fit=fn(pos)[2],
        gen=torch.Generator(), iteration=torch.zeros((), dtype=torch.int32))
    no_move = (torch.tensor([0, 0, 0]), torch.tensor([0, 0, 0]),
               torch.zeros(3))                     # phi 0: employed rejects
    onl = (torch.tensor([0, 0, 0]), torch.tensor([0, 1, 1]),
           torch.tensor([-0.25, -1.0, -1.0]))
    out = tabc.abc_step(state, fn, 5.12, limit=10, draws=(
        no_move, torch.tensor([0, 0, 2]), onl, torch.zeros(3, 2)))
    assert out.trials.tolist() == [0, 6, 7]
    assert out.pos[0].tolist() == [3.0, 1.0]          # row 1's candidate
    assert out.pos[2].tolist() == [0.5, 0.5]


def test_portable_colony_mirrors_the_jax_cases():
    fn, _ = tobj.get_objective("sphere")
    opt = tdsa.ABC("sphere", n=64, dim=4, seed=0, device="cpu")
    opt.run(300)
    assert opt.best < 1e-3
    st = tabc.abc_init(fn, 32, 5, 5.12, seed=1, device="cpu")
    prev = float(st.best_fit)
    for _ in range(20):
        st = tabc.abc_step(st, fn, 5.12, limit=10)
        assert float(st.best_fit) <= prev + 1e-7
        prev = float(st.best_fit)
    st = tabc.abc_run(tabc.abc_init(fn, 48, 6, 2.0, seed=2, device="cpu"),
                      fn, 50, half_width=2.0, limit=5)
    assert float(st.pos.abs().max()) <= 2.0 + 1e-6
    np.testing.assert_allclose(fn(st.pos).numpy(), st.fit.numpy(),
                               atol=1e-5)
    st = tabc.abc_run(tabc.abc_init(fn, 16, 3, 5.12, seed=3, device="cpu"),
                      fn, 40, half_width=5.12, limit=3)
    assert int(st.trials.max()) <= 3 + 2
    a = tdsa.ABC("rastrigin", n=32, dim=4, seed=7, device="cpu")
    b = tdsa.ABC("rastrigin", n=32, dim=4, seed=7, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best == b.best and a.limit == 32 * 4


# --------------------------------------------------------------------------
# Kernel B17's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def abc_inputs(name, n, d, seed, limit):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    trials = rng.integers(0, limit + 2, (1, n)).astype(np.int32)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    draws = [u(1, n) for _ in range(5)] + [u(d, n)]
    draws[0][0, :3] = [0.99999997, 0.5, 0.0]   # floor(u D) = D: none moves
    return float(hw), pos, fit, trials, draws


@pytest.mark.parametrize("name,n,tile_n,shifts,limit", [
    ("sphere", 512, 128, (1, 0, 0), 20),
    ("rastrigin", 512, 128, (3, 100, 5), 2),
    ("griewank", 640, 128, (4, 250, 1), 3),
    ("ackley", 1024, 256, (1, 7, 300), 1)])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             shifts, limit):
    d = 5
    hw, pos, fit, trials, draws = abc_inputs(name, n, d, n + shifts[1],
                                             limit)
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n,
              limit=limit, rng="host")
    want = jaf.fused_abc_step_t(
        jnp.asarray([0, *shifts]), jnp.asarray(pos), jnp.asarray(fit),
        jnp.asarray(trials), tuple(jnp.asarray(r) for r in draws),
        interpret=True, **kw)
    got = taf.fused_abc_step_t(
        torch.tensor([0, *shifts], dtype=torch.int32),
        *tt(pos, fit, trials), tt(*draws), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **pos_tol(hw))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32
    assert (got[2].numpy() == 0).any() and (got[2].numpy() > 0).any()


def abc_block_oracle(pos, fit, trials, draws_of, name, hw, tile_n, s, k,
                     limit):
    """A numpy reference of one k-cycle launch: the employed partner from
    np.roll over each tile's current sources, the gate over the tile's
    current maximum quality, the onlooker partner from np.roll over the
    block-start tile i + s, the scouts past ``limit``.  Returns positions,
    fitness, trials and per cycle (probed, exhausted, the lanes within 1e-6
    of the gate)."""
    d, n = pos.shape
    nt = n // tile_n
    obj = lambda x: taf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()
    quality = lambda f: tabc.quality(torch.from_numpy(f)).numpy()  # noqa

    def tiles(x, shift=0):
        t = x.reshape(x.shape[0], nt, tile_n)
        return t[:, (np.arange(nt) + shift) % nt, :]

    def roll(t, lane_shift):
        return np.roll(t, lane_shift, axis=2).reshape(t.shape[0], n)

    row = np.arange(d)[:, None]

    def mutate(base, partner, u_dim, u_phi):
        j = np.floor(u_dim * np.float32(d)).astype(np.int32)
        mask = (row == j).astype(np.float32)
        phi = np.float32(2.0) * u_phi - np.float32(1.0)
        return np.clip(base + mask * (phi * (base - partner)), -hw, hw)

    snap = tiles(pos, s[0])
    x, fx, tr = pos.copy(), fit.copy(), trials.copy()
    counts = []
    for step in range(k):
        la, lb, _ = family.LANE_SHIFTS[step % 8]
        ud1, up1, ug, ud2, up2, fresh_u = draws_of(step)
        cand = mutate(x, roll(tiles(x), s[1] + la), ud1, up1)
        cf = obj(cand)
        acc = cf < fx
        x, fx = np.where(acc, cand, x), np.where(acc, cf, fx)
        tr = np.where(acc, 0, tr + 1)
        q = quality(fx).reshape(nt, tile_n)
        ratio = (q / np.maximum(q.max(1, keepdims=True),
                                np.float32(1e-12))).reshape(1, n)
        probed = ug < ratio
        cand2 = mutate(x, roll(snap, s[2] + lb), ud2, up2)
        c2 = obj(cand2)
        acc2 = probed & (c2 < fx)
        x, fx = np.where(acc2, cand2, x), np.where(acc2, c2, fx)
        tr = np.where(acc2, 0, np.where(probed, tr + 1, tr))
        exhausted = tr > limit
        fresh = (np.float32(2.0) * fresh_u - np.float32(1.0)) * np.float32(hw)
        x = np.where(exhausted, fresh, x).astype(np.float32)
        fx = np.where(exhausted, obj(fresh), fx)
        tr = np.where(exhausted, 0, tr).astype(np.int32)
        counts.append((int(probed.sum()), int(exhausted.sum()),
                       int((np.abs(ug - ratio) <= 1e-6).sum())))
    return x, fx, tr, counts


@pytest.mark.parametrize("n,tile_n,k,shifts,limit", [
    (512, 128, 8, (3, 126, 40), 2), (640, 128, 5, (1, 0, 9), 1),
    (1024, 256, 8, (2, 300, 7), 3), (512, 128, 1, (1, 5, 6), 20)])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, shifts, limit):
    d, name = 6, "rastrigin"
    hw, pos, fit, trials, _ = abc_inputs(name, n, d, k, limit)
    scalars = torch.tensor([21, *shifts], dtype=torch.int32)
    counts = {}
    got = taf.fused_abc_step_t(scalars, *tt(pos, fit, trials),
                               objective_name=name, half_width=hw,
                               tile_n=tile_n, limit=limit, rng="device",
                               k_steps=k, step0=6, counts=counts)
    draws_of = lambda s: [r.numpy() for r in taf.device_draws(  # noqa
        scalars[:1], n, d, 6 + s)]
    ref, ref_fit, ref_tr, ref_counts = abc_block_oracle(
        pos, fit, trials, draws_of, name, hw, tile_n, shifts, k, limit)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(got[1].numpy(), ref_fit)
    np.testing.assert_array_equal(got[2].numpy(), ref_tr)
    assert [(int(p), int(e)) for p, e in zip(counts["probed"],
                                             counts["exhausted"])] == [
        c[:2] for c in ref_counts]
    assert sum(c[1] for c in ref_counts) > 0         # scouts fired
    assert sum(c[2] for c in ref_counts) == 0        # none at the gate
    # The employed partner reads the CURRENT tile: a launch of one cycle
    # from the same input differs after the first.
    if k > 1:
        one = taf.fused_abc_step_t(scalars, *tt(pos, fit, trials),
                                   objective_name=name, half_width=hw,
                                   tile_n=tile_n, limit=limit, rng="device",
                                   k_steps=1, step0=6)
        assert not torch.equal(one[0], got[0])


def test_step_rejects_bad_arguments():
    hw, pos, fit, trials, draws = abc_inputs("sphere", 512, 2, 0, 20)
    args = (torch.zeros(4, dtype=torch.int32), *tt(pos, fit, trials))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        taf.fused_abc_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="k_steps=1"):
        taf.fused_abc_step_t(*args, tt(*draws), rng="host", k_steps=2, **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        taf.fused_abc_step_t(*args, objective_name="sphere", tile_n=100)
    before = taf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        taf.fused_abc_step_cuda(*args, **kw)
    assert taf.LAUNCHES == before
    assert taf.abc_pallas_supported("rastrigin", torch.float32, 5000)
    assert not taf.abc_pallas_supported("rastrigin", torch.bfloat16)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_inputs(key, calls, n_pad, d, tile_n):
    """What JAX's ``fused_abc_run(rng="host")`` draws for each launch: the
    six host draws, the tile shift and the two lane shifts."""
    host_key = jax.random.fold_in(key, 0xABC)
    shift_key = jax.random.fold_in(key, 0xAB5)
    n_tiles = n_pad // tile_n
    draws, shifts = [], []
    for i in range(calls):
        draws.append(tt(*jaf.host_draws(host_key, i, (d, n_pad),
                                        (1, n_pad))))
        kk = jax.random.fold_in(shift_key, i)
        ts = jax.random.randint(kk, (1,), 1, max(n_tiles, 2))
        lanes = jax.random.randint(jax.random.fold_in(kk, 1), (2,), 0,
                                   tile_n)
        shifts.append([*map(int, ts), *map(int, lanes)])
    return draws, torch.tensor(shifts, dtype=torch.int32)


@pytest.mark.parametrize("name,n,tile_n,limit", [("sphere", 700, 128, 1),
                                                 ("rastrigin", 1024, None,
                                                  20)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n, limit):
    d, steps = 4, 3
    jfn, hw = jobj.get_objective(name)
    js = jabc.abc_init(jfn, n, d, hw, seed=n)
    ts = tabc.abc_state_from_numpy(to_numpy(js), device="cpu")
    tile, _ = family.lane_tiling(n, tile_n, d)
    tile, n_pad, _ = family.shrink_tile_for_donors(n, tile)
    draws, shifts = jax_run_inputs(js.key, steps, n_pad, d, tile)
    want = jaf.fused_abc_run(js, name, steps, half_width=hw, limit=limit,
                             tile_n=tile_n, rng="host", interpret=True)
    got = taf.fused_abc_run(ts, name, steps, half_width=hw, limit=limit,
                            tile_n=tile_n, rng="host", uniforms=draws,
                            shifts=shifts)
    assert got.pos.shape == (n, d) and got.trials.shape == (n,)
    assert_state_close(got, want, hw, name)


def test_fused_run_converges_monotone_and_pads():
    # The JAX package's cases (tests/test_pallas_abc.py).
    fn, hw = tobj.get_objective("sphere")
    st = tabc.abc_init(fn, 1000, 6, hw, seed=0, device="cpu")
    out = taf.fused_abc_run(st, "sphere", 200, half_width=hw)
    assert out.pos.shape == (1000, 6) and int(out.iteration) == 200
    assert float(out.best_fit) < 1e-3
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    rfn, _ = tobj.get_objective("rastrigin")
    s = tabc.abc_init(rfn, 512, 6, hw, seed=3, device="cpu")
    out = taf.fused_abc_run(s, "rastrigin", 50, half_width=hw, limit=10)
    assert out.trials.dtype == torch.int32
    assert int(out.trials.min()) >= 0 and int(out.trials.max()) <= 10 + 2
    prev = float(s.best_fit)
    for _ in range(3):
        s = taf.fused_abc_run(s, "rastrigin", 10, half_width=hw)
        assert float(s.best_fit) <= prev + 1e-6
        prev = float(s.best_fit)
    runs = [taf.fused_abc_run(tabc.abc_state_from_numpy(
        tabc.abc_state_to_numpy(s), device="cpu", seed=4), "rastrigin", 12,
        half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    padded = tabc.abc_init(fn, 700, 5, hw, seed=2, device="cpu")
    out = taf.fused_abc_run(padded, "sphere", 40, half_width=hw)
    assert out.pos.shape == (700, 5) and out.trials.shape == (700,)
    assert float(out.best_fit) <= float(padded.best_fit) + 1e-6
    small = tabc.abc_init(fn, 64, 5, hw, seed=2, device="cpu")
    with pytest.raises(ValueError, match="rotational"):
        taf.fused_abc_run(small, "sphere", 5, half_width=hw)


def test_model_backend_switch_and_cli(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.ABC("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.ABC("sphere", n=1024, dim=4, seed=0, use_pallas=True,
                   device="cpu")
    opt.run(60)
    assert opt.best < 1e-2
    assert tdsa.ABC("sphere", n=1024, dim=2, device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.ABC("sphere", n=64, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.ABC(tobj.sphere, n=1024, dim=4, use_pallas=True, device="cpu")
    assert cli_main(["abc", "--device", "cpu", "--objective", "sphere",
                     "--n", "256", "--dim", "4", "--steps", "20",
                     "--limit", "5"]) == 0
    out = capsys.readouterr().out
    assert '"path": "portable"' in out and '"sources": 256' in out
