"""The port's parallel tempering (``ops/tempering.py``, kernel B18's plain
version in ``ops/cuda/tempering_fused.py``, the ``ParallelTempering`` model
and the CLI) against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (the proposal normals, accept uniforms and
swap uniforms from JAX's key chain), the TPU kernel in interpret mode with
host-supplied draws (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_tempering.py`` runs it) against the port's plain
version, and whole fused runs over several launches.  A launch of k steps
(which JAX draws on the TPU only) is held to a numpy reference of the same
semantics: the running best visited per lane, the exchange pairs of each
round's parity taken with ``np.roll`` inside each tile (the tile's first and
last lanes sit out at odd parity), the padded lanes never exchanging.

Tolerances, each with its reason:

- positions ``rtol = 1e-5``, ``atol = max(1e-5, 4e-6 hw)``: XLA on the CPU
  contracts ``x + sigma n`` into a multiply-add, one ulp;
- fitness ``2e-5``, the JAX package's own band for its objectives; the
  ladder ``t_min (t_max / t_min)^(c / (C - 1))`` within ``2e-6`` relative
  (each library's ``pow``);
- discrete results are exact: which chains accepted their move, which
  swapped, and the column of the best visited state.  Each acceptance and
  swap compares a uniform with an exponential (the library's ``exp`` in the
  portable step, the ``2^x`` polynomial that XLA contracts in the kernel):
  the lanes within ``1e-6`` of their threshold are counted and left out,
  and there are none at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops import tempering as jpt
from distributed_swarm_algorithm_tpu.ops.pallas import tempering_fused as jtf
from distributed_swarm_algorithm_tpu_torch.cli import main as cli_main
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import tempering as tpt
from distributed_swarm_algorithm_tpu_torch.ops.cuda import fast_math as tfm
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    tempering_fused as tf,
)

OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = tpt.PT_TENSOR_FIELDS


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
    np.testing.assert_array_equal(got.temps.numpy(), np.asarray(want.temps))
    assert int(got.iteration) == int(want.iteration)


def test_constants_and_ladder_are_the_jax_packages():
    assert (tpt.T_MIN, tpt.T_MAX, tpt.SIGMA0, tpt.SWAP_EVERY) == (
        jpt.T_MIN, jpt.T_MAX, jpt.SIGMA0, jpt.SWAP_EVERY)
    assert tf.MAX_STEPS_PER_KERNEL == 16
    fn, _ = tobj.get_objective("sphere")
    jfn, _ = jobj.get_objective("sphere")
    for n, lo, hi in ((16, 0.01, 10.0), (1, 0.5, 2.0), (700, 0.1, 50.0)):
        want = np.asarray(jpt.pt_init(jfn, n, 3, 5.12, lo, hi).temps)
        got = tpt.pt_init(fn, n, 3, 5.12, lo, hi, device="cpu").temps
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_step_draws(js):
    c, d = js.pos.shape
    dt = js.pos.dtype
    _, kp, ka, ks = jax.random.split(js.key, 4)
    return tt(jax.random.normal(kp, (c, d), dt),
              jax.random.uniform(ka, (c,), dt),
              jax.random.uniform(ks, (c,), dt))


@pytest.mark.parametrize("name,n,d,it0", [
    ("rastrigin", 16, 4, 0), ("sphere", 33, 3, 7), ("ackley", 20, 5, 3),
    ("griewank", 31, 6, 12)])
def test_portable_step_matches_jax(name, n, d, it0):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jpt.pt_init(jfn, n, d, hw, seed=n)
    js = js.replace(iteration=jnp.asarray(it0, jnp.int32))
    rounds = 0
    for _ in range(6):
        draws = jax_step_draws(js)
        ts = tpt.pt_state_from_numpy(to_numpy(js), device="cpu")
        want = jpt.pt_step(js, jfn, half_width=hw)
        got = tpt.pt_step(ts, tfn, half_width=hw, draws=draws)
        # No acceptance near its threshold (the two libraries' exp).
        cand = torch.clamp(ts.pos + 0.1 * hw * torch.sqrt(ts.temps)[:, None]
                           * draws[0], -hw, hw)
        p = torch.exp(torch.clamp((ts.fit - tfn(cand)) / ts.temps, max=0.0))
        assert not bool(((draws[1] - p).abs() <= 1e-6).any())
        assert_state_close(got, want, hw, name)
        before = np.asarray(js.pos)
        np.testing.assert_array_equal((got.pos.numpy() != before).any(1),
                                      (np.asarray(want.pos) != before).any(1))
        rounds += int(got.iteration) % 5 == 0
        js = want
    assert rounds >= 1


def test_exchange_pairs_by_parity_and_shares_the_lower_uniform():
    temps = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0])
    fit = torch.tensor([5.0, 1.0, 3.0, 0.0, 2.0])
    pos = torch.arange(5, dtype=torch.float32)[:, None]
    u = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0])
    # Parity 0 pairs (0,1) (2,3); chain 4 sits out.  Parity 1 pairs (1,2)
    # (3,4); chain 0 sits out.  u = 0 always swaps, u = 1 never does, and
    # the pair reads its lower chain's uniform.
    p0, f0 = tpt.exchange(u, pos, fit, temps, torch.tensor(0))
    assert p0[:, 0].tolist() == [1.0, 0.0, 3.0, 2.0, 4.0]
    assert f0.tolist() == [1.0, 5.0, 0.0, 3.0, 2.0]
    p1, _ = tpt.exchange(u, pos, fit, temps, torch.tensor(1))
    assert p1[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    u1 = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
    p1, _ = tpt.exchange(u1, pos, fit, temps, torch.tensor(1))
    assert p1[:, 0].tolist() == [0.0, 2.0, 1.0, 4.0, 3.0]


def test_portable_ladder_mirrors_the_jax_cases():
    fn, _ = tobj.get_objective("rastrigin")
    opt = tdsa.ParallelTempering("rastrigin", n=32, dim=4, seed=0,
                                 device="cpu")
    opt.run(3000)
    assert opt.best < 2.0
    st = tpt.pt_init(fn, 16, 4, 5.12, seed=1, device="cpu")
    temps0 = st.temps.clone()
    ratios = (temps0[1:] / temps0[:-1]).numpy()
    assert np.allclose(ratios, ratios[0], rtol=1e-4)
    st = tpt.pt_run(st, fn, 20, half_width=5.12)
    assert torch.equal(st.temps, temps0)
    sphere, _ = tobj.get_objective("sphere")
    st = tpt.pt_init(sphere, 16, 3, 2.0, seed=2, device="cpu")
    prev = float(st.best_fit)
    for _ in range(30):
        st = tpt.pt_step(st, sphere, 2.0)
        assert float(st.best_fit) <= prev + 1e-7
        prev = float(st.best_fit)
    st = tpt.pt_run(st, sphere, 100, half_width=2.0)
    assert float(st.pos.abs().max()) <= 2.0 + 1e-6
    st = tpt.pt_run(tpt.pt_init(fn, 32, 4, 5.12, seed=3, device="cpu"), fn,
                    2000)
    assert float(st.fit[:8].mean()) < float(st.fit[-8:].mean())
    a = tdsa.ParallelTempering("rastrigin", n=16, dim=4, seed=7,
                               device="cpu")
    b = tdsa.ParallelTempering("rastrigin", n=16, dim=4, seed=7,
                               device="cpu")
    a.run(50)
    b.run(50)
    assert a.best == b.best
    with pytest.raises(ValueError):
        tdsa.ParallelTempering("sphere", n=8, dim=2, t_min=2.0, t_max=1.0,
                               device="cpu")
    with pytest.raises(ValueError):
        tdsa.ParallelTempering("sphere", n=8, dim=2, swap_every=0,
                               device="cpu")


# --------------------------------------------------------------------------
# Kernel B18's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def pt_inputs(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.array(fn(jnp.asarray(pos.T)))[None, :]
    temps = (0.01 * 1000.0 ** (np.arange(n) / (n - 1))).astype(np.float32)
    sigma = (0.1 * hw * np.sqrt(temps)).astype(np.float32)[None, :]
    beta = (1.0 / temps).astype(np.float32)[None, :]
    draws = [rng.standard_normal((d, n)).astype(np.float32),
             rng.uniform(size=(1, n)).astype(np.float32),
             rng.uniform(size=(1, n)).astype(np.float32)]
    return float(hw), pos, fit, sigma, beta, draws


@pytest.mark.parametrize("name,n,tile_n,it0,n_real", [
    ("sphere", 512, 128, 4, 512), ("rastrigin", 512, 128, 9, 500),
    ("griewank", 640, 128, 14, 637), ("ackley", 1024, 256, 0, 1000)])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             it0, n_real):
    d = 5
    hw, pos, fit, sigma, beta, draws = pt_inputs(name, n, d, n + it0)
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n, rng="host")
    scalars = [0, it0, n_real]
    want = jtf.fused_pt_step_t(
        jnp.asarray(scalars), jnp.asarray(pos), jnp.asarray(fit),
        jnp.asarray(sigma), jnp.asarray(beta),
        *(jnp.asarray(r) for r in draws), interpret=True, **kw)
    counts = {}
    got = tf.fused_pt_step_t(torch.tensor(scalars, dtype=torch.int32),
                             *tt(pos, fit, sigma, beta, *draws), **kw,
                             counts=counts)
    for a, b, tol in zip(got, want, (pos_tol(hw), OBJ_TOL, OBJ_TOL,
                                     pos_tol(hw))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    # Accepts and swaps, exact: a chain's fitness changed or not, and the
    # best's column.
    changed = lambda f: np.asarray(f) != fit  # noqa: E731
    np.testing.assert_array_equal(changed(got[1]), changed(want[1]))
    cols = lambda b: set(np.nonzero(  # noqa: E731
        (np.abs(np.concatenate([pos, np.asarray(got[0])], 1)
                - np.asarray(b)) <= 1e-4).all(0))[0] % n)
    assert cols(got[3]) == cols(want[3]) and cols(got[3])
    if (it0 + 1) % 5 == 0:
        assert int(counts["swapped"][0]) > 0
    # No acceptance or swap near its threshold.
    cand = np.clip(pos + sigma * draws[0], -hw, hw)
    cf = tf.OBJECTIVES_T[name](torch.from_numpy(cand)).numpy()
    p = tfm.exp_fast(torch.from_numpy(np.minimum((fit - cf) * beta,
                                                 0))).numpy()
    assert not (np.abs(draws[1] - p) <= 1e-6).any()


def test_best_is_the_lowest_column_of_the_least_visited_state():
    # Every move rejected (u = 1), no round: the best is the input's least
    # fitness, at the lower of two equal columns in two tiles, with its -0
    # coordinate made +0 -- in the JAX kernel and in the port.
    hw, pos, fit, sigma, beta, (n1, _, us) = pt_inputs("sphere", 512, 3, 1)
    fit[0, 300] = fit[0, 100] = -1.0
    pos[0, 100] = -0.0
    acc = np.ones((1, 512), np.float32)
    args = (pos, fit, sigma, beta, n1, acc, us)
    kw = dict(objective_name="sphere", half_width=hw, tile_n=128,
              rng="host")
    want = jtf.fused_pt_step_t(jnp.asarray([0, 0, 512]),
                               *(jnp.asarray(a) for a in args),
                               interpret=True, **kw)
    got = tf.fused_pt_step_t(torch.tensor([0, 0, 512], dtype=torch.int32),
                             *tt(*args), **kw)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3][0, 0].item() == 0.0 and not np.signbit(got[3][0, 0].item())
    np.testing.assert_array_equal(got[3][1:, 0].numpy(), pos[1:, 100])


def pt_block_oracle(pos, fit, sigma, beta, draws_of, name, hw, tile_n, it0,
                    n_real, swap_every, k):
    """A numpy reference of one k-step launch: the moves, the running best
    per lane, and at each round the parity pairs within each tile from
    np.roll (the first and last lanes out at odd parity, none at or past
    n_real).  Returns (pos, fit, best_fit, best column, swaps per round)."""
    d, n = pos.shape
    nt = n // tile_n
    obj = lambda x: tf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()
    expf = lambda x: tfm.exp_fast(torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32))).numpy()

    def roll(x, shift):
        return np.roll(x.reshape(x.shape[0], nt, tile_n), shift,
                       axis=2).reshape(x.shape[0], n)

    col = np.arange(n)[None, :] % tile_n
    g = np.arange(n)[None, :]
    x, fx = pos.copy(), fit.copy()
    rb, rb_pos = fit.copy(), pos.copy()
    swaps = []
    for step in range(k):
        noise, u_acc, u_swap = draws_of(step)
        cand = np.clip(x + sigma * noise, -hw, hw).astype(np.float32)
        cf = obj(cand)
        acc = u_acc < expf(np.minimum((fx - cf) * beta, 0))
        x, fx = np.where(acc, cand, x), np.where(acc, cf, fx)
        better = fx < rb
        rb, rb_pos = np.where(better, fx, rb), np.where(better, x, rb_pos)
        it = it0 + step + 1
        if it % swap_every:
            continue
        parity = (it // swap_every) % 2
        lower = (col - parity) % 2 == 0
        partner = np.where(lower, g + 1, g - 1)
        valid = ((parity == 0) | ((col >= 1) & (col <= tile_n - 2))) & (
            g < n_real) & (partner < n_real)
        pf = np.where(lower, roll(fx, -1), roll(fx, 1))
        pb = np.where(lower, roll(beta, -1), roll(beta, 1))
        up = np.where(lower, u_swap, roll(u_swap, 1))
        swap = valid & (up < expf(np.minimum((beta - pb) * (fx - pf), 0)))
        x = np.where(swap, np.where(lower, roll(x, -1), roll(x, 1)), x)
        fx = np.where(swap, pf, fx)
        swaps.append(int(swap.sum()))
    j = int(np.argmin(rb[0]))
    return x, fx, rb[0, j], j, rb_pos[:, j] + np.float32(0.0), swaps


@pytest.mark.parametrize("n,tile_n,k,it0,n_real,swap_every", [
    (512, 128, 16, 3, 512, 5), (640, 128, 16, 0, 600, 3),
    (1024, 256, 7, 5, 1000, 1), (512, 128, 1, 4, 500, 5)])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, it0, n_real,
                                                 swap_every):
    d, name = 6, "rastrigin"
    hw, pos, fit, sigma, beta, _ = pt_inputs(name, n, d, k)
    scalars = torch.tensor([21, it0, n_real], dtype=torch.int32)
    got = tf.fused_pt_step_t(scalars, *tt(pos, fit, sigma, beta),
                             objective_name=name, half_width=hw,
                             tile_n=tile_n, swap_every=swap_every,
                             rng="device", k_steps=k, step0=6)
    draws_of = lambda s: [r.numpy() for r in tf.device_draws(  # noqa
        scalars[:1], n, d, 6 + s)]
    x, fx, bf, j, bp, swaps = pt_block_oracle(
        pos, fit, sigma, beta, draws_of, name, hw, tile_n, it0, n_real,
        swap_every, k)
    assert swaps and all(s > 0 for s in swaps)
    np.testing.assert_array_equal(got[0].numpy(), x)
    np.testing.assert_array_equal(got[1].numpy(), fx)
    assert got[2].item() == bf
    np.testing.assert_array_equal(got[3][:, 0].numpy(), bp)


def test_step_rejects_bad_arguments():
    hw, pos, fit, sigma, beta, draws = pt_inputs("sphere", 512, 2, 0)
    args = (torch.tensor([0, 0, 512], dtype=torch.int32),
            *tt(pos, fit, sigma, beta))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tf.fused_pt_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="k_steps=1"):
        tf.fused_pt_step_t(*args, *tt(*draws), rng="host", k_steps=2, **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        tf.fused_pt_step_t(*args, objective_name="sphere", tile_n=100)
    odd = pt_inputs("sphere", 510, 2, 0)
    with pytest.raises(ValueError, match="even"):
        tf.fused_pt_step_t(torch.tensor([0, 0, 510], dtype=torch.int32),
                           *tt(*odd[1:5]), objective_name="sphere",
                           tile_n=255)
    before = tf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.fused_pt_step_cuda(*args, **kw)
    assert tf.LAUNCHES == before
    assert tf.halo(16, 5) == 4 and tf.halo(1, 5) == 1 and tf.halo(16, 1) == 16
    assert tf.kernel_block(30, 4) == 128 and tf.kernel_block(361, 16) == 0
    assert tf.pt_pallas_supported("rastrigin", torch.float32, 360)
    assert not tf.pt_pallas_supported("rastrigin", torch.float32, 361)
    assert not tf.pt_pallas_supported("rastrigin", torch.bfloat16)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,tile_n,steps", [("sphere", 700, 128, 6),
                                                 ("rastrigin", 1024, None,
                                                  5)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n, steps):
    d = 4
    jfn, hw = jobj.get_objective(name)
    js = jpt.pt_init(jfn, n, d, hw, seed=n)
    ts = tpt.pt_state_from_numpy(to_numpy(js), device="cpu")
    tile = tile_n or 1024
    n_pad = -(-n // tile) * tile
    host_key = jax.random.fold_in(js.key, 0x9E)
    draws = [tt(*jtf.host_draws(host_key, i, (d, n_pad), (1, n_pad)))
             for i in range(steps)]
    want = jtf.fused_pt_run(js, name, steps, half_width=hw, tile_n=tile_n,
                            rng="host", interpret=True)
    got = tf.fused_pt_run(ts, name, steps, half_width=hw, tile_n=tile_n,
                          rng="host", uniforms=draws)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, hw, name)


def test_fused_run_converges_monotone_and_pads():
    # The JAX package's cases (tests/test_pallas_tempering.py).
    fn, hw = tobj.get_objective("sphere")
    st = tpt.pt_init(fn, 1000, 6, hw, seed=0, device="cpu")
    out = tf.fused_pt_run(st, "sphere", 300, half_width=hw)
    assert out.pos.shape == (1000, 6) and int(out.iteration) == 300
    assert float(out.best_fit) < 0.05
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    assert torch.equal(out.temps, st.temps)
    quiet = tf.fused_pt_run(tpt.pt_init(fn, 512, 4, hw, seed=2,
                                        device="cpu"), "sphere", 7,
                            half_width=hw, swap_every=100)
    assert int(quiet.iteration) == 7
    rfn, _ = tobj.get_objective("rastrigin")
    s = tpt.pt_init(rfn, 512, 6, hw, seed=3, device="cpu")
    prev = float(s.best_fit)
    for _ in range(3):
        s = tf.fused_pt_run(s, "rastrigin", 10, half_width=hw)
        assert float(s.best_fit) <= prev + 1e-6
        prev = float(s.best_fit)
    runs = [tf.fused_pt_run(tpt.pt_state_from_numpy(
        tpt.pt_state_to_numpy(s), device="cpu", seed=4), "rastrigin", 25,
        half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    padded = tpt.pt_init(fn, 700, 5, hw, seed=2, device="cpu")
    out = tf.fused_pt_run(padded, "sphere", 40, half_width=hw)
    assert out.pos.shape == (700, 5)
    assert float(out.best_fit) <= float(padded.best_fit) + 1e-6


def test_model_backend_switch_and_cli(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.ParallelTempering("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.ParallelTempering("sphere", n=1024, dim=4, seed=0,
                                 use_pallas=True, device="cpu")
    opt.run(200)
    assert opt.best < 0.1
    assert tdsa.ParallelTempering("sphere", n=128, dim=2,
                                  device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.ParallelTempering("sphere", n=64, dim=4, use_pallas=True,
                               device="cpu")
    with pytest.raises(ValueError):
        tdsa.ParallelTempering(tobj.sphere, n=1024, dim=4, use_pallas=True,
                               device="cpu")
    assert cli_main(["pt", "--device", "cpu", "--objective", "sphere",
                     "--n", "64", "--dim", "4", "--steps", "40"]) == 0
    out = capsys.readouterr().out
    assert '"path": "portable"' in out and '"chains": 64' in out
