"""The port's firefly algorithm (``ops/firefly.py``, kernel B19's plain
version in ``ops/cuda/firefly_fused.py``, the ``Firefly`` model and the CLI)
against the JAX package.

The same numpy inputs go through the JAX function and the port's: the
attraction of the TPU kernel in interpret mode (``interpret=True``, as
``tests/test_pallas_firefly.py`` runs it) against the port's plain version,
the portable step and the fused run with the walk uniforms of JAX's own key
chain handed in, and the model cases of ``tests/test_firefly_cuckoo_woa.py``
on the port's CPU path.

Tolerances, each with its reason:

- the attraction against the TPU kernel: the reference's own band, ``rtol =
  1e-4, atol = 1e-5`` (``tests/test_pallas_firefly.py``), and the port's
  tighter one, ``2e-6 + 4 ulps (|x_i|^2 + max_j |x_j|^2)`` of
  ``sum_j |W_ij x_j| + (sum_j W_ij) |x_i|`` (``attraction_abs_sum``): the
  Gram identity leaves r^2 a few ulps of ``|x_i|^2 + |x_j|^2`` from exact in
  each library (XLA contracts the products into multiply-adds), which moves
  W by gamma (= 1) times that, relatively; the polynomial exponentials
  differ by a few ulps and the sums run in another order;
- a step's positions within ``4e-6`` of that sum plus ``1e-5``: the move's
  band, and the walk's product by the decayed scale, whose ``pow`` is each
  library's own; three steps three times that; fitness ``2e-5`` of its
  scale, the JAX package's band for its objectives, on sphere, whose
  gradient is small at these positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.models.firefly import Firefly as JFirefly
from distributed_swarm_algorithm_tpu.ops import firefly as jf
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import firefly_fused as jff
from distributed_swarm_algorithm_tpu_torch.cli import main as cli_main
from distributed_swarm_algorithm_tpu_torch.ops import firefly as tf
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import firefly_fused as tff

HW = 5.12
FIELDS = tf.FIREFLY_TENSOR_FIELDS
REF_BAND = dict(rtol=1e-4, atol=1e-5)
MOVE_BAND = 2e-6


def swarm(n, d, seed, scale=0.05, name="rastrigin"):
    """(pos, fit) as numpy: uniform in +-HW * scale, so that many pairs
    attract (at the full domain exp(-r^2) is 0 for almost every pair)."""
    g = np.random.default_rng(seed)
    pos = (g.uniform(-HW, HW, (n, d)) * scale).astype(np.float32)
    fit = np.asarray(getattr(jobj, name)(jnp.asarray(pos)))
    return pos, np.array(fit, np.float32)


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def jax_noises(key, n, d, steps):
    """The walk uniforms of ``steps`` generations from JAX's key chain."""
    out = []
    for _ in range(steps):
        key, kr = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.uniform(kr, (n, d), jnp.float32))))
    return out


def to_port(js):
    return tf.firefly_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")


def assert_move_close(got, want, absum, pos, pos_j=None, label=""):
    np.testing.assert_allclose(got, want, **REF_BAND, err_msg=label)
    sq = (pos.astype(np.float64) ** 2).sum(1)
    sq_j = sq if pos_j is None else (pos_j.astype(np.float64) ** 2).sum(1)
    rel = MOVE_BAND + 4 * 2.0 ** -24 * (sq + sq_j.max())[:, None]
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= rel * absum + 1e-7).all(), (
        label, (err / (absum + 1e-30)).max())


def test_constants_are_the_jax_packages():
    assert (tf.BETA0, tf.GAMMA, tf.ALPHA0, tf.ALPHA_DECAY) == (
        jf.BETA0, jf.GAMMA, jf.ALPHA0, jf.ALPHA_DECAY)


def test_kernel_order_and_envelope():
    # Lanes a row takes, the band, and the grouped sums: groups of 32
    # dimensions summed in order, the groups combined as a pairwise tree
    # (D = 70: three groups and an empty fourth).
    assert [tff.lanes_per_row(d) for d in (0, 1, 32, 33, 64, 65, 100, 128,
                                           129)] == [0, 1, 1, 2, 2, 4, 4, 4, 0]
    assert tff.attraction_band(65536) == (64 + 1024 + 4) * 2.0 ** -24
    assert tff.firefly_cuda_supported(torch.float32, 100)
    assert not tff.firefly_cuda_supported(torch.float32, 129)
    assert not tff.firefly_cuda_supported(torch.bfloat16, 4)
    x = np.random.default_rng(0).standard_normal((5, 70)).astype(np.float32)
    parts = []
    for g in range(4):
        p = np.zeros(5, np.float32)
        for d in range(32 * g, min(70, 32 * g + 32)):
            p = p + x[:, d] * x[:, d]
        parts.append(p)
    want = (parts[0] + parts[1]) + (parts[2] + parts[3])
    np.testing.assert_array_equal(tff.sq_norms(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("n,d,seed,scale", [
    (600, 8, 0, 0.05),     # test_attraction_matches_portable's shape
    (300, 5, 1, 0.05),     # test_attraction_pads_non_aligned's
    (256, 30, 2, 0.02),
    (200, 40, 3, 0.02),    # two lanes a row
    (130, 100, 4, 0.01),   # four lanes a row
    (127, 3, 5, 1.0),      # the whole domain: few pairs attract
    (1, 6, 6, 0.05),       # one firefly: nothing brighter
])
def test_plain_attraction_matches_the_tpu_kernel(n, d, seed, scale):
    pos, fit = swarm(n, d, seed, scale)
    want = np.asarray(jff.firefly_attraction_pallas(
        jnp.asarray(pos), jnp.asarray(fit), interpret=True))
    got = tff.firefly_attraction(*tt(pos, fit))
    assert got.shape == (n, d) and got.dtype == torch.float32
    absum = tff.attraction_abs_sum(*tt(pos, fit)).numpy()
    assert_move_close(got.numpy(), want, absum, pos, label=f"n={n} d={d}")
    # ...and the JAX package's portable formula, as its test holds it.
    sq = jnp.sum(jnp.asarray(pos) ** 2, axis=1)
    r2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
    w = jnp.where(fit[None, :] < fit[:, None],
                  jnp.exp(-jnp.maximum(r2, 0.0)), 0.0)
    portable = np.asarray(w @ pos - jnp.sum(w, axis=1, keepdims=True) * pos)
    np.testing.assert_allclose(got.numpy(), portable, **REF_BAND)
    if n == 1:
        assert not got.abs().any()


def test_rectangular_form_and_equal_fits():
    # Rows attracted by another swarm (the sharded driver's form), with
    # fitness ties: equal fitness gives no attraction (the strict <).
    pos, fit = swarm(150, 7, 7, 0.05)
    pos_j, fit_j = swarm(333, 7, 8, 0.05)
    fit = np.round(fit)                     # ties within each swarm
    fit_j = np.round(fit_j)
    want = np.asarray(jff.firefly_attraction_pallas(
        jnp.asarray(pos), jnp.asarray(fit), interpret=True,
        pos_j=jnp.asarray(pos_j), fit_j=jnp.asarray(fit_j)))
    args = tt(pos, fit)
    kw = dict(zip(("pos_j", "fit_j"), tt(pos_j, fit_j)))
    got = tff.firefly_attraction(*args, **kw).numpy()
    assert got.shape == (150, 7)
    assert_move_close(got, want, tff.attraction_abs_sum(*args, **kw).numpy(),
                      pos, pos_j)
    counts = {}
    tff.firefly_attraction_plain(*args, **kw, counts=counts)
    assert int(sum(counts["brighter"])) == int(
        (fit_j[None, :] < fit[:, None]).sum())
    # All fits equal: no row has a brighter source, every move is 0.
    flat = np.full(150, 3.0, np.float32)
    zero = tff.firefly_attraction(*tt(pos, flat))
    assert not zero.abs().any()


def test_portable_step_matches_jax():
    js = jf.firefly_init(jobj.sphere, 128, 6, HW, seed=3)
    js = js.replace(pos=js.pos * 0.1, fit=jobj.sphere(js.pos * 0.1))
    ts = to_port(js)
    absum = float(tff.attraction_abs_sum(ts.pos, ts.fit).max())
    band = dict(rtol=0, atol=4e-6 * absum + 1e-5)
    noises = jax_noises(js.key, 128, 6, 3)
    want = jf.firefly_step(js, jobj.sphere, HW)
    got = tf.firefly_step(ts, tobj.sphere, HW, noise=noises[0])
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **band)
    np.testing.assert_allclose(got.fit.numpy(), np.asarray(want.fit),
                               rtol=2e-5, atol=2e-5)
    assert int(got.iteration) == 1
    want = jf.firefly_run(js, jobj.sphere, 3, half_width=HW)
    got = tf.firefly_run(ts, tobj.sphere, 3, half_width=HW, noises=noises)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=3 * band["atol"])
    np.testing.assert_allclose(float(got.best_fit), float(want.best_fit),
                               rtol=2e-5, atol=2e-5)
    assert int(got.iteration) == int(want.iteration) == 3


def test_fused_run_matches_the_jax_fused_run():
    js = jf.firefly_init(jobj.sphere, 256, 6, HW, seed=2)
    js = js.replace(pos=js.pos * 0.1, fit=jobj.sphere(js.pos * 0.1))
    ts = to_port(js)
    absum = float(tff.attraction_abs_sum(ts.pos, ts.fit).max())
    want = jff.fused_firefly_run(js, jobj.sphere, 3, half_width=HW,
                                 interpret=True)
    got = tff.fused_firefly_run(ts, tobj.sphere, 3, half_width=HW,
                                noises=jax_noises(js.key, 256, 6, 3))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=3 * (4e-6 * absum + 1e-5))
    for f in ("fit", "best_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=2e-5,
                                   atol=2e-5)
    assert int(got.iteration) == 3
    # The fused run with its own draws keeps the update rule: the best
    # never rises and every position stays inside the domain.
    run = tff.fused_firefly_run(ts, tobj.rastrigin, 20, half_width=HW)
    assert float(run.best_fit) <= float(ts.best_fit)
    assert float(run.pos.abs().max()) <= np.float32(HW)
    with pytest.raises(ValueError, match="float32"):
        tff.fused_firefly_run(
            ts.replace(pos=ts.pos.double(), fit=ts.fit.double()),
            tobj.sphere, 1)


# --------------------------------------------------------------------------
# The model cases of tests/test_firefly_cuckoo_woa.py, on the port's CPU path
# --------------------------------------------------------------------------


def test_firefly_converges_on_sphere():
    opt = tdsa.Firefly("sphere", n=64, dim=4, seed=0, device="cpu")
    opt.run(150)
    assert opt.best < 1e-2


def test_firefly_best_is_monotone():
    st = tf.firefly_init(tobj.sphere, 32, 5, 5.12, seed=1, device="cpu")
    prev = float(st.best_fit)
    for _ in range(20):
        st = tf.firefly_step(st, tobj.sphere, 5.12)
        cur = float(st.best_fit)
        assert cur <= prev
        prev = cur


def test_firefly_attraction_pulls_dimmer_toward_brighter():
    # Two fireflies, no noise (alpha0 = 0): the dimmer one moves strictly
    # toward the brighter one; the brighter one does not move.  Both paths.
    st = tf.firefly_init(tobj.sphere, 2, 2, 5.12, seed=0, device="cpu")
    pos = torch.tensor([[0.0, 0.0], [4.0, 0.0]])
    st = st.replace(pos=pos, fit=tobj.sphere(pos))
    for nxt in (tf.firefly_step(st, tobj.sphere, 5.12, alpha0=0.0),
                tff.fused_firefly_run(st, tobj.sphere, 1, 5.12, alpha0=0.0)):
        assert float(nxt.pos[1, 0]) < 4.0
        np.testing.assert_allclose(nxt.pos[0].numpy(), [0.0, 0.0])


def test_firefly_positions_stay_in_domain():
    st = tf.firefly_run(tf.firefly_init(tobj.sphere, 48, 3, 2.0, seed=2,
                                        device="cpu"), tobj.sphere, 40,
                        half_width=2.0)
    assert float(st.pos.abs().max()) <= 2.0
    np.testing.assert_allclose(tobj.sphere(st.pos).numpy(), st.fit.numpy(),
                               atol=1e-5)


def test_firefly_seeded_deterministic_and_run_matches_stepped():
    a = tdsa.Firefly("rastrigin", n=32, dim=4, seed=7, device="cpu")
    b = tdsa.Firefly("rastrigin", n=32, dim=4, seed=7, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best == b.best
    st = tf.firefly_init(tobj.sphere, 16, 3, 5.12, seed=3, device="cpu")
    st2 = tf.firefly_init(tobj.sphere, 16, 3, 5.12, seed=3, device="cpu")
    ran = tf.firefly_run(st, tobj.sphere, 10, half_width=5.12)
    for _ in range(10):
        st2 = tf.firefly_step(st2, tobj.sphere, 5.12)
    np.testing.assert_array_equal(ran.pos.numpy(), st2.pos.numpy())
    assert float(ran.best_fit) == float(st2.best_fit)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_step_takes_the_run_path(use_pallas):
    # step() is run(1): the fused path when it is on (so a full-width state
    # never builds the [N, N] step), the portable step otherwise.
    a = tdsa.Firefly("rastrigin", n=48, dim=5, seed=4, use_pallas=use_pallas,
                     device="cpu")
    b = tdsa.Firefly("rastrigin", n=48, dim=5, seed=4, use_pallas=use_pallas,
                     device="cpu")
    for _ in range(3):
        a.step()
    b.run(3)
    np.testing.assert_array_equal(a.state.pos.numpy(), b.state.pos.numpy())
    assert a.best == b.best and int(a.state.iteration) == 3
    c = tdsa.Firefly("rastrigin", n=48, dim=5, seed=4, use_pallas=use_pallas,
                     device="cpu")
    run = tff.fused_firefly_run if use_pallas else tf.firefly_run
    want = run(c.state, c.objective, 3, c.half_width)
    np.testing.assert_array_equal(a.state.pos.numpy(), want.pos.numpy())


def test_model_backend_switch_and_cli(monkeypatch, capsys):
    # test_pallas_firefly.py's backend switch: the fused path on the CPU
    # runs the kernel's plain version; bf16 state with use_pallas raises.
    opt = tdsa.Firefly("sphere", n=256, dim=4, seed=0, use_pallas=True,
                       device="cpu")
    opt.run(80)
    assert opt.best < 1.0
    assert tdsa.Firefly("sphere", n=64, dim=4,
                        device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.Firefly("sphere", n=256, dim=4, seed=0, dtype=torch.bfloat16,
                     use_pallas=True, device="cpu")
    jopt = JFirefly("sphere", n=256, dim=4, seed=0, use_pallas=True)
    assert jopt.use_pallas
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.Firefly("sphere", n=64, dim=2)
    monkeypatch.undo()
    assert cli_main(["firefly", "--device", "cpu", "--objective", "sphere",
                     "--n", "64", "--dim", "4", "--steps", "20",
                     "--gamma", "0.5", "--alpha0", "0.2"]) == 0
    out = capsys.readouterr().out
    assert '"path": "portable"' in out and '"fireflies": 64' in out
