"""The port's fused PSO step (kernel B5's plain version) and its run function
against the JAX package.

On the CPU the port's wrapper runs its kernel's plain version; the JAX
package's TPU kernel runs in interpret mode with host-supplied uniforms
(``rng="host"``, ``interpret=True``), the way its own tests run it
(``tests/test_pallas_pso.py``).  Both get the same numpy inputs and the
same uniforms.

Tolerances, each with its reason:

- the transposed objective registry: ``rtol = atol = 2e-5``, the JAX
  package's own band for it.  The port sums over ``d`` row by row and
  never fuses a multiply-add; XLA on the CPU does both differently, by a
  few ulps.
- one fused step: ``pos``/``vel`` within ``rtol = atol = 1e-5``;
  ``bfit``/``bpos`` likewise wherever both sides took the same
  ``fit < bfit`` decision, and the decisions may differ only where
  ``|fit - bfit|`` is inside the objective band.
- the generator: Philox4x32-10 reproduces Random123's known answers
  exactly, and the uniforms do not depend on how the lanes are split.
- whole runs: block by block from the same state with JAX's own host
  uniforms (``host_uniforms`` with ``fold_in(key, 0x5EED)``) and the same
  ``tile_n``: the step's bands; ``iteration`` exact.  Long runs are
  chaotic, so they are held to outcomes (converges, monotone, in domain).
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
from distributed_swarm_algorithm_tpu.ops import pso as jpso
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import pso as tpso
from distributed_swarm_algorithm_tpu_torch.ops.cuda import common as tcommon
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = list(jpf.OBJECTIVES_T)
SEED = torch.tensor([12345], dtype=torch.int32)


def swarm_t(name, n, d, seed):
    """Transposed numpy swarm a few steps into a run."""
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    vel = (0.1 * rng.uniform(-hw, hw, (d, n))).astype(np.float32)
    bpos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    bfit = np.asarray(fn(jnp.asarray(bpos.T)))[None, :]
    gbest = bpos[:, int(np.argmin(bfit[0]))][:, None].copy()
    r1 = rng.uniform(size=(d, n)).astype(np.float32)
    r2 = rng.uniform(size=(d, n)).astype(np.float32)
    return float(hw), gbest, pos, vel, bpos, bfit, r1, r2


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def assert_step_close(got, want, bfit_before, name):
    """The step's bands (module docstring) on (pos, vel, bpos, bfit)."""
    g = [np.asarray(x) for x in got[:4]]
    w = [np.asarray(x) for x in want[:4]]
    np.testing.assert_allclose(g[0], w[0], **TOL, err_msg=f"{name} pos")
    np.testing.assert_allclose(g[1], w[1], **TOL, err_msg=f"{name} vel")
    fn, _ = jobj.get_objective(name)
    fit = np.asarray(fn(jnp.asarray(w[0].T)))[None, :]
    close = np.isclose(fit, bfit_before, **OBJ_TOL)
    took_g, took_w = g[3] != bfit_before, w[3] != bfit_before
    assert ((took_g == took_w) | close).all(), name
    same = (took_g == took_w)[0]
    np.testing.assert_allclose(g[3][:, same], w[3][:, same], **OBJ_TOL,
                               err_msg=f"{name} bfit")
    np.testing.assert_allclose(g[2][:, same], w[2][:, same], **TOL,
                               err_msg=f"{name} bpos")
    return same


@pytest.mark.parametrize("name", NAMES)
def test_transposed_objectives_match_jax(name):
    assert list(tpf.OBJECTIVES_T) == NAMES
    _, hw = jobj.get_objective(name)
    rng = np.random.default_rng(1)
    for scale in (2.0, float(hw)):
        x = rng.uniform(-scale, scale, (12, 64)).astype(np.float32)
        want = np.asarray(jpf.OBJECTIVES_T[name](jnp.asarray(x)))
        got = tpf.OBJECTIVES_T[name](torch.from_numpy(x))
        assert got.shape == (1, 64)
        np.testing.assert_allclose(got.numpy(), want, **OBJ_TOL)
    # ... and the port's own portable registry, as the JAX test holds its.
    fn, _ = tobj.get_objective(name)
    np.testing.assert_allclose(got.numpy()[0],
                               fn(torch.from_numpy(x.T.copy())).numpy(),
                               **OBJ_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_transposed_objectives_at_dim_one(name):
    x = np.linspace(-1.5, 1.5, 7, dtype=np.float32)[None, :]
    want = np.asarray(jpf.OBJECTIVES_T[name](jnp.asarray(x)))
    got = tpf.OBJECTIVES_T[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **OBJ_TOL)


def test_poly_trig_matches_jax():
    t = np.linspace(-40.0, 40.0, 4001, dtype=np.float32)
    for tf, jf in ((tpf._cos2pi, jpf._cos2pi), (tpf._sin2pi, jpf._sin2pi),
                   (tpf._cosx, jpf._cosx), (tpf._sinx, jpf._sinx)):
        np.testing.assert_allclose(tf(torch.from_numpy(t)).numpy(),
                                   np.asarray(jf(jnp.asarray(t))),
                                   rtol=0, atol=2e-6)
    np.testing.assert_allclose(tpf._cos2pi(torch.from_numpy(t)).numpy(),
                               np.cos(2 * np.pi * t.astype(np.float64)),
                               atol=2e-5)


def test_philox_known_answers():
    # Random123's kat_vectors for philox4x32-10.
    for ctr, key, want in (
        (0, 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        (0xffffffff, 0xffffffff,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ):
        c = torch.full((3,), ctr, dtype=torch.int64)
        got = tpf.philox4x32_10(c, c, c, c, key, key)
        assert [int(w[0]) for w in got] == list(want)
    c = [torch.tensor([v], dtype=torch.int64) for v in
         (0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344)]
    got = tpf.philox4x32_10(*c, 0xa4093822, 0x299f31d0)
    assert [int(w[0]) for w in got] == [0xd16cfe09, 0x94fdcceb, 0x5001e420,
                                        0x24126ea1]


def test_philox_uniforms_are_uniform_and_geometry_free():
    u1 = tpf.philox_uniforms(SEED, 4096, 30, 7, 0)
    u2 = tpf.philox_uniforms(SEED, 4096, 30, 7, 1)
    assert u1.shape == (30, 4096) and u1.dtype == torch.float32
    assert 0.0 <= float(u1.min()) and float(u1.max()) < 1.0
    for u in (u1, u2):
        assert abs(float(u.mean()) - 0.5) < 5e-3
        assert abs(float(u.var()) - 1 / 12) < 2e-3
    assert abs(float(((u1 - 0.5) * (u2 - 0.5)).mean())) < 2e-3
    assert not torch.equal(u1, u2)
    # A lane's draws depend on its index, the dimension, the step and the
    # stream only: fewer lanes or dimensions give a prefix.
    small = tpf.philox_uniforms(SEED, 100, 7, 7, 0)
    assert torch.equal(small, u1[:7, :100])
    assert not torch.equal(tpf.philox_uniforms(SEED, 100, 7, 8, 0), small)
    assert not torch.equal(tpf.philox_uniforms(SEED + 1, 100, 7, 7, 0), small)


@pytest.mark.parametrize("track_best", [True, False],
                         ids=["track_best", "no_track_best"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name,
                                                             track_best):
    n, d = 256, 8
    hw, gbest, pos, vel, bpos, bfit, r1, r2 = swarm_t(name, n, d, seed=3)
    want = jpf.fused_pso_step_t(
        jnp.asarray(0), *(jnp.asarray(a) for a in
                          (gbest, pos, vel, bpos, bfit, r1, r2)),
        objective_name=name, half_width=hw, vmax_frac=0.5, tile_n=128,
        rng="host", interpret=True, track_best=track_best)
    got = tpf.fused_pso_step_t(
        SEED, *tt(gbest, pos, vel, bpos, bfit, r1, r2),
        objective_name=name, half_width=hw, vmax_frac=0.5, rng="host",
        track_best=track_best)
    assert len(got) == len(want) == (6 if track_best else 4)
    same = assert_step_close(got, want, bfit, name)
    if track_best and same.all():
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   **OBJ_TOL)
        assert got[4].shape == (1, 1) and got[5].shape == (d, 1)
        assert float(got[4]) == float(got[3].min())
        k = int(np.argmin(got[3].numpy()[0]))
        np.testing.assert_array_equal(got[5].numpy()[:, 0],
                                      got[2].numpy()[:, k])


def test_track_best_takes_the_first_of_equal_minima():
    d, n = 3, 40
    pos = torch.zeros(d, n)
    bpos = torch.arange(d * n, dtype=torch.float32).reshape(d, n)
    bfit = torch.full((1, n), 1e-9)   # every sphere fit is 0 < bfit
    out = tpf.fused_pso_step_t(
        SEED, torch.zeros(d, 1), pos, torch.zeros(d, n), bpos, bfit,
        torch.zeros(d, n), torch.zeros(d, n), objective_name="sphere",
        rng="host", track_best=True)
    assert float(out[4]) == 0.0
    assert torch.equal(out[5][:, 0], out[2][:, 0])


def test_device_rng_block_equals_single_steps_with_its_uniforms():
    n, d, k = 130, 6, 5
    hw, gbest, pos, vel, bpos, bfit, _, _ = swarm_t("rastrigin", n, d, 4)
    args = tt(gbest, pos, vel, bpos, bfit)
    kw = dict(objective_name="rastrigin", half_width=hw, track_best=False)
    block = tpf.fused_pso_step_t(SEED, *args, rng="device", k_steps=k,
                                 step0=11, **kw)
    state = args[1:]
    for s in range(k):
        r1 = tpf.philox_uniforms(SEED, n, d, 11 + s, 0)
        r2 = tpf.philox_uniforms(SEED, n, d, 11 + s, 1)
        state = tpf.fused_pso_step_t(SEED, args[0], *state, r1, r2,
                                     rng="host", **kw)
    for a, b in zip(block, state):
        assert torch.equal(a, b)
    again = tpf.fused_pso_step_t(SEED, *args, rng="device", k_steps=k,
                                 step0=11, **kw)
    other = tpf.fused_pso_step_t(SEED, *args, rng="device", k_steps=k,
                                 step0=12, **kw)
    assert torch.equal(again[0], block[0])
    assert not torch.equal(other[0], block[0])
    assert float(block[0].abs().max()) <= np.float32(hw)


def test_step_rejects_bad_rng_arguments():
    hw, gbest, pos, vel, bpos, bfit, r1, r2 = swarm_t("sphere", 16, 2, 0)
    args = tt(gbest, pos, vel, bpos, bfit)
    kw = dict(objective_name="sphere")
    with pytest.raises(ValueError, match="requires r1 and r2"):
        tpf.fused_pso_step_t(SEED, *args, rng="host", **kw)
    with pytest.raises(ValueError, match="k_steps=1 only"):
        tpf.fused_pso_step_t(SEED, *args, *tt(r1, r2), rng="host",
                             k_steps=2, **kw)
    with pytest.raises(ValueError, match="rng must be"):
        tpf.fused_pso_step_t(SEED, *args, rng="tpu", **kw)


def test_cuda_wrapper_takes_no_cpu_tensor_and_import_builds_nothing():
    hw, gbest, pos, vel, bpos, bfit, r1, r2 = swarm_t("sphere", 16, 2, 0)
    before = tpf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpf.fused_pso_step_cuda(SEED, *tt(gbest, pos, vel, bpos, bfit),
                                objective_name="sphere")
    assert tpf.LAUNCHES == before
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda."
            "pso_fused as m, distributed_swarm_algorithm_tpu_torch.ops."
            "cuda.islands_fused as i; assert m._fn is None and i._fn is "
            "None and m.LAUNCHES == 0 and i.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_kernel_source_is_hand_written():
    src = "".join(
        (REPO / "distributed_swarm_algorithm_tpu_torch" / "csrc" / f)
        .read_text() for f in ("pso_fused.cu", "philox.cuh",
                               "swarm_objectives.cuh"))
    for banned in ("curand", "cublas", "#include <torch", "use_fast_math"):
        assert banned not in src.lower(), banned
    assert "dsa_pso_fused_f32" in src and "dsa_islands_fused_f32" in src
    assert "philox4x32_10" in src
    # The kernel's objective numbers follow the registry's order.
    for i, name in enumerate(NAMES):
        assert tpf.OBJECTIVE_IDS[name] == i
    assert tpf.kernel_block(30) == 128 and tpf.kernel_block(100) == 128
    assert tpf.kernel_block(151) == 128 and tpf.kernel_block(152) == 64
    assert tpf.kernel_block(605) == 32 and tpf.kernel_block(606) == 0


def test_pallas_supported_matrix_and_envelope():
    assert tpf.pallas_supported("rastrigin", torch.float32)
    assert not tpf.pallas_supported("rastrigin", torch.bfloat16)
    assert not tpf.pallas_supported("not_an_objective", torch.float32)
    m = tpf.MICHALEWICZ_DIM_MAX
    assert m == jpf.MICHALEWICZ_DIM_MAX
    assert tpf.pallas_supported("michalewicz", torch.float32, m)
    assert not tpf.pallas_supported("michalewicz", torch.float32, m + 1)
    assert tpf.pallas_supported("michalewicz", torch.float32)
    # Hopper's envelope replaces the TPU's VMEM model: the tile of one
    # block must fit its shared memory.
    assert tpf.pallas_supported("rastrigin", torch.float32, 605)
    assert not tpf.pallas_supported("rastrigin", torch.float32, 606)
    with pytest.raises(ValueError):
        tdsa.PSO(n=64, dim=m + 1, objective="michalewicz", use_pallas=True,
                 device="cpu")
    with pytest.raises(ValueError):
        tdsa.PSO(n=8, dim=606, objective="sphere", use_pallas=True,
                 device="cpu")
    fn, hw = tobj.get_objective("sphere")
    st = tpso.pso_init(fn, 8, 606, hw, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tpf.fused_pso_run(st, "sphere", 1)
    with pytest.raises(ValueError, match="does not cover"):
        tpf.fused_pso_run(st.replace(pos=st.pos.double()), "sphere", 1)


def test_common_helpers_match_jax():
    from distributed_swarm_algorithm_tpu.ops.pallas import common as jcommon

    for x, m in ((0, 8), (1, 8), (300, 128), (4096, 4096)):
        assert tcommon.ceil_to(x, m) == jcommon.ceil_to(x, m)
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for n_pad in (5, 8, 13):
        np.testing.assert_array_equal(
            tcommon.cyclic_pad_rows(torch.from_numpy(x), n_pad).numpy(),
            np.asarray(jcommon.cyclic_pad_rows(jnp.asarray(x), n_pad)))
    with pytest.raises(ValueError, match="n_pad=3"):
        tcommon.cyclic_pad_rows(torch.from_numpy(x), 3)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_host_uniforms(key, call_i, shape):
    """What JAX's ``fused_pso_run(rng="host")`` draws for call ``call_i``."""
    host_key = jax.random.fold_in(key, 0x5EED)
    r1, r2 = jpf.host_uniforms(host_key, call_i, shape)
    return np.array(r1), np.array(r2)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f))
            for f in tpso.PSO_TENSOR_FIELDS}


@pytest.mark.parametrize("name,n", [("sphere", 300), ("rastrigin", 50),
                                    ("rosenbrock", 256)])
def test_fused_run_matches_jax_block_by_block(name, n):
    d, tile_n = 5, 128
    jfn, hw = jobj.get_objective(name)
    n_pad = tpf.padded_width(n, tile_n)
    assert n_pad == {300: 384, 50: 128, 256: 256}[n]
    js = jpso.pso_init(jfn, n=n, dim=d, half_width=hw, seed=n)
    for _ in range(4):
        r1, r2 = jax_host_uniforms(js.key, 0, (d, n_pad))
        ts = tpso.pso_state_from_numpy(to_numpy(js), device="cpu")
        want = jpf.fused_pso_run(js, name, 1, half_width=hw, tile_n=tile_n,
                                 rng="host", interpret=True)
        got = tpf.fused_pso_run(ts, name, 1, half_width=hw, tile_n=tile_n,
                                rng="host",
                                uniforms=tt(r1[None], r2[None]))
        assert int(got.iteration) == int(want.iteration)
        assert got.pos.shape == (n, d)
        same = assert_step_close(
            [getattr(got, f).numpy().T if f != "pbest_fit"
             else got.pbest_fit.numpy()[None] for f in
             ("pos", "vel", "pbest_pos", "pbest_fit")],
            [np.asarray(getattr(want, f)).T if f != "pbest_fit"
             else np.asarray(want.pbest_fit)[None] for f in
             ("pos", "vel", "pbest_pos", "pbest_fit")],
            np.asarray(js.pbest_fit)[None], name)
        if same.all():
            np.testing.assert_allclose(float(got.gbest_fit),
                                       float(want.gbest_fit), **OBJ_TOL)
        js = want


def test_fused_run_matches_jax_over_several_blocks():
    n, d, steps, tile_n = 300, 5, 5, 128
    jfn, hw = jobj.get_objective("sphere")
    js = jpso.pso_init(jfn, n=n, dim=d, half_width=hw, seed=0)
    ts = tpso.pso_state_from_numpy(to_numpy(js), device="cpu")
    draws = [jax_host_uniforms(js.key, i, (d, 384)) for i in range(steps)]
    want = jpf.fused_pso_run(js, "sphere", steps, half_width=hw,
                             tile_n=tile_n, rng="host", interpret=True)
    got = tpf.fused_pso_run(
        ts, "sphere", steps, half_width=hw, tile_n=tile_n, rng="host",
        uniforms=tt(np.stack([r[0] for r in draws]),
                    np.stack([r[1] for r in draws])))
    assert int(got.iteration) == int(want.iteration) == steps
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got.gbest_fit), float(want.gbest_fit),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tile_n", [None, 128], ids=["no_pad", "tile_128"])
def test_fused_run_converges_and_pads(tile_n):
    # n=300 is not a multiple of any tile or block.
    fn, hw = tobj.get_objective("sphere")
    st = tpso.pso_init(fn, n=300, dim=5, half_width=hw, seed=0,
                       device="cpu")
    out = tpf.fused_pso_run(st, "sphere", 103, half_width=hw, tile_n=tile_n)
    assert out.pos.shape == (300, 5) and out.pos.is_contiguous()
    assert int(out.iteration) == 103
    assert float(out.gbest_fit) < 1e-4
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    # gbest is the min over a superset of the real particles' pbest.
    assert float(out.gbest_fit) <= float(out.pbest_fit.min()) + 1e-6
    # steps_per_kernel = 8: 12 full blocks and a remainder of 7.
    host = tpf.fused_pso_run(st, "sphere", 30, half_width=hw, tile_n=tile_n,
                             rng="host")
    assert float(host.gbest_fit) < float(st.gbest_fit)


def test_fused_run_tiny_swarm_pad_exceeds_n():
    fn, hw = tobj.get_objective("sphere")
    st = tpso.pso_init(fn, n=50, dim=5, half_width=hw, seed=1, device="cpu")
    out = tpf.fused_pso_run(st, "sphere", 30, half_width=hw, tile_n=128)
    assert out.pos.shape == (50, 5)
    assert float(out.gbest_fit) <= float(st.gbest_fit) + 1e-6


def test_fused_run_gbest_monotone():
    fn, hw = tobj.get_objective("rastrigin")
    s = tpso.pso_init(fn, n=256, dim=6, half_width=hw, seed=3, device="cpu")
    prev, prev_pbest = float(s.gbest_fit), s.pbest_fit
    for _ in range(4):
        s = tpf.fused_pso_run(s, "rastrigin", 10, half_width=hw)
        assert float(s.gbest_fit) <= prev + 1e-6
        assert bool((s.pbest_fit <= prev_pbest).all())
        prev, prev_pbest = float(s.gbest_fit), s.pbest_fit
    assert int(s.iteration) == 40


def test_fused_run_rejects_uniforms_without_host_rng():
    fn, hw = tobj.get_objective("sphere")
    st = tpso.pso_init(fn, n=16, dim=2, half_width=hw, device="cpu")
    u = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match='rng="host"'):
        tpf.fused_pso_run(st, "sphere", 1, uniforms=(u, u))


def test_pso_model_fused_path_on_cpu_tensors():
    opt = tdsa.PSO("sphere", n=256, dim=4, seed=0, use_pallas=True,
                   device="cpu")
    assert opt.use_pallas is True
    opt.run(60)
    assert opt.best < 1e-3
    assert tdsa.PSO("sphere", n=8, dim=2, device="cpu").use_pallas is False


def test_pso_model_rejects_fused_path_for_callable_objective():
    with pytest.raises(ValueError):
        tdsa.PSO(tobj.sphere, n=64, dim=4, seed=0, use_pallas=True,
                 device="cpu")
    with pytest.raises(ValueError):
        tdsa.PSO("sphere", n=64, dim=4, topology="ring", use_pallas=True,
                 device="cpu")
