"""The port's moth-flame optimization (``ops/mfo.py``, kernel B16's plain
version in ``ops/cuda/mfo_fused.py``, the ``MFO`` model) against the JAX
package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (JAX's ``l`` handed in), the TPU kernel in
interpret mode with host-supplied uniforms (``rng="host"``,
``interpret=True``, as ``tests/test_pallas_mfo.py`` runs it) against the
port's plain version, and whole fused runs over several launches with
JAX's own draws, across a flame re-sort (``sort_blocks=2``).  A launch of k
steps (which JAX draws on the TPU only) is held to a numpy reference.

Tolerances, each with its reason:

- positions ``rtol = 1e-5``, ``atol = max(1e-5, 4e-6 hw)``: ``exp`` and
  ``cos`` (portable step) are each library's own, and XLA on the CPU
  contracts ``u (1 - r) + r`` and the Horner steps of ``2^x`` and of the
  cosine polynomial into multiply-adds (fused step): a few ulps of terms
  up to ``2 hw``;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- discrete results are exact: the flame count ``n_flames`` of every
  generation, the own mask, the flame-update mask and the order of every
  re-sort (a stable sort, as ``jnp.argsort``).
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
from distributed_swarm_algorithm_tpu.ops import mfo as jmfo
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import mfo_fused as jmf
from distributed_swarm_algorithm_tpu_torch.ops import mfo as tmfo
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import mfo_fused as tmf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = tmfo.MFO_TENSOR_FIELDS


def pos_tol(hw):
    return dict(rtol=1e-5, atol=max(1e-5, 4e-6 * hw))


def tt(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def to_numpy(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def assert_state_close(got, want, hw, label):
    for f in ("pos", "flame_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   **pos_tol(hw), err_msg=f"{label} {f}")
    for f in ("fit", "flame_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **OBJ_TOL,
                                   err_msg=f"{label} {f}")
    assert int(got.iteration) == int(want.iteration)


def test_constants_and_schedule_are_the_jax_packages():
    assert (tmfo.T_MAX, tmfo.SPIRAL_B) == (jmfo.T_MAX, jmfo.SPIRAL_B)
    # n_flames = round(n - frac (n - 1)) in f32, half to even, and r_lo in
    # 16.16 fixed point, as the JAX package's compiled step computes them
    # (XLA: a product with 1 / t_max and a multiply-add), at every
    # iteration of several horizons.
    for n, t_max in ((1024, 1000), (700, 40), (700, 6), (5, 3),
                     (1_048_576, 1000), (3000, 7), (33, 300)):
        it = np.arange(0, t_max + 3, dtype=np.int32)

        @jax.jit
        def jax_schedule(it):
            t = (it + 1).astype(jnp.float32)
            frac = jnp.clip(t / t_max, 0.0, 1.0)
            return (jnp.round(n - frac * (n - 1)).astype(jnp.int32),
                    jnp.round((-1.0 - frac) * 65536.0).astype(jnp.int32))

        want, want_lo = (np.asarray(a) for a in jax_schedule(it))
        got_frac, got = tmfo.schedule(torch.from_numpy(it), n, t_max,
                                      torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            torch.round((-1.0 - got_frac) * tmf.R_LO_FX).to(torch.int32)
            .numpy(), want_lo)


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_l(js, t_max):
    n, d = js.pos.shape
    _, kl = jax.random.split(js.key)
    t = (js.iteration + 1).astype(js.pos.dtype)
    frac = jnp.clip(t / t_max, 0.0, 1.0)
    return tt(jax.random.uniform(kl, (n, d), js.pos.dtype,
                                 minval=-1.0 - frac, maxval=1.0))[0]


@pytest.mark.parametrize("name,n,d,t_max", [
    ("sphere", 64, 5, 20), ("rastrigin", 32, 4, 10), ("ackley", 48, 3, 6),
    ("griewank", 33, 3, 300)])
def test_portable_step_matches_jax(name, n, d, t_max):
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jmfo.mfo_init(jfn, n, d, hw, seed=n)
    ts = tmfo.mfo_state_from_numpy(to_numpy(js), device="cpu")
    np.testing.assert_array_equal(ts.flame_fit.numpy(),
                                  np.asarray(js.flame_fit))
    for _ in range(8):      # t_max=6 runs past the horizon
        l = jax_l(js, t_max)
        ts = tmfo.mfo_state_from_numpy(to_numpy(js), device="cpu")
        want = jmfo.mfo_step(js, jfn, half_width=hw, t_max=t_max)
        got = tmfo.mfo_step(ts, tfn, half_width=hw, t_max=t_max, l=l)
        assert_state_close(got, want, hw, name)
        # The merge keeps the same flames in the same order.
        order = torch.sort(torch.cat([ts.flame_fit, got.fit]),
                           stable=True).indices[:n].numpy()
        all_pos = np.concatenate([np.asarray(js.flame_pos),
                                  np.asarray(want.pos)])
        np.testing.assert_allclose(np.asarray(want.flame_pos),
                                   all_pos[order], **pos_tol(hw))
        js = want


def test_portable_flames_are_a_sorted_elitist_memory():
    fn, hw = tobj.get_objective("rastrigin")
    st = tmfo.mfo_init(fn, 32, 5, hw, seed=1, device="cpu")
    prev = float(st.flame_fit[0])
    for _ in range(20):
        st = tmfo.mfo_step(st, fn, hw)
        ff = st.flame_fit.numpy()
        assert (np.diff(ff) >= -1e-6).all() and ff[0] <= prev + 1e-7
        prev = float(ff[0])
        np.testing.assert_allclose(fn(st.flame_pos).numpy(), ff, atol=1e-4)
    opt = tdsa.MFO("sphere", n=64, dim=4, seed=0, t_max=300, device="cpu")
    opt.run(300)
    assert opt.best < 1e-2
    sf, _ = tobj.get_objective("sphere")
    st = tmfo.mfo_run(tmfo.mfo_init(sf, 48, 3, 2.0, seed=2, device="cpu"),
                      sf, 50, half_width=2.0)
    assert float(st.pos.abs().max()) <= 2.0 + 1e-6
    assert float(st.flame_pos.abs().max()) <= 2.0 + 1e-6


# --------------------------------------------------------------------------
# Kernel B16's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def mfo_inputs(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-hw, hw, s).astype(np.float32)  # noqa: E731
    pos, flames = u(d, n), u(d, n)
    ffit = np.array(fn(jnp.asarray(flames.T)))[None, :]
    ffit[0, ::9] = np.inf                  # padded flames
    r_l = rng.uniform(size=(d, n)).astype(np.float32)
    return float(hw), pos, flames, ffit, r_l


@pytest.mark.parametrize("name,n,tile_n,n_flames,r_lo", [
    ("sphere", 512, 128, 512, -65536), ("rastrigin", 512, 128, 300, -70000),
    ("griewank", 640, 128, 1, -131072), ("ackley", 1024, 256, 1000, -98304)])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             n_flames, r_lo):
    d = 5
    hw, pos, flames, ffit, r_l = mfo_inputs(name, n, d, n + n_flames)
    last = flames[:, max(n_flames - 1, 0)][:, None].copy()
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n, rng="host")
    want = jmf.fused_mfo_step_t(
        jnp.asarray([0, n_flames, r_lo]), *(jnp.asarray(a) for a in (
            last, pos, flames, ffit, r_l)), interpret=True, **kw)
    got = tmf.fused_mfo_step_t(
        torch.tensor([0, n_flames, r_lo], dtype=torch.int32),
        *tt(last, pos, flames, ffit, r_l), **kw)
    for g, w, tol in zip(got, want, (pos_tol(hw), OBJ_TOL, pos_tol(hw),
                                     OBJ_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    # The flame-update mask, exact; the own mask decides which flame each
    # moth flew around (a clamp-flame moth lands near `last`).
    updated = (got[2].numpy() != flames).any(0)
    np.testing.assert_array_equal(
        updated, (np.asarray(want[2]) != flames).any(0))
    assert updated.any() and not updated.all()
    np.testing.assert_array_equal(got[3].numpy()[0] < ffit[0], updated)


def mfo_block_oracle(pos, flames, ffit, last, draws_of, objective, hw, b,
                     n_flames, r_lo_fx, k):
    """A numpy reference of one k-step launch."""
    d, n = pos.shape
    r_lo = np.float32(r_lo_fx / 65536.0)
    own = np.arange(n)[None, :] < n_flames
    x, fl, ff = pos.copy(), flames.copy(), ffit.copy()
    for s in range(k):
        l = draws_of(s) * (np.float32(1.0) - r_lo) + r_lo
        flame = np.where(own, fl, last)
        x = (np.abs(flame - x) * np.exp(np.float32(b) * l)
             * np.cos(2 * np.pi * l).astype(np.float32) + flame)
        x = np.clip(x, -hw, hw).astype(np.float32)
        fx = objective(x)
        better = fx < ff
        fl = np.where(better, x, fl)
        ff = np.where(better, fx, ff)
    return x, fx, fl, ff


@pytest.mark.parametrize("n,k,n_flames,r_lo", [
    (512, 8, 200, -80000), (640, 11, 640, -65536), (384, 32, 1, -131072)])
def test_device_rng_launch_matches_the_reference(n, k, n_flames, r_lo):
    d, name = 6, "rastrigin"
    hw, pos, flames, ffit, _ = mfo_inputs(name, n, d, k)
    last = flames[:, n_flames - 1][:, None].copy()
    scalars = torch.tensor([21, n_flames, r_lo], dtype=torch.int32)
    got = tmf.fused_mfo_step_t(scalars, *tt(last, pos, flames, ffit),
                               objective_name=name, half_width=hw,
                               tile_n=128, rng="device", k_steps=k, step0=6)
    objective = lambda x: tmf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(x)).numpy()
    ref = mfo_block_oracle(
        pos, flames, ffit, last,
        lambda s: tmf.philox_uniforms(scalars[:1], n, d, 6 + s, 0).numpy(),
        objective, hw, 1.0, n_flames, r_lo, k)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    assert bool((got[3] <= torch.from_numpy(ffit)).all())


def test_step_rejects_bad_arguments():
    hw, pos, flames, ffit, r_l = mfo_inputs("sphere", 256, 2, 0)
    args = (torch.zeros(3, dtype=torch.int32),
            *tt(flames[:, :1].copy(), pos, flames, ffit))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        tmf.fused_mfo_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        tmf.fused_mfo_step_t(*args, objective_name="sphere", tile_n=100)
    before = tmf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmf.fused_mfo_step_cuda(*args, **kw)
    assert tmf.LAUNCHES == before
    assert tmf.mfo_pallas_supported("rastrigin", torch.float32, 908)
    assert not tmf.mfo_pallas_supported("rastrigin", torch.float32, 909)
    assert tmf.kernel_block(30) == 128


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,tile_n,steps,t_max", [
    ("sphere", 700, 128, 5, 6), ("rastrigin", 1024, 256, 6, 40)])
def test_fused_run_matches_jax_across_a_resort(name, n, tile_n, steps,
                                               t_max):
    d = 4
    jfn, hw = jobj.get_objective(name)
    js = jmfo.mfo_init(jfn, n, d, hw, seed=n)
    ts = tmfo.mfo_state_from_numpy(to_numpy(js), device="cpu")
    _, n_pad = family.lane_tiling(n, tile_n, d)
    host_key = jax.random.fold_in(js.key, 0x3F0)
    uniforms = [tt(jax.random.uniform(jax.random.fold_in(host_key, i),
                                      (d, n_pad), jnp.float32))[0]
                for i in range(steps)]
    kw = dict(half_width=hw, t_max=t_max, tile_n=tile_n, rng="host",
              sort_blocks=2)
    want = jmf.fused_mfo_run(js, name, steps, interpret=True, **kw)
    got = tmf.fused_mfo_run(ts, name, steps, uniforms=uniforms, **kw)
    assert got.pos.shape == (n, d) and got.flame_pos.shape == (n, d)
    assert_state_close(got, want, hw, name)
    # The final re-sort's order: the flames' fitness ascending, stable.
    assert (np.diff(got.flame_fit.numpy()) >= 0).all()


def test_fused_run_converges_monotone_and_pads():
    fn, hw = tobj.get_objective("sphere")
    st = tmfo.mfo_init(fn, 1024, 6, hw, seed=0, device="cpu")
    out = tmf.fused_mfo_run(st, "sphere", 150, half_width=hw, t_max=150,
                            rng="host")
    assert out.pos.shape == (1024, 6) and int(out.iteration) == 150
    assert float(out.flame_fit[0]) < 1e-3
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert (np.diff(out.flame_fit.numpy()) >= -1e-6).all()
    rfn, _ = tobj.get_objective("rastrigin")
    s0 = tmfo.mfo_init(rfn, 512, 6, hw, seed=3, device="cpu")
    prev, s = float(s0.flame_fit[0]), s0
    for _ in range(3):
        s = tmf.fused_mfo_run(s, "rastrigin", 10, half_width=hw, t_max=30)
        assert float(s.flame_fit[0]) <= prev + 1e-6
        prev = float(s.flame_fit[0])
    runs = [tmf.fused_mfo_run(tmfo.mfo_state_from_numpy(
        tmfo.mfo_state_to_numpy(s0), device="cpu", seed=4), "rastrigin", 25,
        half_width=hw, t_max=25) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    p = tmfo.mfo_init(fn, 700, 5, hw, seed=2, device="cpu")  # not aligned
    out = tmf.fused_mfo_run(p, "sphere", 40, half_width=hw, t_max=40)
    assert out.pos.shape == (700, 5) and out.flame_pos.shape == (700, 5)
    assert float(out.flame_fit[0]) <= float(p.flame_fit[0]) + 1e-6


def test_model_backend_switch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.MFO("sphere", n=128, dim=2)
    monkeypatch.undo()
    # One step a launch, as the JAX package's model runs on the CPU (host
    # draws): the flames re-sort every 8 steps.
    opt = tdsa.MFO("sphere", n=512, dim=4, t_max=80, seed=0,
                   use_pallas=True, device="cpu", steps_per_kernel=1)
    opt.run(80)
    assert opt.best < 1e-2
    assert tdsa.MFO("sphere", n=16, dim=2, device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.MFO(tobj.sphere, n=512, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError, match="t_max"):
        tdsa.MFO("sphere", n=16, dim=2, t_max=0, device="cpu")
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda.mfo_fused"
            " as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


# --------------------------------------------------------------------------
# The fixed point of kernel B16's redesign: an own moth equal to its flame,
# the flame inside the domain, stays so at every step (csrc/mfo_fused.cu)
# --------------------------------------------------------------------------


def fixed_point_inputs(name, n, d, n_flames, seed):
    """A launch's operands where about half the moths equal their flames:
    one own moth with a flame component of -0 beside its +0, one own moth
    equal to a flame outside the domain, and moths past ``n_flames``."""
    fn, hw = jobj.get_objective(name)
    g = np.random.default_rng(seed)
    pos = g.uniform(-hw, hw, (d, n)).astype(np.float32)
    flames = g.uniform(-hw, hw, (d, n)).astype(np.float32)
    same = np.nonzero(g.uniform(size=n) < 0.5)[0]
    pos[:, same] = flames[:, same]
    flames[0, same[0]], pos[0, same[0]] = -0.0, 0.0
    flames[1, same[1]] = pos[1, same[1]] = 2 * hw
    ffit = np.array(fn(jnp.asarray(flames.T)))[None, :]
    ffit[0, ::9] = np.inf
    last = flames[:, n_flames - 1][:, None].copy()
    assert same[1] < n_flames and (same >= n_flames).any()
    return float(hw), pos, flames, ffit, last, same


def test_fixed_point_rule_holds_in_the_tpu_kernel():
    # Two chained launches of the TPU kernel in interpret mode, host draws:
    # the moths the rule stops at the start come out value-equal to their
    # input (-0 == +0), an own moth that improves its flame in the first
    # launch comes out of the second as the first made it, and the moth at
    # a flame outside the domain and those past n_flames move.  The plain
    # version agrees with both launches.
    name, n, d, tile_n, n_flames, r_lo = "rastrigin", 512, 5, 128, 300, -70000
    hw, pos, flames, ffit, last, same = fixed_point_inputs(name, n, d,
                                                           n_flames, 9)
    g = np.random.default_rng(10)
    draws = [g.uniform(size=(d, n)).astype(np.float32) for _ in range(2)]
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n, rng="host")
    scalars = [0, n_flames, r_lo]
    launches, ins = [], (pos, flames, ffit)
    for r in draws:
        want = [np.asarray(a) for a in jmf.fused_mfo_step_t(
            jnp.asarray(scalars), *(jnp.asarray(a) for a in (last, *ins, r)),
            interpret=True, **kw)]
        got = tmf.fused_mfo_step_t(torch.tensor(scalars, dtype=torch.int32),
                                   *tt(last, *ins, r), **kw)
        for gv, w, tol in zip(got, want, (pos_tol(hw), OBJ_TOL, pos_tol(hw),
                                          OBJ_TOL)):
            np.testing.assert_allclose(gv.numpy(), w, **tol)
        launches.append(want)
        ins = (want[0], want[2], want[3])
    own = torch.arange(n)[None, :] < n_flames
    stopped = tmf.at_fixed_point(own, *tt(pos, flames), hw,
                                 tmfo.SPIRAL_B).numpy()[0]
    assert stopped[same[0]] and not stopped[same[1]]
    assert 0 < stopped.sum() < len(same)
    f_flames = np.asarray(jobj.get_objective(name)[0](jnp.asarray(
        flames.T)))
    for w in launches:
        np.testing.assert_array_equal(w[0][:, stopped], flames[:, stopped])
        np.testing.assert_array_equal(w[2][:, stopped], flames[:, stopped])
        np.testing.assert_allclose(w[1][0, stopped], f_flames[stopped],
                                   **OBJ_TOL)
        np.testing.assert_allclose(
            w[3][0, stopped], np.where(f_flames < ffit[0], f_flames,
                                       ffit[0])[stopped], **OBJ_TOL)
    first, second = launches
    improved = own.numpy()[0] & ~stopped & (first[3][0] < ffit[0])
    assert improved.any()
    for out in (second[0], second[2], first[2]):
        np.testing.assert_array_equal(out[:, improved],
                                      first[0][:, improved])
    # After the first launch the rule stops both kinds.
    again = tmf.at_fixed_point(own, *tt(first[0], first[2]), hw,
                               tmfo.SPIRAL_B).numpy()[0]
    assert (again[stopped | improved]).all()
    moved = (first[0] != pos).any(0)
    assert moved[same[1]] and moved[same[same >= n_flames]].all()


def frozen_launch(scalars, last, pos, flames, flame_fit, r_l=None, *,
                  objective_name, half_width=5.12, b=tmfo.SPIRAL_B,
                  tile_n=4096, rng="device", k_steps=1, step0=0,
                  stopped=None):
    """The kernel's schedule in PyTorch: a moth at the fixed point at the
    start evaluated once, an own moth frozen after the step that improves
    its flame, the others stepped k times; handed draws take every step.
    ``stopped`` (a list) collects the moths that never moved."""
    objective_t = tmf.OBJECTIVES_T[objective_name]
    n = pos.shape[1]
    own = torch.arange(n)[None, :] < scalars[1]
    live = ~tmf.at_fixed_point(own, pos, flames, half_width, b)
    if rng == "host":
        live = torch.ones_like(live)
    if stopped is not None:
        stopped.append(int((~live).sum()))
    stops = own & tmf.can_stop(half_width, b)
    fit = objective_t(flames)
    flame_fit = torch.where(~live & (fit < flame_fit), fit, flame_fit)
    for step in range(k_steps):
        x, fx, _, _ = tmf.mfo_steps_plain(
            scalars, last, pos, flames, flame_fit,
            r_l if rng == "host" else None, objective_name, half_width, b,
            tile_n, 1, step0 + step)
        pos = torch.where(live, x, pos)
        fit = torch.where(live, fx, fit)
        better = live & (fit < flame_fit)
        flames = torch.where(better, pos, flames)
        flame_fit = torch.where(better, fit, flame_fit)
        live = live & ~(better & stops)
    return pos, fit, flames, flame_fit


@pytest.mark.parametrize("k", range(1, 9))
def test_frozen_schedule_equals_the_plain_version(k):
    name, n, d, n_flames = "rastrigin", 640, 6, 500
    hw, pos, flames, ffit, last, _ = fixed_point_inputs(name, n, d,
                                                        n_flames, k)
    args = (torch.tensor([k, n_flames, -90000], dtype=torch.int32),
            *tt(last, pos, flames, ffit))
    kw = dict(objective_name=name, half_width=hw, tile_n=128, k_steps=k,
              step0=3 * k)
    stopped = []
    frozen = frozen_launch(*args, **kw, stopped=stopped)
    counts = {}
    want = tmf.fused_mfo_step_plain(*args, **kw, counts=counts)
    assert all(torch.equal(a, b) for a, b in zip(frozen, want))
    assert stopped[0] == int(counts["stopped_at_start"][0]) > 0
    if k > 1:
        assert int(counts["moving"][-1]) < int(counts["moving"][0])
    # Handed draws: every moth takes the step.
    r_l = torch.from_numpy(np.random.default_rng(k).uniform(
        size=(d, n)).astype(np.float32))
    host = dict(kw, k_steps=1, rng="host")
    assert all(torch.equal(a, b) for a, b in zip(
        frozen_launch(*args, r_l, **host),
        tmf.fused_mfo_step_plain(*args, r_l, **host)))


def test_frozen_schedule_equals_the_plain_run_across_resorts(monkeypatch):
    # Five launches of 8 steps, the flames re-sorted after the second and
    # the fourth, and at the end: a moth stopped in one launch moves again
    # when a re-sort hands it another flame.
    fn, hw = tobj.get_objective("rastrigin")
    s0 = tmfo.mfo_init(fn, 768, 5, hw, seed=7, device="cpu")
    runs, stopped = [], []
    for frozen in (False, True):
        if frozen:
            monkeypatch.setattr(
                tmf, "fused_mfo_step_plain",
                lambda *a, **kw: frozen_launch(*a, **kw, stopped=stopped))
        state = tmfo.mfo_state_from_numpy(tmfo.mfo_state_to_numpy(s0),
                                          device="cpu", seed=4)
        runs.append(tmf.fused_mfo_run(state, "rastrigin", 40, half_width=hw,
                                      t_max=60, tile_n=128, sort_blocks=2))
    for f in FIELDS:
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert len(stopped) == 5 and stopped[1] > stopped[2] < stopped[3]
