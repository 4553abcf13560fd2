"""The port's whale optimizer (``ops/woa.py``, kernel B11's plain version in
``ops/cuda/woa_fused.py``, the ``WOA`` model) against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step, the TPU kernel in interpret mode with
host-supplied uniforms (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_woa.py`` runs it) against the port's plain version,
and whole fused runs over several launches with JAX's own tile and lane
shifts.  The peer comes from another tile, rolled within it, so the cases
hold several tiles (``tile_n=128``, N up to 512) and shifts that wrap.  A
launch of k steps (which JAX draws on the TPU only) is held to a numpy
reference of the same semantics.

Tolerances, each with its reason:

- positions ``rtol = atol = 1e-5``: a handful of products and sums, and
  ``exp``/``cos`` of the spiral, whose last bit is each library's; where
  the update cancels (``prey - A |C prey - x|``, terms up to ``4 hw``), an
  absolute band of a few ulps of the largest term, ``4e-6 hw``.
- fitness ``2e-5``, the JAX package's own band for its objectives.
- the explore mask ``|A| >= 1`` and the peer each element reads follow a
  numpy reference with ``np.roll`` (the other direction fails it); the
  values those elements take carry the position band (XLA on the CPU
  fuses the multiply-add in ``prey - A |C prey - x|``).
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
from distributed_swarm_algorithm_tpu.ops import woa as jwoa
from distributed_swarm_algorithm_tpu.ops.pallas import de_fused as jde
from distributed_swarm_algorithm_tpu.ops.pallas import pso_fused as jpf
from distributed_swarm_algorithm_tpu.ops.pallas import woa_fused as jwf
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import woa as twoa
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import pso_fused as tpf
from distributed_swarm_algorithm_tpu_torch.ops.cuda import woa_fused as twf

REPO = Path(__file__).resolve().parent.parent
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def pos_tol(hw):
    return dict(rtol=1e-5, atol=max(1e-5, 4e-6 * hw))
FIELDS = twoa.WOA_TENSOR_FIELDS


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


def test_lane_shifts_are_the_jax_packages():
    assert twf.LANE_SHIFTS == jde._LANE_SHIFTS


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "ackley"])
def test_portable_step_matches_jax(name):
    n, d = 64, 5
    jfn, hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    js = jwoa.woa_init(jfn, n, d, hw, seed=4)
    for _ in range(4):
        _, kr, kp, kl, kq = jax.random.split(js.key, 5)
        draws = tt(jax.random.uniform(kr, (2, n, d), jnp.float32),
                   jax.random.uniform(kp, (n, 1), jnp.float32),
                   jax.random.uniform(kl, (n, 1), jnp.float32, minval=-1.0,
                                      maxval=1.0),
                   jax.random.randint(kq, (n,), 0, n))
        ts = twoa.woa_state_from_numpy(to_numpy(js), device="cpu")
        want = jwoa.woa_step(js, jfn, half_width=hw, t_max=6)
        got = twoa.woa_step(ts, tfn, half_width=hw, t_max=6, draws=draws)
        assert_state_close(got, want, name)
        js = want


def test_portable_run_converges():
    fn, hw = tobj.get_objective("sphere")
    st = twoa.woa_init(fn, 128, 4, hw, seed=0, device="cpu")
    out = twoa.woa_run(st, fn, 80, half_width=hw, t_max=80)
    assert float(out.best_fit) < 1e-2 and int(out.iteration) == 80
    with pytest.raises(ValueError, match="t_max"):
        twoa.woa_step(st, fn, t_max=0)


# --------------------------------------------------------------------------
# Kernel B11's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def pod_t(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))
    best = pos[:, int(np.argmin(fit))][:, None].copy()
    draws = [rng.uniform(size=s).astype(np.float32)
             for s in ((d, n), (d, n), (1, n), (1, n))]
    return float(hw), best, pos, draws


def woa_block_oracle(pos, best, draws_of, hw, t_max, b, tile_n, t0, tshift,
                     lshift, k):
    """A numpy reference of one k-step launch: the peer of lane j in tile i
    is lane (j - s) mod tile_n of tile (i + tshift) mod n_tiles of the
    launch's input, s = lshift + LANE_SHIFTS[step % 8][0] (np.roll's
    direction).  Returns the positions and the explore masks."""
    d, n = pos.shape
    n_tiles = n // tile_n
    src = pos.reshape(d, n_tiles, tile_n)[:, (np.arange(n_tiles) + tshift)
                                          % n_tiles, :]
    x = pos.copy()
    masks = []
    for s in range(k):
        u_a, u_c, u_p, u_l = draws_of(s)
        a = np.float32(2.0) * (np.float32(1.0) - np.minimum(
            np.float32(t0 + s) / np.float32(t_max), np.float32(1.0)))
        big_a = 2.0 * a * u_a - a
        big_c = 2.0 * u_c
        shift = lshift + twf.LANE_SHIFTS[s % 8][0]
        peer = np.roll(src, shift, axis=2).reshape(d, n)
        explore = np.abs(big_a) >= 1.0
        prey = np.where(explore, peer, best)
        contract = prey - big_a * np.abs(big_c * prey - x)
        ll = 2.0 * u_l - 1.0
        spiral = (np.abs(best - x) * np.exp(b * ll) * np.cos(2 * np.pi * ll)
                  + best)
        x = np.clip(np.where(u_p < 0.5, contract, spiral), -hw,
                    hw).astype(np.float32)
        masks.append(explore & (u_p < 0.5))
    return x, masks


@pytest.mark.parametrize("name,n,tile_n,shifts", [
    ("sphere", 256, 256, (0, 0, 0)), ("rastrigin", 512, 128, (3, 5, 100)),
    ("griewank", 384, 128, (1, 50, 127)), ("schwefel", 512, 128, (2, 1, 3))])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             shifts):
    d = 5
    tshift, t0, lshift = shifts
    hw, best, pos, draws = pod_t(name, n, d, n + t0)
    want = jwf.fused_woa_step_t(
        jnp.asarray([0, tshift, t0, lshift]), jnp.asarray(best),
        jnp.asarray(pos), *(jnp.asarray(r) for r in draws),
        objective_name=name, half_width=hw, t_max=300, tile_n=tile_n,
        rng="host", interpret=True)
    got = twf.fused_woa_step_t(
        torch.tensor([0, tshift, t0, lshift], dtype=torch.int32),
        *tt(best, pos, *draws), objective_name=name, half_width=hw,
        t_max=300, tile_n=tile_n, rng="host")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **pos_tol(hw))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    # The peer and the explore mask, with jnp.roll's direction.
    ref, masks = woa_block_oracle(pos, best, lambda s: draws, hw, 300, 1.0,
                                  tile_n, t0, tshift, lshift, 1)
    assert masks[0].any() and not masks[0].all()
    np.testing.assert_allclose(got[0].numpy(), ref, **pos_tol(hw))
    np.testing.assert_allclose(got[0].numpy()[masks[0]],
                               np.asarray(want[0])[masks[0]], **pos_tol(hw))
    if tshift or lshift:      # the other direction reads other peers
        other, _ = woa_block_oracle(pos, best, lambda s: draws, hw, 300, 1.0,
                                    tile_n, t0, -tshift, -lshift - 2, 1)
        assert not np.allclose(other[masks[0]], ref[masks[0]],
                               **pos_tol(hw))


@pytest.mark.parametrize("n,tile_n,k,shifts", [
    (512, 128, 8, (3, 2, 126)), (256, 256, 5, (0, 0, 9)),
    (384, 128, 11, (2, 4, 0))])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, shifts):
    d, t_max = 6, 30
    tshift, t0, lshift = shifts
    hw, best, pos, _ = pod_t("rastrigin", n, d, k)
    scalars = torch.tensor([21, tshift, t0, lshift], dtype=torch.int32)
    got = twf.fused_woa_step_t(scalars, *tt(best, pos),
                               objective_name="rastrigin", half_width=hw,
                               t_max=t_max, tile_n=tile_n, rng="device",
                               k_steps=k, step0=6)

    def draws_of(s):
        rows = tpf.philox_uniforms(scalars[:1], n, 4, 6 + s, 2).numpy()
        return (tpf.philox_uniforms(scalars[:1], n, d, 6 + s, 0).numpy(),
                tpf.philox_uniforms(scalars[:1], n, d, 6 + s, 1).numpy(),
                rows[0:1], rows[1:2])

    ref, masks = woa_block_oracle(pos, best, draws_of, hw, t_max, 1.0,
                                  tile_n, t0, tshift, lshift, k)
    assert any(m.any() for m in masks)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got[1].numpy(), twf.OBJECTIVES_T["rastrigin"](got[0]).numpy())


def test_step_rejects_bad_arguments():
    hw, best, pos, draws = pod_t("sphere", 256, 2, 0)
    args = (torch.tensor([0, 0, 0, 0], dtype=torch.int32), *tt(best, pos))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        twf.fused_woa_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        twf.fused_woa_step_t(*args, objective_name="sphere", tile_n=100)
    before = twf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        twf.fused_woa_step_cuda(*args, **kw)
    assert twf.LAUNCHES == before
    assert twf.woa_pallas_supported("rastrigin", torch.float32, 1816)
    assert not twf.woa_pallas_supported("rastrigin", torch.float32, 1817)
    assert twf.kernel_block(30) == 128 and twf.kernel_block(500) == 64


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_inputs(key, calls, n_pad, d, tile_n):
    """What JAX's ``fused_woa_run(rng="host")`` draws for each launch: the
    four uniforms and the (tile shift, lane shift) pair."""
    host_key = jax.random.fold_in(key, 0x30A)
    shift_key = jax.random.fold_in(key, 0x0A1)
    uniforms, shifts = [], []
    for i in range(calls):
        r_a, r_c = jpf.host_uniforms(host_key, i, (d, n_pad))
        r_p, r_l = jpf.host_uniforms(host_key, i, (1, n_pad), fold=1)
        uniforms.append(tt(r_a, r_c, r_p, r_l))
        kk = jax.random.fold_in(shift_key, i)
        shifts.append([int(jax.random.randint(kk, (), 0, n_pad // tile_n)),
                       int(jax.random.randint(jax.random.fold_in(kk, 1), (),
                                              0, tile_n))])
    return uniforms, torch.tensor(shifts, dtype=torch.int32)


@pytest.mark.parametrize("name,n,tile_n", [("sphere", 500, 128),
                                           ("rastrigin", 300, None)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n):
    d, steps = 4, 5
    jfn, hw = jobj.get_objective(name)
    js = jwoa.woa_init(jfn, n, d, hw, seed=n)
    ts = twoa.woa_state_from_numpy(to_numpy(js), device="cpu")
    tile, n_pad = family.lane_tiling(n, tile_n, d)
    uniforms, shifts = jax_run_inputs(js.key, steps, n_pad, d, tile)
    if tile_n:
        assert len(set(shifts[:, 0].tolist())) > 1   # tiles really move
    want = jwf.fused_woa_run(js, name, steps, half_width=hw, t_max=10,
                             tile_n=tile_n, rng="host", interpret=True)
    got = twf.fused_woa_run(ts, name, steps, half_width=hw, t_max=10,
                            tile_n=tile_n, rng="host", uniforms=uniforms,
                            shifts=shifts)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, name)


def test_fused_run_converges_monotone_and_pads():
    fn, hw = tobj.get_objective("sphere")
    st = twoa.woa_init(fn, 500, 5, hw, seed=2, device="cpu")
    prev = float(st.best_fit)
    s = st
    for _ in range(3):
        s = twf.fused_woa_run(s, "sphere", 30, half_width=hw, t_max=90)
        assert float(s.best_fit) <= prev
        prev = float(s.best_fit)
    assert prev < 1e-2 and int(s.iteration) == 90
    assert s.pos.shape == (500, 5)
    assert bool((s.pos.abs() <= hw + 1e-5).all())
    assert float(s.best_fit) <= float(s.fit.min()) + 1e-6
    host = twf.fused_woa_run(st, "sphere", 3, half_width=hw, rng="host")
    assert int(host.iteration) == 3


def test_model_backend_switch(monkeypatch):
    # On the card by default: without one the model raises unless the CPU
    # is asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.WOA("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.WOA("sphere", n=512, dim=4, t_max=80, seed=0,
                   use_pallas=True, device="cpu")
    opt.run(80)
    assert opt.best < 1e-2
    assert tdsa.WOA("sphere", n=16, dim=2, device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.WOA(tobj.sphere, n=512, dim=4, use_pallas=True, device="cpu")
    with pytest.raises(ValueError):
        tdsa.WOA("sphere", n=16, dim=2, t_max=0, device="cpu")
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = ("import distributed_swarm_algorithm_tpu_torch.ops.cuda.woa_fused"
            " as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
