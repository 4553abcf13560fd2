"""The port's Harris hawks (``ops/hho.py``, kernel B13's plain version in
``ops/cuda/hho_fused.py``, the ``HarrisHawks`` model and the CLI) against
the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable step (all twelve draws of ``hho.py:92`` from JAX's
key chain, the random hawks among them), the TPU kernel in interpret mode
with host-supplied draws (``rng="host"``, ``interpret=True``) against the
port's plain version, and whole fused runs over several launches with
JAX's own tile and lane shifts.  A launch of k generations (which JAX draws
on the TPU only) is held to a numpy reference of the same semantics: the
random hawk rolled with ``np.roll`` from the block-start peer tile, the
rabbit and the mean fixed over the launch.

The energy schedule reads ``t / t_max``, and ``|E| >= 1`` and ``|E| >=
1/2`` are discrete decisions made on it: XLA compiles the division by the
constant ``t_max`` as a product with its f32 reciprocal, in the portable
step and in the kernel's body alike, and the port does the same, held
exactly over every iteration of 13 horizons.

Tolerances, each with its reason:

- positions ``rtol = 1e-5``, ``atol = max(1e-5, 4e-6 hw)``: XLA on the CPU
  contracts ``R - E |J R - x|`` and the explore perches into multiply-adds
  (and the Levy power's Horner steps), a few ulps;
- fitness ``2e-5``, the JAX package's own band for its objectives;
- discrete results are exact: each hawk's branch (explore by perch or by
  mean, soft or hard besiege, a dive to y, to z or none).  A dive's choice
  reads the objective at y and z, within the band of the float terms; the
  lanes within ``1e-6`` relative of their threshold are counted and left
  out, and there are none at these sizes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import hho as jhho
from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops.pallas import hho_fused as jhf
from distributed_swarm_algorithm_tpu_torch.cli import main as cli_main
from distributed_swarm_algorithm_tpu_torch.ops import hho as thho
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops.cuckoo import mantegna_sigma
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import fast_math as tfm
from distributed_swarm_algorithm_tpu_torch.ops.cuda import hho_fused as thf

OBJ_TOL = dict(rtol=2e-5, atol=2e-5)
FIELDS = thho.HHO_TENSOR_FIELDS
HORIZONS = (3, 6, 7, 10, 13, 77, 100, 150, 256, 300, 999, 1000, 5120)


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
    assert (thho.T_MAX, thho.LEVY_BETA) == (jhho.T_MAX, jhho.LEVY_BETA)
    assert thf.MAX_STEPS_PER_KERNEL == 8


@partial(jax.jit, static_argnames=("t_max",))
def _jax_fraction(it, t_max):
    # The portable step's expression (hho.py:102-106), compiled.
    t = (it + 1).astype(jnp.float32)
    return jnp.clip(t / t_max, 0.0, 1.0)


def _kernel_fractions(t0, t_max):
    # The kernel body's expression (hho_fused.py:88-89), interpreted.
    from jax.experimental import pallas as pl

    def kernel(t0_ref, o_ref):
        t0f = t0_ref[0].astype(jnp.float32)
        for step in range(8):
            o_ref[step] = jnp.clip((t0f + step + 1.0) / t_max, 0.0, 1.0)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8,), jnp.float32),
        interpret=True)(jnp.asarray([t0], jnp.int32)))


def test_energy_fraction_is_the_compiled_one():
    for t_max in HORIZONS:
        its = np.arange(0, min(3 * t_max, 6000), dtype=np.int32)
        want = np.asarray(jax.vmap(lambda i: _jax_fraction(i, t_max))(
            jnp.asarray(its)))
        got = thho.energy_fraction(torch.from_numpy(its), t_max,
                                   torch.float32).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(t_max))
        for t0 in (max(t_max - 5, 0), 2 * t_max // 3):
            got = np.concatenate([thf.step_fraction(
                torch.tensor(t0, dtype=torch.int32), s, t_max).reshape(
                    1).numpy() for s in range(8)])
            np.testing.assert_array_equal(got, _kernel_fractions(t0, t_max),
                                          err_msg=f"{t_max} {t0}")
    # A true division gives another fraction for some of these.
    t = torch.arange(1, 1001, dtype=torch.float32)
    assert not torch.equal(t / torch.tensor(1000.0), t * (1.0 / 1000))


# --------------------------------------------------------------------------
# The portable step
# --------------------------------------------------------------------------


def jax_step_draws(js):
    n, d = js.pos.shape
    dt = js.pos.dtype
    (_, ke, kj, kq, kr, kperm, k1, k2, k3, k4, ks,
     klev) = jax.random.split(js.key, 12)
    ku_, kv_ = jax.random.split(klev)
    return tt(jax.random.uniform(ke, (n,), dt, minval=-1.0, maxval=1.0),
              jax.random.uniform(kj, (n, 1), dt),
              jax.random.uniform(kq, (n, 1), dt),
              jax.random.uniform(kr, (n, 1), dt),
              jax.random.randint(kperm, (n,), 0, n),
              *(jax.random.uniform(k, (n, d), dt) for k in (k1, k2, k3, k4,
                                                             ks)),
              jax.random.normal(ku_, (n, d), dt),
              jax.random.normal(kv_, (n, d), dt))


def branch_labels(pos_in, pos_out, explore, dive, q, soft, y):
    """Per hawk: 0/1 explore by mean/perch, 2/3 hard/soft besiege, and for
    a dive 4 none (the hawk stays), 5 to y, 6 to z (nearer clip(y) or
    not)."""
    lab = np.where(explore, np.where(q, 1, 0), np.where(soft, 3, 2))
    stay = (pos_out == pos_in).all(-1)
    to_y = np.abs(pos_out - y).max(-1) <= 1e-4 * (1 + np.abs(y).max(-1))
    return np.where(dive, np.where(stay, 4, np.where(to_y, 5, 6)), lab)


@pytest.mark.parametrize("name,n,d,hw,t_max,it0", [
    ("sphere", 64, 4, None, 300, 0), ("rastrigin", 32, 5, None, 1000, 0),
    ("sphere", 48, 3, 2.0, 100, 95), ("griewank", 40, 6, None, 30, 12)])
def test_portable_step_matches_jax(name, n, d, hw, t_max, it0):
    jfn, default_hw = jobj.get_objective(name)
    tfn, _ = tobj.get_objective(name)
    hw = hw or default_hw
    js = jhho.hho_init(jfn, n, d, hw, seed=n)
    js = js.replace(iteration=jnp.asarray(it0, jnp.int32))
    seen = set()
    for _ in range(3):
        draws = jax_step_draws(js)
        ts = thho.hho_state_from_numpy(to_numpy(js), device="cpu")
        want = jhho.hho_step(js, jfn, half_width=hw, t_max=t_max)
        got = thho.hho_step(ts, tfn, half_width=hw, t_max=t_max,
                            draws=draws)
        assert_state_close(got, want, hw, name)
        # Each hawk's branch, exact.
        frac = thho.energy_fraction(ts.iteration, t_max, torch.float32)
        energy = (2.0 * draws[0] * (1.0 - frac)).numpy()
        explore, soft = np.abs(energy) >= 1.0, np.abs(energy) >= 0.5
        dive = ~explore & (draws[3][:, 0].numpy() < 0.5)
        q = draws[2][:, 0].numpy() >= 0.5
        rab, pos = np.asarray(js.best_pos), np.asarray(js.pos)
        jr = 2.0 * (1.0 - draws[1].numpy()) * rab
        ref = np.where(soft[:, None], pos, pos.mean(0))
        y_raw = rab - energy[:, None] * np.abs(jr - ref)
        y = np.clip(y_raw, -hw, hw)
        # Dive lanes whose y or z lies within 1e-6 of the hawk's fitness.
        z = np.clip(y_raw + draws[9].numpy() * thho.levy_steps(
            None, None, 1.5, None, None, normals=draws[10:]).numpy(), -hw, hw)
        f0 = np.asarray(js.fit)
        near = dive & np.any([np.abs(tfn(torch.from_numpy(v)).numpy() - f0)
                              <= 1e-6 * np.abs(f0) for v in (y, z)], axis=0)
        assert not near.any()
        mine = branch_labels(pos, got.pos.numpy(), explore, dive, q, soft, y)
        theirs = branch_labels(pos, np.asarray(want.pos), explore, dive, q,
                               soft, y)
        np.testing.assert_array_equal(mine, theirs)
        seen.update(mine.tolist())
        js = want
    assert len(seen) >= 2


def test_portable_hawks_mirror_the_jax_cases():
    opt = tdsa.HarrisHawks("sphere", n=64, dim=4, seed=0, t_max=300,
                           device="cpu")
    opt.run(300)
    assert opt.best < 1e-2
    rfn, _ = tobj.get_objective("rastrigin")
    st = thho.hho_init(rfn, 32, 5, 5.12, seed=1, device="cpu")
    prev = float(st.best_fit)
    for _ in range(30):
        st = thho.hho_step(st, rfn, 5.12)
        assert float(st.best_fit) <= prev + 1e-7
        prev = float(st.best_fit)
    fn, _ = tobj.get_objective("sphere")
    st = thho.hho_run(thho.hho_init(fn, 48, 3, 2.0, seed=2, device="cpu"),
                      fn, 120, half_width=2.0, t_max=100)
    assert float(st.pos.abs().max()) <= 2.0 + 1e-6
    np.testing.assert_allclose(fn(st.pos).numpy(), st.fit.numpy(),
                               atol=1e-5)
    assert bool(torch.isfinite(st.pos).all())
    st = thho.hho_run(thho.hho_init(fn, 48, 4, 5.12, seed=3, device="cpu"),
                      fn, 100, half_width=5.12, t_max=100)
    at_horizon = float(st.best_fit)
    st = thho.hho_run(st, fn, 100, half_width=5.12, t_max=100)
    assert float(st.best_fit) <= at_horizon and float(st.best_fit) < 1e-3
    a = tdsa.HarrisHawks("rastrigin", n=32, dim=4, seed=7, device="cpu")
    b = tdsa.HarrisHawks("rastrigin", n=32, dim=4, seed=7, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best == b.best
    with pytest.raises(ValueError, match="t_max"):
        tdsa.HarrisHawks("sphere", n=32, dim=4, t_max=0, device="cpu")


# --------------------------------------------------------------------------
# Kernel B13's plain version against the TPU kernel in interpret mode
# --------------------------------------------------------------------------


def hho_inputs(name, n, d, seed):
    fn, hw = jobj.get_objective(name)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (d, n)).astype(np.float32)
    fit = np.asarray(fn(jnp.asarray(pos.T)))[None, :]
    best = pos[:, fit[0].argmin()][:, None].copy()
    mean = pos.mean(1, keepdims=True).astype(np.float32)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    draws = ([u(1, n) for _ in range(4)] + [u(d, n) for _ in range(5)]
             + [rng.standard_normal((d, n)).astype(np.float32)
                for _ in range(2)])
    return float(hw), pos, fit, best, mean, draws


@pytest.mark.parametrize("name,n,tile_n,scalars,t_max", [
    ("sphere", 512, 128, (1, 0, 0), 30), ("rastrigin", 512, 128,
                                          (3, 20, 127), 40),
    ("griewank", 640, 128, (4, 7, 250), 12), ("ackley", 1024, 256,
                                              (1, 100, 9), 100)])
def test_plain_step_matches_the_tpu_kernel_in_interpret_mode(name, n, tile_n,
                                                             scalars, t_max):
    d = 5
    hw, pos, fit, best, mean, draws = hho_inputs(name, n, d, n + scalars[1])
    kw = dict(objective_name=name, half_width=hw, tile_n=tile_n,
              t_max=t_max, rng="host")
    want = jhf.fused_hho_step_t(
        jnp.asarray([0, *scalars]), jnp.asarray(best), jnp.asarray(mean),
        jnp.asarray(pos), jnp.asarray(fit),
        tuple(jnp.asarray(r) for r in draws), interpret=True, **kw)
    got = thf.fused_hho_step_t(
        torch.tensor([0, *scalars], dtype=torch.int32),
        *tt(best, mean, pos, fit), tt(*draws), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **pos_tol(hw))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **OBJ_TOL)
    # The branches, exact: the lanes that stayed put (a dive to neither
    # point) and the branch masks from the draws.
    frac = thf.step_fraction(torch.tensor(scalars[1]), 0, t_max)
    explore, dive, _ = (m.numpy() for m in thf.branches(
        *tt(draws[0], draws[3]), frac))
    stay = lambda p: (np.asarray(p) == pos).all(0)  # noqa: E731
    np.testing.assert_array_equal(stay(got[0]), stay(want[0]))
    assert dive.any() and (~dive).any() and stay(got[0]).any()


def hho_block_oracle(pos, fit, best, mean, seed, name, hw, t_max, tile_n, s,
                     t0, k, step0):
    """A numpy reference of one k-generation launch: the random hawk from
    np.roll over the block-start tile i + s, the rabbit and the mean fixed,
    the six behaviours by masks.  Returns positions, fitness and the number
    of hawks in each branch at each generation."""
    d, n = pos.shape
    nt = n // tile_n
    obj = lambda x: thf.OBJECTIVES_T[name](  # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x))).numpy()
    peer0 = pos.reshape(d, nt, tile_n)[:, (np.arange(nt) + s[0]) % nt, :]
    lb, ub = np.float32(-hw), np.float32(hw)
    x, fx = pos.copy(), fit.copy()
    counts = []
    for step in range(k):
        frac = thf.step_fraction(torch.tensor(t0), step, t_max).numpy()
        dr = [r.numpy() for r in thf.device_draws(
            torch.tensor([seed], dtype=torch.int32), n, d, step0 + step)]
        u_e0, u_j, u_q, u_r, r1, r2, r3, r4, sd, n1, n2 = dr
        energy = np.float32(2.0) * (np.float32(2.0) * u_e0 - 1) * (1 - frac)
        abs_e = np.abs(energy)
        jump = np.float32(2.0) * (1 - u_j)
        xr = np.roll(peer0, s[1] + family.LANE_SHIFTS[step % 8][0],
                     axis=2).reshape(d, n)
        ea = xr - r1 * np.abs(xr - np.float32(2.0) * r2 * x)
        eb = (best - mean) - r3 * (lb + r4 * np.float32(ub - lb))
        explore = np.where(u_q >= 0.5, ea, eb)
        soft = (best - x) - energy * np.abs(jump * best - x)
        hard = best - energy * np.abs(best - x)
        besiege = np.where(abs_e >= 0.5, soft, hard)
        y = np.where(abs_e >= 0.5, best - energy * np.abs(jump * best - x),
                     best - energy * np.abs(jump * best - mean))
        levy = (np.float32(mantegna_sigma(1.5)) * n1) * tfm.levy_power(
            torch.from_numpy(n2), 1.0 / 1.5).numpy()
        z = np.clip(y + sd * levy, lb, ub)
        y = np.clip(y, lb, ub)
        fy, fz = obj(y), obj(z)
        dive = np.where(fy < fx, y, np.where(fz < fx, z, x))
        x = np.clip(np.where(abs_e >= 1, explore,
                             np.where(u_r >= 0.5, besiege, dive)), lb, ub)
        fx = obj(x.astype(np.float32))
        x = x.astype(np.float32)
        counts.append((int((abs_e >= 1).sum()),
                       int(((abs_e < 1) & (u_r < 0.5)).sum())))
    return x, fx, counts


@pytest.mark.parametrize("n,tile_n,k,scalars,t_max", [
    (512, 128, 8, (3, 10, 126), 30), (640, 128, 5, (1, 0, 0), 12),
    (1024, 256, 8, (2, 5, 255), 64), (512, 128, 1, (1, 3, 5), 80)])
def test_device_rng_launch_matches_the_reference(n, tile_n, k, scalars,
                                                 t_max):
    d, name, seed = 6, "rastrigin", 21
    hw, pos, fit, best, mean, _ = hho_inputs(name, n, d, k)
    got = thf.fused_hho_step_t(
        torch.tensor([seed, *scalars], dtype=torch.int32),
        *tt(best, mean, pos, fit), objective_name=name, half_width=hw,
        tile_n=tile_n, t_max=t_max, rng="device", k_steps=k, step0=6)
    ref, ref_fit, counts = hho_block_oracle(
        pos, fit, best, mean, seed, name, hw, t_max, tile_n,
        (scalars[0], scalars[2]), scalars[1], k, 6)
    assert sum(c[0] for c in counts) > 0 and sum(c[1] for c in counts) > 0
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(got[1].numpy(), ref_fit)


def test_step_rejects_bad_arguments():
    hw, pos, fit, best, mean, draws = hho_inputs("sphere", 512, 2, 0)
    args = (torch.zeros(4, dtype=torch.int32), *tt(best, mean, pos, fit))
    kw = dict(objective_name="sphere", tile_n=128)
    with pytest.raises(ValueError, match="every draw"):
        thf.fused_hho_step_t(*args, rng="host", **kw)
    with pytest.raises(ValueError, match="k_steps=1"):
        thf.fused_hho_step_t(*args, tt(*draws), rng="host", k_steps=2, **kw)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        thf.fused_hho_step_t(*args, objective_name="sphere", tile_n=100)
    before = thf.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        thf.fused_hho_step_cuda(*args, **kw)
    assert thf.LAUNCHES == before
    assert thf.kernel_block(30) == 128 and thf.kernel_block(606) == 0
    assert thf.hho_pallas_supported("rastrigin", torch.float32, 605)
    assert not thf.hho_pallas_supported("rastrigin", torch.float32, 606)
    assert not thf.hho_pallas_supported("rastrigin", torch.bfloat16)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def jax_run_inputs(key, calls, n_pad, d, tile_n):
    """What JAX's ``fused_hho_run(rng="host")`` draws for each launch: the
    eleven host draws, the tile shift and the lane shift."""
    host_key = jax.random.fold_in(key, 0x440)
    shift_key = jax.random.fold_in(key, 0x441)
    n_tiles = n_pad // tile_n
    draws, shifts = [], []
    for i in range(calls):
        draws.append(tt(*jhf.host_draws(host_key, i, (d, n_pad),
                                        (1, n_pad))))
        kk = jax.random.fold_in(shift_key, i)
        shifts.append([int(jax.random.randint(kk, (), 1, max(n_tiles, 2))),
                       int(jax.random.randint(jax.random.fold_in(kk, 1), (),
                                              0, tile_n))])
    return draws, torch.tensor(shifts, dtype=torch.int32)


@pytest.mark.parametrize("name,n,tile_n,t_max", [("sphere", 700, 128, 6),
                                                 ("rastrigin", 1024, None,
                                                  40)])
def test_fused_run_matches_jax_over_several_launches(name, n, tile_n, t_max):
    d, steps = 4, 3
    jfn, hw = jobj.get_objective(name)
    js = jhho.hho_init(jfn, n, d, hw, seed=n)
    ts = thho.hho_state_from_numpy(to_numpy(js), device="cpu")
    tile, _ = family.lane_tiling(n, tile_n, d)
    tile, n_pad, _ = family.shrink_tile_for_donors(n, tile)
    draws, shifts = jax_run_inputs(js.key, steps, n_pad, d, tile)
    want = jhf.fused_hho_run(js, name, steps, half_width=hw, t_max=t_max,
                             tile_n=tile_n, rng="host", interpret=True)
    got = thf.fused_hho_run(ts, name, steps, half_width=hw, t_max=t_max,
                            tile_n=tile_n, rng="host", uniforms=draws,
                            shifts=shifts)
    assert got.pos.shape == (n, d)
    assert_state_close(got, want, hw, name)


def test_fused_run_converges_monotone_and_pads():
    # The JAX package's cases (tests/test_pallas_hho.py).
    fn, hw = tobj.get_objective("sphere")
    st = thho.hho_init(fn, 1024, 6, hw, seed=0, device="cpu")
    out = thf.fused_hho_run(st, "sphere", 150, half_width=hw, t_max=150)
    assert out.pos.shape == (1024, 6) and int(out.iteration) == 150
    assert float(out.best_fit) < 1e-3
    assert bool((out.pos.abs() <= hw + 1e-5).all())
    assert float(out.best_fit) <= float(out.fit.min()) + 1e-6
    rfn, _ = tobj.get_objective("rastrigin")
    s = thho.hho_init(rfn, 512, 6, hw, seed=3, device="cpu")
    prev = float(s.best_fit)
    for _ in range(3):
        s = thf.fused_hho_run(s, "rastrigin", 10, half_width=hw)
        assert float(s.best_fit) <= prev + 1e-6
        prev = float(s.best_fit)
    runs = [thf.fused_hho_run(thho.hho_state_from_numpy(
        thho.hho_state_to_numpy(s), device="cpu", seed=4), "rastrigin", 12,
        half_width=hw) for _ in range(2)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    small = thho.hho_init(fn, 64, 5, hw, seed=2, device="cpu")
    with pytest.raises(ValueError, match="rotational"):
        thf.fused_hho_run(small, "sphere", 5, half_width=hw)


def test_model_backend_switch_and_cli(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.HarrisHawks("sphere", n=128, dim=2)
    monkeypatch.undo()
    opt = tdsa.HarrisHawks("sphere", n=1024, dim=4, seed=0, t_max=80,
                           use_pallas=True, device="cpu")
    opt.run(80)
    assert opt.best < 1e-2
    assert tdsa.HarrisHawks("sphere", n=1024, dim=2,
                            device="cpu").use_pallas is False
    with pytest.raises(ValueError):
        tdsa.HarrisHawks("sphere", n=64, dim=4, use_pallas=True,
                         device="cpu")
    with pytest.raises(ValueError):
        tdsa.HarrisHawks(tobj.sphere, n=1024, dim=4, use_pallas=True,
                         device="cpu")
    assert cli_main(["hho", "--device", "cpu", "--objective", "sphere",
                     "--n", "256", "--dim", "4", "--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert '"path": "portable"' in out and '"hawks": 256' in out
