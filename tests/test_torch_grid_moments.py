"""The port's moments field (``ops/grid_moments.py``), the plan's field
binning and the window sizing helpers against the JAX package.

The same numpy inputs go through the JAX functions (on the CPU; the slots
kernel in interpret mode) and through the port.  Mirrors the non-boids
cases of ``tests/test_grid_moments.py`` (its multi-device case has no
counterpart: the port's hashgrid choice is a single-device one) and adds
the cross-package comparisons.

Tolerances, each with its reason:

- The moments field against the four-corner oracle, in either package:
  ``rtol=2e-4, atol=2e-5 * max|field|``, the JAX package's own band: the
  same per-agent terms summed in another association order.
- The port's field against JAX's (deposit grid, sample, whole field):
  the same band.  The port sums each fine cell's rows in a segmented scan
  over the cell sort (a fixed order on every device), JAX with a scatter
  or its associative scan; the einsums sum in each library's order.
- Keys, fine-cell-local coordinates, plan tables and the sums of
  integer-valued rows: exact (the binning decides which cell an agent
  deposits into; ``xt``/``yt`` are the same f32 operations in both).
- Positions after one physics step from the same state: rtol=1e-5,
  atol=1e-4 (the field's band times ``dt``, plus the separation band of
  ``tests/test_torch_hashgrid.py``).
- The window sizing helpers, given JAX's sample: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import grid_moments as jgm
from distributed_swarm_algorithm_tpu.ops import hashgrid_plan as jhp
from distributed_swarm_algorithm_tpu.ops import neighbors as jnb
from distributed_swarm_algorithm_tpu.ops import physics as jphys
from distributed_swarm_algorithm_tpu_torch.ops import grid_moments as tgm
from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as thp
from distributed_swarm_algorithm_tpu_torch.ops import neighbors as tnb
from distributed_swarm_algorithm_tpu_torch.ops import physics as tphys

HW = 32.0
TICK_TOL = dict(rtol=1e-5, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def flock(n, seed=0, hw=HW, vscale=3.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (n, 2)).astype(np.float32)
    vel = (vscale * rng.normal(size=(n, 2))).astype(np.float32)
    return pos, vel


def assert_field_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale)


def both_fields(pos, vel, alive, sep_cell=2.0, align_cell=None):
    """(port moments, port corner oracle, JAX moments) as numpy pairs."""
    ta = None if alive is None else t(alive)
    port = tgm.cic_field_commensurate(t(pos), t(vel), ta, HW, sep_cell,
                                      align_cell)
    oracle = tgm.cic_field_corner_reference(t(pos), t(vel), ta, HW,
                                            sep_cell, align_cell)
    jax_ = jgm.cic_field_commensurate(
        jnp.asarray(pos), jnp.asarray(vel),
        None if alive is None else jnp.asarray(alive), torus_hw=HW,
        sep_cell=sep_cell, align_cell=align_cell)
    return port, oracle, jax_


def test_geometry_canonical():
    """align_cell=None derives cell_a = 4*cell_sep on the kernel's
    16-aligned fine grid, as in JAX, for every resolvable pair."""
    g, cf, ga, ca, q = tgm.commensurate_geometry(HW, 2.0)
    assert (g, ga, q) == (32, 8, 4)
    assert cf == pytest.approx(2.0) and ca == pytest.approx(8.0)
    for args in ((HW, 2.0), (HW, 2.0, 8.0), (HW, 2.0, 4.0), (HW, 1.0, 8.0),
                 (256.0, 2.0), (100.0, 3.0, None)):
        assert tgm.commensurate_geometry(*args) == \
            jgm.commensurate_geometry(*args)
    assert tgm.align_cell_arg(0.0) is None and tgm.align_cell_arg(-1) is None
    assert tgm.align_cell_arg(8) == 8.0


@pytest.mark.parametrize("sep_cell,align_cell",
                         [(2.0, None), (2.0, 8.0), (2.0, 4.0), (1.0, 8.0)])
def test_moments_matches_corner_reference(sep_cell, align_cell):
    """The moments deposit and sample equal the corner scatter and gather
    on the same grid, and JAX's moments field, with dead agents."""
    pos, vel = flock(512, seed=3)
    alive = np.arange(512) % 97 != 0
    (a_m, c_m), (a_r, c_r), (a_j, c_j) = both_fields(pos, vel, alive,
                                                     sep_cell, align_cell)
    for got in (a_m, a_r):
        assert_field_match(got, a_j)
    for got in (c_m, c_r):
        assert_field_match(got, c_j)
    assert_field_match(a_m, a_r)
    assert_field_match(c_m, c_r)
    assert float(a_m[~t(alive)].abs().max()) == 0.0
    assert float(c_m[~t(alive)].abs().max()) == 0.0


def test_moments_matches_corner_on_cell_boundaries():
    """Agents exactly on fine-cell lines, corner lines, the seam and cell
    centers: the i0 derivation agrees with the corner path's own floor."""
    pts = [[x, y] for x in (-HW, -HW + 2.0, -4.0, 0.0, 1.0, 2.0, 7.0,
                            HW - 2.0, HW - 1.0)
           for y in (-HW, -2.0, 0.0, 2.0, 3.0, HW - 2.0)]
    pos = np.asarray(pts, np.float32)
    vel = np.random.default_rng(7).normal(size=pos.shape).astype(np.float32)
    (a_m, c_m), (a_r, c_r), (a_j, c_j) = both_fields(pos, vel, None)
    for got, want in ((a_m, a_r), (c_m, c_r), (a_m, a_j), (c_m, c_j)):
        assert_field_match(got, want)


def test_moments_matches_corner_for_escaped_agents():
    """Agents outside [-hw, hw) (the integrator never wraps): the moments
    path wraps before binning, as the corner form is periodic in pos."""
    pos, vel = flock(512, seed=13)
    pos[:64, 0] += 2.0 * HW + 17.0
    pos[64:128, 1] -= 4.0 * HW + 3.0
    pos[128] = [HW, -HW]
    (a_m, c_m), (a_r, c_r), (a_j, c_j) = both_fields(pos, vel, None)
    for got, want in ((a_m, a_r), (c_m, c_r), (a_m, a_j), (c_m, c_j)):
        assert_field_match(got, want)


def test_lone_boid_is_force_free():
    pos = np.asarray([[5.3, -11.7]], np.float32)
    vel = np.asarray([[2.0, 1.0]], np.float32)
    align, coh = tgm.cic_field_commensurate(t(pos), t(vel), None, HW, 2.0)
    assert float(align.abs().max()) < 1e-4
    assert float(coh.abs().max()) < 1e-4


def test_deposit_conserves_mass_and_momentum():
    """The grid's count is the live-agent count and its velocity sums are
    the flock's, across the seam, in both deposit modes."""
    pos, vel = flock(512, seed=11)
    alive = np.arange(512) % 5 != 0
    grid = tgm.moments_deposit(t(pos), t(vel), t(alive), HW, 2.0)
    g = tgm.commensurate_geometry(HW, 2.0)[0]
    plan = thp.build_hashgrid_plan(t(pos), t(alive), HW, 2.0, 8, g=g,
                                   field_sep_cell=2.0)
    sgrid = tgm.moments_deposit(t(pos), t(vel), t(alive), HW, 2.0,
                                keys=thp.plan_field_keys(plan), plan=plan,
                                deposit="sorted")
    vsum = np.where(alive[:, None], vel, 0.0).sum(0)
    for gr in (grid, sgrid):
        assert float(gr[:, :, 4].sum()) == pytest.approx(alive.sum(),
                                                         rel=1e-5)
        np.testing.assert_allclose(gr[:, :, 0:2].sum((0, 1)).numpy(), vsum,
                                   rtol=1e-4, atol=1e-3)


def test_commensurability_validation():
    """The same errors as JAX, word for word."""
    for args in ((HW, 2.0, 7.0), (24.0, 1.0, 3.0), (6.0, 2.0)):
        with pytest.raises(ValueError) as port:
            tgm.commensurate_geometry(*args)
        with pytest.raises(ValueError) as ref:
            jgm.commensurate_geometry(*args)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="commensurate"):
        tgm.commensurate_geometry(HW, 2.0, align_cell=7.0)
    with pytest.raises(ValueError, match="(?i)even"):
        tgm.commensurate_geometry(24.0, 1.0, align_cell=3.0)
    with pytest.raises(ValueError, match="16"):
        tgm.commensurate_geometry(6.0, 2.0)


# --- the deposit modes, the plan's field binning ----------------------------


def field_plans(n=512, seed=5, dead=0.1):
    """The same swarm's field-carrying plans in both packages (the slots
    kernel's grid: g = 32 at hw 32, cell 2)."""
    pos, vel = flock(n, seed=seed)
    alive = np.random.default_rng(seed).random(n) >= dead
    g = tgm.commensurate_geometry(HW, 2.0)[0]
    kw = dict(g=g, need_csr=True, field_sep_cell=2.0)
    tp = thp.build_hashgrid_plan(t(pos), t(alive), HW, 2.0, 8, **kw)
    jp = jax.jit(lambda p, a: jhp.build_hashgrid_plan(p, a, HW, 2.0, 8, **kw)
                 )(jnp.asarray(pos), jnp.asarray(alive))
    return pos, vel, alive, tp, jp


def test_plan_field_keys_and_cell_sums_match_jax():
    pos, vel, alive, tp, jp = field_plans()
    tk, jk = thp.plan_field_keys(tp), jhp.plan_field_keys(jp)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("cx", "cy", "key", "order", "skey", "rank", "ok", "counts",
              "starts"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
    assert (tp.field_sep_cell, tp.field_align_cell) == (2.0, None)
    # Integer-valued rows: the per-cell sums are exact in any order.
    rows = np.random.default_rng(1).integers(-50, 50, (len(pos), 3))
    got = thp.plan_cell_sums(tp, t(rows.astype(np.float32)))
    want = jax.jit(jhp.plan_cell_sums)(jp, jnp.asarray(rows, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # A plan without the binning has no keys; a split geometry raises.
    assert thp.plan_field_keys(thp.build_hashgrid_plan(
        t(pos), t(alive), HW, 2.0, 8)) is None
    with pytest.raises(ValueError, match="does not coincide"):
        thp.build_hashgrid_plan(t(pos), t(alive), HW, 2.0, 8, g=25,
                                field_sep_cell=2.0)


def test_field_plan_roundtrip_and_refresh_keep_the_binning():
    pos, vel, alive, tp, jp = field_plans(n=128)
    back = thp.plan_from_numpy(thp.plan_to_numpy(tp), device="cpu")
    assert back.has_field and torch.equal(back.fkey, tp.fkey)
    moved = t(pos + 0.25)
    got = thp.refresh_plan(moved, t(alive), tp)
    want = jhp.refresh_plan(jnp.asarray(pos + 0.25), jnp.asarray(alive), jp)
    np.testing.assert_array_equal(got.fkey.numpy(), np.asarray(want.fkey))
    assert int(got.rebuilds) == int(want.rebuilds) == 1


@pytest.mark.parametrize("deposit", ["scatter", "sorted"])
def test_deposit_and_sample_match_jax_per_mode(deposit):
    pos, vel, alive, tp, jp = field_plans()
    tk, jk = thp.plan_field_keys(tp), jhp.plan_field_keys(jp)
    plan_kw = dict(plan=tp) if deposit == "sorted" else {}
    grid = tgm.moments_deposit(t(pos), t(vel), t(alive), HW, 2.0, keys=tk,
                               deposit=deposit, **plan_kw)
    jgrid = jgm.moments_deposit(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive), HW, 2.0,
        keys=jk, deposit=deposit, **(dict(plan=jp) if plan_kw else {}))
    assert_field_match(grid, jgrid)
    got = tgm.moments_sample(grid, t(pos), t(vel), t(alive), HW, 2.0,
                             keys=tk)
    want = jgm.moments_sample(jgrid, jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(alive), HW, 2.0, keys=jk)
    for a, b in zip(got, want):
        assert_field_match(a, b)
    whole = tgm.cic_field_commensurate(t(pos), t(vel), t(alive), HW, 2.0,
                                       keys=tk, deposit=deposit, **plan_kw)
    for a, b in zip(whole, got):
        assert torch.equal(a, b)
    if deposit == "sorted":
        with pytest.raises(ValueError, match="shared hashgrid plan"):
            tgm.moments_deposit(t(pos), t(vel), t(alive), HW, 2.0,
                                deposit="sorted")


def test_the_fixed_order_sums_equal_a_scatter():
    """``sorted_cell_sums`` (the order both devices take) against the
    CPU's ``index_add_``: exact on integer-valued rows, in the field's
    band on monomials; dead keys dropped; an empty input."""
    rng = np.random.default_rng(4)
    key = t(rng.integers(0, 65, 400).astype(np.int32))      # 64 = dropped
    ints = t(rng.integers(-9, 9, (400, 4)).astype(np.float32))
    skey, order = torch.sort(key, stable=True)
    got = tgm.sorted_cell_sums(skey, ints[order], 64)
    want = torch.zeros(65, 4).index_add_(0, key.long(), ints)[:64]
    assert torch.equal(got, want)
    floats = t(rng.normal(size=(400, 4)).astype(np.float32))
    got = tgm.sorted_cell_sums(skey, floats[order], 64)
    want = torch.zeros(65, 4).index_add_(0, key.long(), floats)[:64]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = tgm.sorted_cell_sums(key[:0], floats[:0], 8)
    assert empty.shape == (8, 4) and not empty.any()


# --- the tick ----------------------------------------------------------------


def field_swarm(n=512, seed=4, spread=28.0):
    js = jdsa.make_swarm(n, seed=seed, spread=spread)
    vel = 2.0 * np.random.default_rng(seed + 100).normal(size=(n, 2))
    js = js.replace(vel=jnp.asarray(vel, jnp.float32))
    return js


def to_port(js):
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name != "key"}
    return tdsa.state_from_numpy(arrays, device="cpu")


def test_physics_alignment_field_matches_reference():
    """apf_forces with only k_align/k_coh on equals the corner oracle
    scaled by the gains, and JAX's; dead agents feel nothing."""
    kw = dict(separation_mode="off", world_hw=HW, k_align=0.7, k_coh=0.3)
    js = jdsa.kill(field_swarm(), [3, 77, 200])
    ts = to_port(js)
    f = tdsa.ops.physics.apf_forces(ts, None,
                                    tdsa.DEFAULT_CONFIG.replace(**kw))
    a_r, c_r = tgm.cic_field_corner_reference(ts.pos, ts.vel, ts.alive, HW,
                                              2.0)
    assert_field_match(f, 0.7 * a_r + 0.3 * c_r)
    assert_field_match(f, jdsa.apf_forces(js, None,
                                          jdsa.SwarmConfig().replace(**kw)))
    assert float(f[[3, 77, 200]].abs().max()) == 0.0


def test_physics_alignment_steers_toward_neighbor_velocity():
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="off", world_hw=HW,
                                      k_align=1.0)
    s = tdsa.make_swarm(3, seed=0, device="cpu")
    s = s.replace(pos=t(np.float32([[0.3, 0.3], [0.9, 0.3], [20.0, -20.0]])),
                  vel=t(np.float32([[3.0, 0.0], [-3.0, 0.0], [2.0, 2.0]])))
    f = tphys.apf_forces(s, None, cfg)
    assert float(f[0, 0]) < -0.5
    assert float(f[1, 0]) > 0.5
    assert float(f[2].abs().max()) < 1e-3


def test_physics_field_validation():
    cfg = tdsa.DEFAULT_CONFIG
    assert not tphys.tick_field_enabled(cfg)
    with pytest.raises(ValueError, match="world_hw"):
        tphys.tick_field_enabled(cfg.replace(k_align=1.0))
    with pytest.raises(ValueError, match="commensurate"):
        tphys.tick_field_enabled(
            cfg.replace(k_align=1.0, world_hw=HW, align_cell=7.0))
    assert tphys.tick_field_enabled(cfg.replace(k_align=1.0, world_hw=HW))
    # 3-D states have no torus field; "sorted" needs the plan's keys.
    s3 = tdsa.make_swarm(4, dim=3, device="cpu")
    with pytest.raises(ValueError, match="2-D only"):
        tphys.apf_forces(s3, None, cfg.replace(k_coh=1.0, world_hw=HW,
                                               separation_mode="off"))
    s = tdsa.make_swarm(8, device="cpu", spread=3.0)
    with pytest.raises(ValueError, match="field_deposit='sorted'"):
        tphys.apf_forces(s, None, cfg.replace(
            k_coh=1.0, world_hw=HW, field_deposit="sorted"))


# The tick's torus: the smallest the field admits (16 fine cells of 2).
TICK_HW = 16.0
FIELD_TICKS = {
    # The slots kernel's grid (g = 16): the keys ride the plan.
    "kernel-scatter": dict(hashgrid_backend="pallas"),
    "kernel-sorted": dict(hashgrid_backend="pallas",
                          field_deposit="sorted"),
    "portable-sorted": dict(hashgrid_backend="portable",
                            field_deposit="sorted"),
    # A portable grid of 12 cells: the field bins on its own.
    "portable-split": dict(hashgrid_backend="portable", personal_space=2.5),
    "dense": dict(separation_mode="dense"),
}


@pytest.mark.parametrize("mode", list(FIELD_TICKS))
def test_field_tick_matches_jax(mode):
    """One physics step with the field on, from the same state, on the
    hashgrid's portable and kernel-plain paths in both deposits and on
    the dense pass; the plan carries the field's keys exactly where JAX's
    does."""
    kw = dict(dict(separation_mode="hashgrid", world_hw=TICK_HW,
                   k_align=0.3, k_coh=0.1, formation_shape="none",
                   grid_max_per_cell=16, max_speed=1.0), **FIELD_TICKS[mode])
    jcfg = jdsa.SwarmConfig().replace(**kw)
    tcfg = tdsa.DEFAULT_CONFIG.replace(**kw)
    js = field_swarm(n=256, spread=15.0)
    js = js.replace(target=jnp.zeros_like(js.pos),
                    has_target=jnp.ones_like(js.has_target))
    js = jdsa.kill(js, [5, 6])
    ts = to_port(js)
    if kw["separation_mode"] == "hashgrid":
        jp, tp = jphys.build_tick_plan(js, jcfg), tphys.build_tick_plan(ts,
                                                                        tcfg)
        assert tp.has_field == jp.has_field == (mode != "portable-split")
    want = jax.jit(lambda s: jdsa.physics_step(s, None, jcfg))(js)
    got = tphys.physics_step(ts, None, tcfg)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TICK_TOL)
    if mode == "portable-split":
        with pytest.raises(ValueError, match="field_deposit='sorted'"):
            tphys.physics_step(ts, None,
                               tcfg.replace(field_deposit="sorted"))


# --- the window sizing helpers -----------------------------------------------


def test_suggest_window_and_counts_match_jax_with_its_sample():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-20.0, 20.0, (500, 2)).astype(np.float32)
    pos[:60] = rng.normal(scale=0.8, size=(60, 2)).astype(np.float32)
    idx = jax.random.choice(jax.random.PRNGKey(0), 500, (200,),
                            replace=False)
    want = jnb.neighbor_counts_sampled(jnp.asarray(pos), 2.0, sample=200,
                                       seed=0, chunk=64)
    got = tnb.neighbor_counts_sampled(t(pos), 2.0, sample=200, chunk=64,
                                      idx=t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tnb.suggest_window(t(pos), 2.0, sample=200, idx=t(idx)) == \
        jnb.suggest_window(jnp.asarray(pos), 2.0, sample=200, seed=0)
    # Its own draw: a sample without repeats, clipped to [lo, hi].
    own = tnb.neighbor_counts_sampled(t(pos), 2.0, sample=100, seed=3)
    assert own.shape == (100,) and int(own.min()) >= 0
    assert 4 <= tnb.suggest_window(t(pos), 2.0, sample=100) <= 64
    assert tnb.suggest_window(t(pos[:3] * 100), 2.0, lo=5) == 5
