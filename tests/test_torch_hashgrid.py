"""The port's hashgrid tick against the JAX package.

The same numpy inputs go through the JAX functions (on the CPU; its Pallas
kernels in interpret mode) and through the port's plain versions, which
are what the port runs on a CPU tensor.

Tolerances, each with its reason:

- Every plan table (``cx cy key order skey rank ok counts starts cand recv``
  and the counters ``cap_overflow cand_overflow recv_overflow age
  rebuilds cells_rebuilt``) and every integer or bool field of the state:
  exact.  The tables decide which pairs count and in what order, and the
  Verlet trigger decides when they are rebuilt.
- ``separation_grid`` and ``separation_grid_plan`` (stencil and union
  sweeps): ``|port - jax| <= 1e-5 * sum_j |term_ij| + 1e-5``, the window
  test's band: the same formula in f32, summed in another order.  The
  scale is the dense torus pass's ``sum_j |term_ij|`` (a superset of each
  sweep's pairs).
- The slots path (B2's plain version, rescue and gather) against
  ``separation_hashgrid_pallas(interpret=True)``: ``5e-4 * sum|terms| +
  1e-6``.  XLA on the CPU computes the TPU kernel's ``rsqrt`` with an
  approximate instruction (about 3e-4 relative near contact,
  ``ops/neighbors.py:608-612`` of the JAX package); 5e-4 is the relative
  band the JAX package's own test allows that kernel against the dense
  pass.
- The candidates path (B3's plain version) against
  ``candidate_sweep_pallas(interpret=True)``: ``1e-5 * sum|terms| +
  1e-6``: XLA fuses multiply-adds the port rounds twice.  Against the
  port's own portable union sweep on the same plan: ``1e-6 * sum|terms| +
  1e-7`` (the same terms; only the order of the sum differs).
- ``pos`` and ``vel`` after one tick from JAX's state: rtol=1e-5,
  atol=1e-4 (the separation band above, times ``dt``, plus the clamp).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu as jdsa
import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.models.swarm import (
    _swarm_tick_plan as j_tick_plan,
)
from distributed_swarm_algorithm_tpu.ops import hashgrid_plan as jhp
from distributed_swarm_algorithm_tpu.ops import neighbors as jnb
from distributed_swarm_algorithm_tpu.ops.physics import (
    build_tick_plan as j_build_tick_plan,
)
from distributed_swarm_algorithm_tpu.ops.pallas.candidate_sweep import (
    candidate_sweep_pallas,
)
from distributed_swarm_algorithm_tpu.ops.pallas.grid_separation import (
    hashgrid_overflow as j_overflow,
    separation_hashgrid_pallas,
)
from distributed_swarm_algorithm_tpu_torch import cli as tcli
from distributed_swarm_algorithm_tpu_torch.models.swarm import (
    _swarm_tick_plan as t_tick_plan,
)
from distributed_swarm_algorithm_tpu_torch.ops import hashgrid_plan as thp
from distributed_swarm_algorithm_tpu_torch.ops import neighbors as tnb
from distributed_swarm_algorithm_tpu_torch.ops import physics as tphys
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    candidate_sweep as tcand,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    grid_separation as tgrid,
)

REPO = Path(__file__).resolve().parent.parent
K_SEP, PS, EPS = 20.0, 2.0, 1e-3
BENCH_TASKS = [[1.0, 1.0], [-2.0, 3.0], [5.0, -8.0], [0.0, 9.0]]
TICK_TOL = dict(rtol=1e-5, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s) if f.name != "key"}


def jplan_to_numpy(p):
    out = {f: getattr(p, f) for f in jhp.HashgridPlan.AUX_FIELDS}
    for f in jhp.HashgridPlan.ARRAY_FIELDS:
        v = getattr(p, f)
        if v is not None:
            out[f] = np.asarray(v)
    return out


def assert_plan_equal(tplan, jplan, where=""):
    got, want = thp.plan_to_numpy(tplan), jplan_to_numpy(jplan)
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for f, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[f].dtype == w.dtype, (where, f, got[f].dtype, w.dtype)
            np.testing.assert_array_equal(got[f], w, err_msg=f"{where} {f}")
        else:
            assert got[f] == w, (where, f, got[f], w)


def assert_discrete_equal(got, want, where=""):
    for f, w in want.items():
        if w.dtype.kind in "biu":
            assert got[f].dtype == w.dtype, (where, f)
            np.testing.assert_array_equal(got[f], w, err_msg=f"{where} {f}")


def jax_jitter(s, cfg):
    _, sub = jax.random.split(s.key)
    return t(jax.random.randint(sub, (s.n_agents,), 0,
                                cfg.election_jitter_ticks + 1))


def dense_abs_sum(pos, alive, hw):
    """[N, 2] sum_j |term_ij| of the dense torus pass (numpy, f64): the
    scale of the force bands, over every pair a sweep can count."""
    d = pos[:, None, :].astype(np.float64) - pos[None, :, :]
    d = np.mod(d + hw, 2 * hw) - hw
    r = np.sqrt((d * d).sum(-1))
    near = (r < PS) & alive[:, None] & alive[None, :] & ~np.eye(len(pos),
                                                               dtype=bool)
    mag = K_SEP / np.maximum(r, EPS) ** 3
    return np.where(near[..., None], mag[..., None] * np.abs(d), 0.0).sum(1)


def assert_banded(got, want, scale, rel, abs_, where=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = err > rel * scale + abs_
    assert not bad.any(), (where, err[bad][:5], scale[bad][:5])


def swarm_arrays(n, seed, hw, dead=0.1, crowd=0, crowd_at=(1.0, 1.0),
                 crowd_sd=0.3):
    """Uniform positions in the torus, a share dead, and optionally a
    crowded cluster of ``crowd`` agents (past any cap)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-hw, hw, (n, 2)).astype(np.float32)
    if crowd:
        pos[:crowd] = (np.float32(crowd_at)
                       + crowd_sd * rng.normal(size=(crowd, 2))
                       ).astype(np.float32)
    alive = rng.random(n) >= dead
    alive[:crowd] = True
    return pos, alive


# --- the plan, exactly ------------------------------------------------------

P_HW, P_CELL, P_SKIN, P_CAP, P_NCAP = 32.0, 2.0, 1.0, 8, 40
P_G = int(2 * P_HW / (P_CELL + P_SKIN))


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(need_csr=True), dict(skin=P_SKIN, need_csr=True),
     dict(g=P_G, skin=P_SKIN, neighbor_cap=P_NCAP, recv_cap=16),
     dict(g=P_G, skin=P_SKIN, neighbor_cap=10, recv_cap=8)],
    ids=["skin0", "skin0-csr", "skinned-csr", "skinned-cand-recv",
         "cand-and-recv-truncated"],
)
def test_build_plan_matches_jax(kw):
    pos, alive = swarm_arrays(512, 3, P_HW, crowd=30)
    jp = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive), P_HW,
                                 P_CELL, P_CAP, **kw)
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP, **kw)
    assert_plan_equal(tp, jp)
    assert int(tp.cap_overflow) > 0          # the crowded cell is past K
    if "recv_cap" in kw:
        assert int(tp.recv_overflow) > 0
    if kw.get("neighbor_cap") == 10:
        assert int(tp.cand_overflow) > 0


def test_torus_cell_tables_match_jax():
    pos, _ = swarm_arrays(700, 5, 20.0, dead=0.0)
    pos[:4] = [[-20.0, -20.0], [19.999998, 19.999998], [0.0, -1e-6],
               [-1e-30, 5.0]]
    want = jnb.torus_cell_tables(jnp.asarray(pos), 20.0, 13)
    got = tnb.torus_cell_tables(t(pos), 20.0, 13)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("amp,rebuilds", [(0.1, 0), (3.0, 1)],
                         ids=["keep", "rebuild"])
def test_refresh_plan_matches_jax(amp, rebuilds):
    pos, alive = swarm_arrays(512, 4, P_HW, crowd=20)
    kw = dict(g=P_G, skin=P_SKIN, need_csr=True, neighbor_cap=P_NCAP)
    jp = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive), P_HW,
                                 P_CELL, P_CAP, **kw)
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP, **kw)
    moved = (pos + np.float32(amp)).astype(np.float32)
    for every in (0, 3):
        jq = jhp.refresh_plan(jnp.asarray(moved), jnp.asarray(alive), jp,
                              rebuild_every=every)
        tq = thp.refresh_plan(t(moved), t(alive), tp, rebuild_every=every)
        assert_plan_equal(tq, jq, f"rebuild_every={every}")
        assert int(tq.rebuilds) == rebuilds
    # The staleness probe itself, as device scalars.
    d2j, chj = jhp.plan_staleness(jnp.asarray(moved), jnp.asarray(alive), jp)
    d2t, cht = thp.plan_staleness(t(moved), t(alive), tp)
    assert float(d2t) == float(d2j) and bool(cht) == bool(chj)


def test_refresh_plan_alive_change_and_ceiling_rebuild():
    pos, alive = swarm_arrays(300, 6, P_HW)
    kw = dict(g=P_G, skin=P_SKIN, need_csr=True)
    jp = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive), P_HW,
                                 P_CELL, P_CAP, **kw)
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP, **kw)
    alive2 = alive.copy()
    alive2[:3] = ~alive2[:3]
    jq = jhp.refresh_plan(jnp.asarray(pos), jnp.asarray(alive2), jp)
    tq = thp.refresh_plan(t(pos), t(alive2), tp)
    assert_plan_equal(tq, jq)
    assert int(tq.rebuilds) == 1
    jq = jhp.refresh_plan(jnp.asarray(pos), jnp.asarray(alive), jp,
                          rebuild_every=1)
    tq = thp.refresh_plan(t(pos), t(alive), tp, rebuild_every=1)
    assert_plan_equal(tq, jq)
    assert int(tq.rebuilds) == 1


def _partial_chain():
    """(steps): a refresh_plan_partial chain from one build, each step's
    (moved positions, alive, crosser_cap) — keep, partial, a chained
    partial, a trigger storm past the row budget (full), an alive flip
    (full) and a crosser count past its cap (full)."""
    pos, alive = swarm_arrays(512, 3, P_HW, dead=0.08, crowd=12)
    rng = np.random.default_rng(11)
    steps, cur = [], pos
    for k, amp, flip, ccap in ((0, 0, 0, 512), (6, 2.0, 0, 512),
                               (4, 2.0, 0, 512), (300, 2.0, 0, 512),
                               (3, 2.0, 3, 512), (8, 2.0, 0, 1)):
        cur = cur.copy()
        if k:
            mv = rng.choice(np.where(alive)[0], k, replace=False)
            cur[mv] += rng.uniform(-amp, amp, (k, 2)).astype(np.float32)
            cur = (((cur + P_HW) % (2 * P_HW)) - P_HW).astype(np.float32)
        if flip:
            alive = alive.copy()
            alive[np.where(alive)[0][:flip]] = False
        steps.append((cur, alive, ccap))
    return pos, steps


def test_partial_refresh_chain_matches_jax_through_every_tier():
    pos, steps = _partial_chain()
    alive0 = steps[0][1]
    kw = dict(g=P_G, skin=P_SKIN, need_csr=True, neighbor_cap=P_NCAP,
              recv_cap=16)
    jp = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive0),
                                 P_HW, P_CELL, P_CAP, **kw)
    tp = thp.build_hashgrid_plan(t(pos), t(alive0), P_HW, P_CELL, P_CAP, **kw)
    tiers = []
    for i, (cur, alive, ccap) in enumerate(steps):
        before = (int(tp.rebuilds), int(tp.cells_rebuilt))
        jp = jhp.refresh_plan_partial(jnp.asarray(cur), jnp.asarray(alive),
                                      jp, crosser_cap=ccap)
        tp = thp.refresh_plan_partial(t(cur), t(alive), tp, crosser_cap=ccap)
        assert_plan_equal(tp, jp, f"step {i}")
        if int(tp.rebuilds) > before[0]:
            tiers.append("full")
        elif int(tp.cells_rebuilt) > before[1]:
            tiers.append("partial")
        else:
            tiers.append("keep")
    assert tiers == ["keep", "partial", "partial", "full", "full", "full"]


def test_plan_numpy_roundtrip_and_unported_parts():
    pos, alive = swarm_arrays(200, 2, P_HW)
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP,
                                 g=P_G, skin=P_SKIN, neighbor_cap=P_NCAP,
                                 recv_cap=16)
    back = thp.plan_from_numpy(thp.plan_to_numpy(tp), device="cpu")
    for f in thp.HashgridPlan.ARRAY_FIELDS:
        a, b = getattr(tp, f), getattr(back, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    assert back.g == tp.g and back.skin == tp.skin
    with pytest.raises(ValueError, match="not array fields"):
        tp.replace(g=3)
    with pytest.raises(NotImplementedError, match="item 9"):
        thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP,
                                field_sep_cell=2.0)


# --- forces, in bands -------------------------------------------------------

@pytest.mark.parametrize("torus", [False, True], ids=["plane", "torus"])
def test_separation_grid_matches_jax(torus):
    hw = 20.0
    pos, alive = swarm_arrays(600, 7, hw, crowd=6)
    kw = dict(torus_hw=hw) if torus else {}
    want = jnb.separation_grid(jnp.asarray(pos), jnp.asarray(alive), K_SEP,
                               PS, EPS, 2.5, 8, **kw)
    got = tnb.separation_grid(t(pos), t(alive), K_SEP, PS, EPS, 2.5, 8, **kw)
    scale = dense_abs_sum(pos, alive, hw if torus else 1e9)
    assert_banded(got.numpy(), want, scale, 1e-5, 1e-5)
    assert np.abs(np.asarray(want)).max() > 1.0


@pytest.mark.parametrize("union", [False, True], ids=["stencil", "union"])
def test_separation_grid_plan_matches_jax_on_a_stale_plan(union):
    pos, alive = swarm_arrays(512, 8, P_HW, crowd=10)
    kw = dict(g=P_G, skin=P_SKIN, need_csr=True,
              neighbor_cap=P_NCAP if union else 0)
    jp = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive), P_HW,
                                 P_CELL, P_CAP, **kw)
    tp = thp.build_hashgrid_plan(t(pos), t(alive), P_HW, P_CELL, P_CAP, **kw)
    drift = np.random.default_rng(1).uniform(-0.35, 0.35, pos.shape)
    cur = (pos + drift).astype(np.float32)
    want = jnb.separation_grid_plan(jnp.asarray(cur), jnp.asarray(alive),
                                    K_SEP, PS, EPS, jp)
    got = tnb.separation_grid_plan(t(cur), t(alive), K_SEP, PS, EPS, tp)
    assert_banded(got.numpy(), want, dense_abs_sum(cur, alive, P_HW), 1e-5,
                  1e-5)


S_HW = 16.0


@pytest.mark.parametrize(
    "cell,cap,budget,crowd,skin",
    [(2.0, 8, 64, 0, 0.0), (1.0, 8, 64, 0, 0.0), (2.0, 8, 64, 40, 0.0),
     (1.0, 8, 32, 30, 0.0), (1.5, 16, 64, 0, 0.5)],
    ids=["R1", "R2-half-cells", "R1-rescue", "R2-rescue-past-budget",
         "stale-skinned-plan"],
)
def test_slots_path_matches_the_tpu_kernel(cell, cap, budget, crowd, skin):
    pos, alive = swarm_arrays(400, 9, S_HW, crowd=crowd, crowd_sd=0.5)
    g = (int(2 * S_HW / (cell + skin)) // 16) * 16
    jplan = tplan = None
    cur = pos
    if skin:
        jplan = jhp.build_hashgrid_plan(jnp.asarray(pos), jnp.asarray(alive),
                                        S_HW, cell, cap, g=g, skin=skin)
        tplan = thp.build_hashgrid_plan(t(pos), t(alive), S_HW, cell, cap,
                                        g=g, skin=skin)
        drift = np.random.default_rng(2).uniform(-0.17, 0.17, pos.shape)
        cur = (pos + drift).astype(np.float32)
    kw = dict(cell=cell + skin, max_per_cell=cap, torus_hw=S_HW,
              overflow_budget=budget)
    want = separation_hashgrid_pallas(
        jnp.asarray(cur), jnp.asarray(alive), K_SEP, PS, EPS,
        interpret=True, plan=jplan, **kw)
    got = tgrid.separation_hashgrid(t(cur), t(alive), K_SEP, PS, EPS,
                                    plan=tplan, **kw)
    assert_banded(got.numpy(), want, dense_abs_sum(cur, alive, S_HW), 5e-4,
                  1e-6)
    over = int(j_overflow(jnp.asarray(cur), cell + skin, cap, S_HW,
                          jnp.asarray(alive)))
    assert int(tgrid.hashgrid_overflow(t(cur), cell + skin, cap, S_HW,
                                       t(alive))) == over
    assert (over > 0) == bool(crowd)
    assert (got.numpy()[~alive] == 0).all()


def test_slots_sweep_abs_sum_bounds_the_planes():
    # The sweep's operands replace the slot planes: each cell's run of the
    # sort bounds its in-grid agents, and the plain sum |term| bounds the
    # force of every agent; the dead and the capped-out past the budget
    # get exactly zero.
    pos, alive = swarm_arrays(300, 3, S_HW, crowd=30, crowd_sd=0.5)
    plan = thp.build_hashgrid_plan(t(pos), t(alive), S_HW, 2.0, 8, g=16)
    ops = tgrid.sweep_operands(t(pos), plan)
    assert ops.bounds.shape == (16 * 16 + 1,)
    assert ops.bounds.dtype == torch.int32
    counts = ops.bounds[1:] - ops.bounds[:-1]
    assert int(counts.clamp(max=8).sum()) == int(plan.ok.sum())
    assert int(ops.bounds[-1]) == int(alive.sum())
    over = int((counts - 8).clamp(min=0).sum())
    assert over == int(plan.cap_overflow) > 4
    budget = 4
    args = (ops, 16, 8, 1, budget, K_SEP, PS, EPS, S_HW)
    f = tgrid.grid_sweep_plain(*args)
    s = tgrid.grid_sweep_plain(*args, absolute=True)
    assert (f.abs() <= s * (1 + 1e-6)).all() and (s > 0).any()
    in_grid, rescued = tgrid._receivers(ops, 16, 8, budget)
    assert int(rescued.sum()) == budget
    seen = torch.zeros(300, dtype=torch.bool)
    seen[plan.order[in_grid | rescued].long()] = True
    assert (f[~seen] == 0).all() and (s[~seen] == 0).all()
    assert not seen[~t(alive)].any()


C_HW, C_CAP = 24.0, 24


def _cand_cfgs(**kw):
    kw = dict(dict(grid_max_per_cell=C_CAP), **kw)
    return tuple(pkg.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", formation_shape="none", world_hw=C_HW,
        max_speed=5.0, hashgrid_backend="pallas", hashgrid_neighbor_cap=48,
        hashgrid_kernel="candidates", **kw)
        for pkg in (jdsa, tdsa))


def _cand_state(n=300, seed=3, crowd=0):
    pos, alive = swarm_arrays(n, seed, C_HW * 0.9, dead=0.05, crowd=crowd,
                              crowd_sd=0.05)
    js = jdsa.make_swarm(n, seed=0).replace(pos=jnp.asarray(pos),
                                            alive=jnp.asarray(alive))
    return js, pos, alive


def _both_candidate_forces(cur, alive, jp, tp):
    want = candidate_sweep_pallas(jnp.asarray(cur), K_SEP, PS, EPS, jp,
                                  interpret=True)
    got = tcand.candidate_sweep(t(cur), K_SEP, PS, EPS, tp)
    portable = tnb.separation_grid_plan(t(cur), t(alive), K_SEP, PS, EPS, tp)
    scale = tcand.candidate_sweep_plain(t(cur), tp.cand, tp.recv, K_SEP, PS,
                                        EPS, tp.torus_hw,
                                        absolute=True).numpy()
    assert_banded(got.numpy(), want, scale, 1e-5, 1e-6, "vs jax")
    assert_banded(got.numpy(), portable.numpy(), scale, 1e-6, 1e-7,
                  "vs portable")
    return got


@pytest.mark.parametrize("case", ["skin0", "stale", "partial-chain",
                                  "cap-truncation"])
def test_candidates_path_matches_the_tpu_kernel(case):
    skin = 0.0 if case in ("skin0", "cap-truncation") else 0.5
    extra = dict(grid_max_per_cell=8) if case == "cap-truncation" else {}
    jcfg, tcfg = _cand_cfgs(hashgrid_skin=skin, **extra)
    js, pos, alive = _cand_state(crowd=16 if case == "cap-truncation" else 0)
    ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
    jp = j_build_tick_plan(js, jcfg)
    tp = tphys.build_tick_plan(ts, tcfg)
    assert_plan_equal(tp, jp)
    assert tp.cand.shape[1] == 128 and tp.recv.shape[1] == 2 * (
        extra.get("grid_max_per_cell", C_CAP))
    rng = np.random.default_rng(5)
    cur = pos
    if case == "stale":
        cur = (pos + rng.uniform(-0.2, 0.2, pos.shape)).astype(np.float32)
    got = _both_candidate_forces(cur, alive, jp, tp)
    if case == "partial-chain":
        for _ in range(3):
            cur = (cur + 0.45 * rng.normal(size=cur.shape)).astype(np.float32)
            jp = jhp.refresh_plan_partial(jnp.asarray(cur),
                                          jnp.asarray(alive), jp)
            tp = thp.refresh_plan_partial(t(cur), t(alive), tp)
            assert_plan_equal(tp, jp)
            got = _both_candidate_forces(cur, alive, jp, tp)
        assert int(tp.cells_rebuilt) > 0
    if case == "cap-truncation":
        assert int(tp.cap_overflow) > 0 and int(tp.recv_overflow) == 0
    assert (got.numpy()[~alive] == 0).all()


# --- dispatch ---------------------------------------------------------------

def test_backend_choice_is_static_in_config_and_device():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    base = tdsa.DEFAULT_CONFIG.replace(separation_mode="hashgrid",
                                       world_hw=64.0, grid_max_per_cell=16)
    for kernel in ("slots", "candidates"):
        cfg = base.replace(hashgrid_kernel=kernel)
        use = tphys.tick_uses_hashgrid_kernel
        assert not use(cfg, 2, torch.float32, cpu)
        assert use(cfg, 2, torch.float32, cuda)
        assert use(cfg.replace(hashgrid_backend="pallas"), 2, torch.float32,
                   cpu)
        assert not use(cfg.replace(hashgrid_backend="portable"), 2,
                       torch.float32, cuda)
        assert not use(cfg, 2, torch.float64, cuda)
        with pytest.raises(ValueError, match="envelope"):
            use(cfg.replace(hashgrid_backend="pallas"), 2, torch.float64,
                cpu)
    # Wider than the TPU envelope: K = 12 is no multiple of 8.
    assert tphys.tick_uses_hashgrid_kernel(
        base.replace(grid_max_per_cell=12), 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="hashgrid_kernel"):
        tphys.tick_uses_hashgrid_kernel(base.replace(hashgrid_kernel="x"), 2,
                                        torch.float32, cpu)
    with pytest.raises(ValueError, match="hashgrid_backend"):
        tphys.tick_uses_hashgrid_kernel(base.replace(hashgrid_backend="x"),
                                        2, torch.float32, cpu)


def test_cpu_ticks_run_the_plain_versions(monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("a kernel ran on a CPU tensor")

    monkeypatch.setattr(tgrid, "grid_sweep_cuda", no_kernel)
    monkeypatch.setattr(tcand, "candidate_sweep_cuda", no_kernel)
    before = (tgrid.LAUNCHES, tcand.LAUNCHES)
    s = tdsa.make_swarm(200, spread=14.0, device="cpu")
    s = s.replace(target=torch.zeros_like(s.pos),
                  has_target=torch.ones_like(s.has_target))
    for kernel in ("slots", "candidates"):
        cfg = tdsa.DEFAULT_CONFIG.replace(
            separation_mode="hashgrid", world_hw=16.0,
            hashgrid_backend="pallas", hashgrid_kernel=kernel)
        out = tdsa.physics_step(s, None, cfg)
        assert torch.isfinite(out.pos).all()
    assert (tgrid.LAUNCHES, tcand.LAUNCHES) == before


@pytest.mark.parametrize("module,entry", [
    ("grid_separation", "grid_sweep_cuda"),
    ("candidate_sweep", "candidate_sweep_cuda"),
])
def test_kernel_wrappers_reject_cpu_tensors_and_import_builds_nothing(
        module, entry):
    env = dict(os.environ, PATH="", CUDA_HOME=str(REPO / "no-such-dir"))
    code = (f"import distributed_swarm_algorithm_tpu_torch.ops.cuda."
            f"{module} as m; assert m._fn is None and m.LAUNCHES == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    mod = tgrid if module == "grid_separation" else tcand
    before = mod.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        if module == "grid_separation":
            pos, alive = swarm_arrays(40, 1, 16.0)
            plan = thp.build_hashgrid_plan(t(pos), t(alive), 16.0, 2.0, 8,
                                           g=16)
            mod.grid_sweep_cuda(mod.sweep_operands(t(pos), plan), 16, 8, 1,
                                64, K_SEP, PS, EPS, 16.0)
        else:
            c = torch.zeros((4, 8), dtype=torch.int32)
            mod.candidate_sweep_cuda(torch.zeros(4, 2), c, c, K_SEP, PS, EPS,
                                     16.0)
    assert mod.LAUNCHES == before


# --- the tick ---------------------------------------------------------------

MODES = {
    # The slots kernel (interpret mode in JAX), per-tick plans, the
    # converging swarm crowding past a cap of 8 so the rescue runs.
    "slots": dict(hashgrid_backend="pallas", grid_max_per_cell=8,
                  hashgrid_overflow_budget=64),
    # The candidates kernel on a carried plan with the partial refresh.
    "candidates-partial": dict(hashgrid_backend="pallas",
                               hashgrid_kernel="candidates",
                               grid_max_per_cell=24, hashgrid_skin=1.5,
                               hashgrid_neighbor_cap=48,
                               hashgrid_partial_refresh=True),
    # The portable union sweep on a carried plan, the global trigger.
    "portable": dict(hashgrid_backend="portable", hashgrid_skin=1.0,
                     grid_max_per_cell=16, hashgrid_neighbor_cap=48),
}


def tick_cfgs(mode):
    return tuple(pkg.DEFAULT_CONFIG.replace(
        separation_mode="hashgrid", world_hw=24.0, formation_shape="none",
        max_speed=5.0, **MODES[mode]) for pkg in (jdsa, tdsa))


@functools.lru_cache(maxsize=None)
def _jax_tick(mode):
    cfg, _ = tick_cfgs(mode)
    if cfg.hashgrid_skin > 0:
        return jax.jit(lambda s, p: j_tick_plan(s, None, cfg, p)[:2])
    return jax.jit(lambda s: jdsa.swarm_tick(s, None, cfg))


@pytest.mark.parametrize("mode", list(MODES))
def test_ticks_match_jax_from_its_state_with_kill_and_revive(mode):
    n, kill_at, revive_at = 256, 60, 130
    cfg, tcfg = tick_cfgs(mode)
    carry = cfg.hashgrid_skin > 0
    js = jdsa.make_swarm(n, seed=1, spread=18.0)
    js = jdsa.with_tasks(js, jnp.asarray(BENCH_TASKS))
    js = js.replace(target=jnp.broadcast_to(jnp.asarray([3.0, 0.0]),
                                            js.pos.shape),
                    has_target=jnp.ones_like(js.has_target))
    jp = j_build_tick_plan(js, cfg) if carry else None
    step = _jax_tick(mode)
    leaders, saw = [], set()
    for tick in range(1, 201):
        if tick == kill_at:
            js = jdsa.kill(js, [n - 1])
        if tick == revive_at:
            js = jdsa.revive(js, [n - 1])
        ts = tdsa.state_from_numpy(jax_to_numpy(js), device="cpu")
        jitter = jax_jitter(js, cfg)
        if carry:
            tp = thp.plan_from_numpy(jplan_to_numpy(jp), device="cpu")
            js, jp = step(js, jp)
            ts, tp = t_tick_plan(ts, None, tcfg, tp, jitter)
            assert_plan_equal(tp, jp, f"tick {tick}")
            saw.add((int(jp.rebuilds), int(jp.cells_rebuilt)))
        else:
            js = step(js)
            ts = tdsa.swarm_tick(ts, None, tcfg, jitter)
        want, got = jax_to_numpy(js), tdsa.state_to_numpy(ts)
        assert_discrete_equal(got, want, f"tick {tick}")
        for f in ("pos", "vel"):
            np.testing.assert_allclose(got[f], want[f], err_msg=f"{tick} {f}",
                                       **TICK_TOL)
        leaders.append(int(tdsa.current_leader(ts)[0]))
    assert leaders[kill_at - 2] == n - 1 and leaders[revive_at - 2] == n - 2
    assert leaders[-1] == n - 2          # a revived agent rejoins as follower
    if mode == "slots":
        p = tdsa.build_tick_plan(ts, tcfg)
        assert int(p.cap_overflow) > 0   # the rescue ran on the final ticks
    if mode == "candidates-partial":
        rebuilds = sorted({r for r, _ in saw})
        assert len(rebuilds) > 1 and len(saw) > len(rebuilds)


def test_rollout_carries_the_plan_and_returns_it():
    _, tcfg = tick_cfgs("candidates-partial")
    s = tdsa.make_swarm(128, spread=16.0, device="cpu", seed=2)
    s = s.replace(target=torch.zeros_like(s.pos),
                  has_target=torch.ones_like(s.has_target))
    jitter = torch.zeros((15, 128), dtype=torch.int32)
    (end, traj), plan = tdsa.swarm_rollout(s, None, tcfg, 15, record=True,
                                           jitter=jitter, return_plan=True)
    assert traj.shape == (15, 128, 2) and torch.equal(traj[-1], end.pos)
    assert int(plan.rebuilds) >= 1 and int(plan.cells_rebuilt) > 0
    # The same ticks by hand, plan carried.
    p = tdsa.build_tick_plan(s, tcfg)
    st = s
    for k in range(15):
        st, p = t_tick_plan(st, None, tcfg, p, jitter[k])
    assert torch.equal(st.pos, end.pos)
    assert_plan_equal(p, plan)          # a port plan reads like a JAX one
    # No carry without a skin (and a plain state back).
    out, none = tdsa.swarm_rollout(s, None, tcfg.replace(hashgrid_skin=0.0),
                                   2, jitter=jitter[:2], return_plan=True)
    assert none is None and out.pos.shape == (128, 2)


def test_vector_swarm_hashgrid_flow_and_cli(capsys):
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="hashgrid",
                                      world_hw=40.0, hashgrid_skin=1.0,
                                      hashgrid_neighbor_cap=48)
    sw = tdsa.VectorSwarm(96, spread=10.0, device="cpu", config=cfg)
    sw.set_target([5.0, 0.0])
    sw.add_tasks(BENCH_TASKS)
    sw.step(80)
    assert sw.leader() == (95, True)
    sw.kill([95])
    sw.step(40)
    assert sw.leader() == (94, True)
    assert torch.isfinite(sw.state.pos).all()
    rc = tcli.main(["swarm", "--device", "cpu", "--separation", "hashgrid",
                    "--world-hw", "64", "--n", "64", "--steps", "40",
                    "--spread", "12"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["leader"] == 63 and out["backend"] == "torch-cpu"
