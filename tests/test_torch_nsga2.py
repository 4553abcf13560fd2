"""The port's NSGA-II (``ops/nsga2.py``, kernel N1's plain version in
``ops/cuda/nsga2_ranks.py``, the ``NSGA2`` model and CLI) against the JAX
package.

The same numpy inputs, and JAX's own draws from its key chain (the two
tournaments' index pairs, SBX's and the mutation's uniforms), go through
the JAX function and the port's.  The JAX generation runs compiled
(``nsga2_step`` is jitted), so the port's ZDT follows XLA's compiled
form.

Tolerances, each with its reason:

- ranks, domination, tournament winners, survivors: exact;
- crowding from the same objectives: exact (the same subtractions and
  IEEE divisions, the gaps added in the same order);
- children ``rtol = atol = 1e-6``: ``pow`` is each library's own (SBX's
  spread factor, the mutation's delta), a few ulps;
- objectives ``rtol = atol = 2e-6``: ZDT3's ``sin`` is each library's
  own, and children differ by their ulps; IGD and hypervolume ``1e-6``.

ZDT1 and ZDT2 equal XLA's compiled functions bit for bit (its sum order
and multiply-adds, a correctly rounded square root).  A generation from
one state feeds children that differ from JAX's by a few ulps of ``pow``
into the ranks; the tests hold each generation's ranks and survivors
exactly from JAX's state of the generation before (the port's own state
would carry the ulps on), and the selection exactly from the very same
objectives.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import nsga2 as jn
from distributed_swarm_algorithm_tpu_torch.models.nsga2 import NSGA2
from distributed_swarm_algorithm_tpu_torch.ops import nsga2 as tn
from distributed_swarm_algorithm_tpu_torch.ops.constraints import violation
from distributed_swarm_algorithm_tpu_torch.ops.cuda import nsga2_ranks as n1

REPO = Path(__file__).resolve().parent.parent
CHILD_TOL = dict(rtol=1e-6, atol=1e-6)
OBJ_TOL = dict(rtol=2e-6, atol=2e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def jranks(objs, viol=None):
    return np.asarray(jn.nondominated_ranks(
        jnp.asarray(objs), None if viol is None else jnp.asarray(viol)))


def test_constants_are_the_jax_packages():
    assert (tn.ETA_C, tn.ETA_M, tn.P_CROSS, tn.FEAS_TOL) == (
        jn.ETA_C, jn.ETA_M, jn.P_CROSS, jn.FEAS_TOL)
    assert sorted(tn.MOO_PROBLEMS) == sorted(jn.MOO_PROBLEMS)
    assert sorted(tn.MOO_FRONTS) == sorted(jn.MOO_FRONTS)


# --------------------------------------------------------------------------
# Domination and ranks (N1's plain version against the JAX loop)
# --------------------------------------------------------------------------


def test_domination_matrix_basic():
    objs = t(np.float32([[0, 0], [1, 1], [0, 1], [2, 0], [0, 0]]))
    dom = tn.domination_matrix(objs).numpy()
    assert dom[0, 1] and dom[0, 2] and dom[0, 3]
    assert not dom[1, 0]
    assert not dom[2, 3] and not dom[3, 2]
    assert not dom[0, 4] and not dom[4, 0]
    assert not dom.diagonal().any()


def test_constrained_domination_rules():
    objs = t(np.float32([[0, 0], [1, 1], [0.5, 0.5], [2, 2]]))
    viol = t(np.float32([0.0, 0.0, 0.2, 0.5]))
    dom = tn.domination_matrix(objs, viol).numpy()
    assert dom[0, 1] and not dom[1, 0]
    assert dom[1, 2] and not dom[2, 1]
    assert dom[2, 3] and not dom[3, 2]
    assert tn.domination_matrix(objs).numpy()[2, 1]
    np.testing.assert_array_equal(
        dom, np.asarray(jn.domination_matrix(jnp.asarray(objs.numpy()),
                                             jnp.asarray(viol.numpy()))))


def test_nondominated_ranks_peel_fronts():
    objs = t(np.float32([[0, 2], [2, 0], [1, 3], [3, 1], [2, 4], [4, 2]]))
    assert tn.nondominated_ranks(objs).tolist() == [0, 0, 1, 1, 2, 2]
    assert tn.nondominated_ranks(objs).dtype == torch.int32


def rank_case(kind, p, m, seed):
    """(objs [p, m] f32, viol [p] f32 or None) of the cases N1 is held to."""
    rng = np.random.default_rng(seed)
    objs = rng.uniform(0.0, 1.0, (p, m)).astype(np.float32)
    viol = None
    if kind == "chain":        # P fronts: point k dominates k + 1
        objs = np.repeat(np.arange(p, dtype=np.float32)[:, None], m, 1)
        objs = objs[rng.permutation(p)]
    elif kind == "equal":      # one front
        objs[:] = 0.25
    elif kind == "duplicates":
        objs = objs[rng.integers(0, max(1, p // 4), p)]
    elif kind == "signed":     # -0 equals +0; +-inf compare as numbers
        vals = np.float32([-0.0, 0.0, np.inf, -np.inf, 1.0, -1.0])
        objs = vals[rng.integers(0, len(vals), (p, m))]
    elif kind == "viol":       # feasible, infeasible, tied violations
        viol = rng.choice(np.float32([0.0, 1e-4, 2e-4, 0.5, 0.5, 3.0]),
                          p).astype(np.float32)
    elif kind == "viol_zero":  # the step's unconstrained form
        viol = np.zeros(p, np.float32)
    return objs, viol


RANK_CASES = (
    [("random", p, m) for p in (1, 31, 1025) for m in (1, 2, 3)]
    + [("random", 1024, 2), ("random", 2049, 2), ("chain", 200, 2),
       ("chain", 33, 1), ("equal", 1024, 3), ("duplicates", 1025, 2),
       ("duplicates", 64, 1), ("signed", 300, 2), ("signed", 31, 3),
       ("viol", 1024, 2), ("viol", 257, 3), ("viol_zero", 512, 2)]
)


@pytest.mark.parametrize("kind,p,m", RANK_CASES)
def test_plain_ranks_match_the_jax_loop(kind, p, m):
    objs, viol = rank_case(kind, p, m, seed=p * 7 + m)
    got = tn.nondominated_ranks(t(objs), None if viol is None else t(viol))
    want = jranks(objs, viol)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "chain":
        assert int(got.max()) == p - 1
    if kind == "equal":
        assert int(got.max()) == 0


def test_ranks_on_a_cpu_tensor_take_the_plain_version_and_cuda_raises():
    objs = t(np.float32([[0, 1], [1, 0], [2, 2]]))
    before = n1.LAUNCHES
    assert tn.nondominated_ranks(objs).tolist() == [0, 0, 1]
    assert n1.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        n1.nsga2_ranks_cuda(objs, None, tn.FEAS_TOL)


def packed_domination(objs, viol, feas_tol=tn.FEAS_TOL):
    """N1's pack in numpy: [W, p_pad] uint32, word w of column i holding
    the j of 32w..32w+31 that dominate i.  The j past P read objectives and
    violations of 0 (as the kernel stages them) and are cleared by the
    last word's mask; the columns past P are 0."""
    p, m = objs.shape
    p_pad = -(-p // 32) * 32
    obj_j = np.zeros((p_pad, m), np.float32)
    obj_j[:p] = objs
    a, b = obj_j[:, None, :], objs[None, :, :]          # [j, i, M]
    word = (a <= b).all(-1) & (a < b).any(-1)           # Pareto, [j, i]
    if viol is not None:
        v_j = np.zeros(p_pad, np.float32)
        v_j[:p] = viol
        feas = (v_j <= np.float32(feas_tol))[:, None]
        less = v_j[:, None] < viol[None, :]
        word = np.where((viol <= np.float32(feas_tol))[None, :],
                        feas & word, feas | less)
    word &= (np.arange(p_pad) < p)[:, None]
    cols = np.zeros((p_pad, p_pad), bool)
    cols[:, :p] = word
    shifts = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (cols.reshape(p_pad // 32, 32, p_pad)
            * shifts[None, :, None]).sum(1, dtype=np.uint32)


def register_peel(objs, viol, feas_tol=tn.FEAS_TOL):
    """N1's register peel in numpy: (rank [P] int32, fronts).  The
    unassigned set is W words (the last masked to P); a round ORs every
    word of an unassigned column against the set, with no early exit, and
    an unassigned point with no hit joins the front; a warp's ballot clears
    its joiners from the next set.  At most P rounds."""
    p = objs.shape[0]
    bits = packed_domination(objs, viol, feas_tol)
    n_words, p_pad = bits.shape
    left = np.array([np.uint32(0xFFFFFFFF) if p - 32 * w >= 32
                     else np.uint32((1 << (p - 32 * w)) - 1)
                     for w in range(n_words)], np.uint32)
    lanes = np.arange(p_pad)
    rank = np.full(p_pad, -1, np.int32)
    front, more = 0, True
    while more and front < p:
        mine = (left[lanes >> 5] >> (lanes & 31).astype(np.uint32)) & 1
        hit = np.bitwise_or.reduce(bits & left[:, None], axis=0)
        joins = (mine == 1) & (hit == 0)
        rank[joins] = front
        joined = (joins.reshape(n_words, 32).astype(np.uint32)
                  << np.arange(32, dtype=np.uint32)).sum(1, dtype=np.uint32)
        left = left & ~joined
        more = bool(left.any())
        front += 1
    return rank[:p], front


PEEL_CASES = (
    [("random", p, 2) for p in (1, 31, 32, 33, 1000, 1024)]
    + [("chain", p, 1) for p in (1, 32, 33, 1024)]
    + [("chain", 31, 2), ("chain", 1000, 2)]
    + [("equal", 33, 3), ("equal", 1024, 2), ("duplicates", 1000, 2),
       ("duplicates", 33, 3), ("signed", 1024, 3), ("signed", 32, 2),
       ("signed", 1000, 2), ("viol", 33, 2), ("viol", 1024, 2),
       ("viol", 1000, 3), ("viol_zero", 1024, 2), ("viol_zero", 31, 2),
       ("random", 1024, 3)]
)


@pytest.mark.parametrize("kind,p,m", PEEL_CASES)
def test_register_peel_model_equals_the_jax_ranks(kind, p, m):
    """The redesigned N1's word layout, last-word mask and round, with no
    early exit and the cap of P rounds, give JAX's ranks and front count
    exactly."""
    objs, viol = rank_case(kind, p, m, seed=p * 5 + m)
    got, fronts = register_peel(objs, viol)
    want = jranks(objs, viol)
    np.testing.assert_array_equal(got, want)
    assert fronts == int(want.max()) + 1
    if kind == "chain":
        assert fronts == p


# --------------------------------------------------------------------------
# Crowding, metrics, problems
# --------------------------------------------------------------------------


def test_crowding_boundaries_infinite_middle_finite():
    objs = t(np.float32([[0, 3], [1, 2], [2, 1], [3, 0]]))
    rank = tn.nondominated_ranks(objs)
    crowd = tn.crowding_distance(objs, rank).numpy()
    assert np.isinf(crowd[0]) and np.isinf(crowd[3])
    assert np.isfinite(crowd[1]) and crowd[1] == pytest.approx(crowd[2])


@pytest.mark.parametrize("kind,p,m", [("random", 200, 2), ("random", 97, 3),
                                      ("duplicates", 128, 2),
                                      ("viol", 150, 2), ("random", 1, 2),
                                      ("random", 2, 2)])
def test_crowding_matches_jax(kind, p, m):
    objs, viol = rank_case(kind, p, m, seed=p)
    rank = jranks(objs, viol)
    want = np.asarray(jax.jit(jn.crowding_distance)(jnp.asarray(objs),
                                                    jnp.asarray(rank)))
    got = tn.crowding_distance(t(objs), t(rank)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hypervolume_exact_cases():
    ref = torch.tensor([1.0, 1.0])
    hv = tn.hypervolume_2d(t(np.float32([[0.25, 0.75], [0.75, 0.25],
                                         [0.9, 0.9]])), ref)
    assert float(hv) == pytest.approx(0.3125, abs=1e-6)
    hv = tn.hypervolume_2d(t(np.float32([[0.5, 0.2], [5.0, -0.5]])),
                           torch.tensor([1.1, 1.1]))
    assert float(hv) == pytest.approx(0.54, abs=1e-6)
    objs = t(np.float32([[0.1, 0.1], [0.5, 0.5]]))
    viol = t(np.float32([1.0, 0.0]))
    assert float(tn.hypervolume_2d(objs, ref)) == pytest.approx(0.81,
                                                                abs=1e-6)
    assert float(tn.hypervolume_2d(objs, ref, viol)) == pytest.approx(
        0.25, abs=1e-6)


@pytest.mark.parametrize("kind", ["random", "viol", "duplicates"])
def test_hypervolume_and_igd_match_jax(kind):
    objs, viol = rank_case(kind, 300, 2, seed=5)
    ref = np.float32([1.1, 1.1])
    front = np.asarray(jn.zdt1_front(64))
    jv = None if viol is None else jnp.asarray(viol)
    tv = None if viol is None else t(viol)
    hv = float(jn.hypervolume_2d(jnp.asarray(objs), jnp.asarray(ref), jv))
    assert float(tn.hypervolume_2d(t(objs), t(ref), tv)) == pytest.approx(
        hv, rel=1e-6, abs=1e-6)
    d = float(jn.igd(jnp.asarray(objs), jnp.asarray(front), jv))
    assert float(tn.igd(t(objs), t(front), tv)) == pytest.approx(
        d, rel=1e-6, abs=1e-6)


def test_igd_exact_values_and_masking():
    ref = t(np.float32([[0, 1], [1, 0]]))
    assert float(tn.igd(t(np.float32([[0, 1], [1, 0], [2, 2]])), ref)) == (
        pytest.approx(0.0, abs=1e-6))
    objs2 = t(np.float32([[0.0, 1.1], [1.0, 0.1]]))
    assert float(tn.igd(objs2, ref)) == pytest.approx(0.1, abs=1e-6)
    got = float(tn.igd(objs2, ref, t(np.float32([1.0, 0.0]))))
    assert got == pytest.approx((np.hypot(1.0, 0.9) + 0.1) / 2, abs=1e-4)


@pytest.mark.parametrize("name", ["zdt1", "zdt2", "zdt3"])
@pytest.mark.parametrize("d", [2, 12, 30])
def test_zdt_problems_match_the_compiled_jax_functions(name, d):
    # ZDT1 and ZDT2 bit for bit (XLA's sum order and multiply-adds); ZDT3
    # within the band of XLA's sin.
    pos = np.random.default_rng(d).uniform(0, 1, (4096, d)).astype(np.float32)
    want = np.asarray(jax.jit(jn.MOO_PROBLEMS[name])(jnp.asarray(pos)))
    got = tn.MOO_PROBLEMS[name](t(pos)).numpy()
    if name == "zdt3":
        np.testing.assert_allclose(got, want, **OBJ_TOL)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            tn.MOO_FRONTS[name](33, device="cpu").numpy(),
            np.asarray(jn.MOO_FRONTS[name](33)), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# A generation: offspring, selection, the whole step, init
# --------------------------------------------------------------------------


def jax_draws(key, n, d):
    half = (n + 1) // 2
    _, kt1, kt2, kx, km = jax.random.split(key, 5)
    ku, kdo = jax.random.split(kx)
    mu, mdo = jax.random.split(km)
    return (t(jax.random.randint(kt1, (2, half), 0, n)),
            t(jax.random.randint(kt2, (2, half), 0, n)),
            (t(jax.random.uniform(ku, (half, d))),
             t(jax.random.uniform(kdo, (half, 1)))),
            (t(jax.random.uniform(mu, (n, d))),
             t(jax.random.uniform(mdo, (n, d)))))


@jax.jit
def jax_offspring(state):
    n, d = state.pos.shape
    _, kt1, kt2, kx, km = jax.random.split(state.key, 5)
    half = (n + 1) // 2
    w1 = jn._tournament(kt1, state.rank, state.crowd, n, half)
    w2 = jn._tournament(kt2, state.rank, state.crowd, n, half)
    c1, c2 = jn.sbx_crossover(kx, state.pos[w1], state.pos[w2], 0.0, 1.0,
                              jn.ETA_C, jn.P_CROSS)
    kids = jnp.concatenate([c1, c2], axis=0)[:n]
    return w1, w2, jn.polynomial_mutation(km, kids, 0.0, 1.0, jn.ETA_M,
                                          1.0 / d)


def jax_select(all_objs, all_viol, n):
    r = jn.nondominated_ranks(all_objs, all_viol)
    c = jn.crowding_distance(all_objs, r)
    oc = jnp.argsort(-c, stable=True)
    return oc[jnp.argsort(r[oc], stable=True)][:n], r, c


def port_state(js, device="cpu"):
    return tn.nsga2_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in tn.NSGA2_TENSOR_FIELDS},
        device=device)


def constraint(x):
    return 0.3 - x[:, 0]


@pytest.mark.parametrize("n,d", [(64, 6), (33, 4), (128, 12)])
def test_offspring_match_jax(n, d):
    js = jn.nsga2_run(jn.nsga2_init(jn.zdt1, n, d, seed=n), jn.zdt1, 3)
    w1, w2, kids = jax_offspring(js)
    draws = jax_draws(js.key, n, d)
    ps = port_state(js)
    np.testing.assert_array_equal(
        tn._tournament(draws[0], ps.rank, ps.crowd).numpy(), np.asarray(w1))
    np.testing.assert_array_equal(
        tn._tournament(draws[1], ps.rank, ps.crowd).numpy(), np.asarray(w2))
    got = tn.nsga2_offspring(ps, draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(kids), **CHILD_TOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("n,d", [(64, 6), (100, 8)])
def test_selection_matches_jax_from_the_same_objectives(n, d, constrained):
    rng = np.random.default_rng(n + d)
    pos = rng.uniform(0, 1, (2 * n, d)).astype(np.float32)
    objs = np.asarray(jax.jit(jn.zdt2)(jnp.asarray(pos)))
    viol = (np.maximum(0.3 - pos[:, 0], 0) if constrained
            else np.zeros(2 * n)).astype(np.float32)
    want = jax.jit(jax_select, static_argnums=2)(jnp.asarray(objs),
                                                 jnp.asarray(viol), n)
    got = tn.nsga2_select(t(objs), t(viol), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def check_generation(js, got, jfn, tfn, jviol, tviol):
    """``got``, the port's generation from JAX's state ``js`` with JAX's
    draws, against JAX: the winners exact and the children within the band
    of ``pow``; the survivors, ranks and crowding exact where JAX's
    selection sees the port's own parents and children; and, fed JAX's own
    children, the port's evaluation and selection equal to JAX's step
    (ZDT3: its ranks; ZDT3's sin is each library's own).  Returns JAX's
    next state."""
    n, d = js.pos.shape
    draws = jax_draws(js.key, n, d)
    w1, w2, jkids = jax_offspring(js)
    ps = port_state(js)
    np.testing.assert_array_equal(
        tn._tournament(draws[0], ps.rank, ps.crowd).numpy(), np.asarray(w1))
    np.testing.assert_array_equal(
        tn._tournament(draws[1], ps.rank, ps.crowd).numpy(), np.asarray(w2))
    kids = tn.nsga2_offspring(ps, draws=draws)
    np.testing.assert_allclose(kids.numpy(), np.asarray(jkids), **CHILD_TOL)

    def combined(children):
        objs = torch.cat([ps.objs, tfn(children)])
        viol = torch.cat([ps.viol, torch.zeros(n) if tviol is None
                          else tviol(children)])
        return torch.cat([ps.pos, children]), objs, viol

    all_pos, all_objs, all_viol = combined(kids)
    surv, rank, crowd = (np.asarray(a) for a in jax.jit(
        jax_select, static_argnums=2)(jnp.asarray(all_objs.numpy()),
                                      jnp.asarray(all_viol.numpy()), n))
    for f, want in (("pos", all_pos), ("objs", all_objs),
                    ("viol", all_viol)):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      want.numpy()[surv], err_msg=f)
    np.testing.assert_array_equal(got.rank.numpy(), rank[surv])
    np.testing.assert_array_equal(got.crowd.numpy(), crowd[surv])
    assert int(got.iteration) == int(js.iteration) + 1

    jnext = jn.nsga2_step(js, jfn, violation_fn=jviol)
    all_pos, all_objs, all_viol = combined(t(np.asarray(jkids)))
    surv, rank, crowd = tn.nsga2_select(all_objs, all_viol, n)
    np.testing.assert_array_equal(rank[surv].numpy(), np.asarray(jnext.rank))
    if tfn is not tn.zdt3:
        for f, mine in (("pos", all_pos), ("objs", all_objs),
                        ("viol", all_viol), ("crowd", crowd)):
            np.testing.assert_array_equal(
                mine[surv].numpy(), np.asarray(getattr(jnext, f)), err_msg=f)
    return jnext


@pytest.mark.parametrize("problem", ["zdt1", "zdt2", "zdt3"])
@pytest.mark.parametrize("constrained", [False, True])
def test_three_generations_match_jax(problem, constrained):
    # Each generation from JAX's state: a child that JAX's pow puts an ulp
    # off its parent and the port's onto it changes which dominates, so the
    # port's own state would carry such ulps on into the ranks.
    n, d = 48, 6
    jfn, tfn = jn.MOO_PROBLEMS[problem], tn.MOO_PROBLEMS[problem]
    jviol = (lambda x: jnp.maximum(0.3 - x[:, 0], 0.0)) if constrained \
        else None
    tviol = (lambda x: torch.clamp(0.3 - x[:, 0], min=0.0)) if constrained \
        else None
    js = jn.nsga2_init(jfn, n, d, seed=3, violation_fn=jviol)
    for _ in range(3):
        got = tn.nsga2_step(port_state(js), tfn, violation_fn=tviol,
                            draws=jax_draws(js.key, n, d))
        js = check_generation(js, got, jfn, tfn, jviol, tviol)


def test_init_matches_jax_from_the_same_positions():
    fns = dict(violation_fn=None)
    js = jn.nsga2_init(jn.zdt1, 100, 8, seed=4, **fns)
    ps = tn.nsga2_init(tn.zdt1, 100, 8, device="cpu",
                       pos=t(np.asarray(js.pos)))
    np.testing.assert_allclose(ps.objs.numpy(), np.asarray(js.objs),
                               **OBJ_TOL)
    np.testing.assert_array_equal(ps.rank.numpy(), np.asarray(js.rank))
    np.testing.assert_array_equal(ps.viol.numpy(), np.asarray(js.viol))
    assert ps.rank.dtype == torch.int32 and int(ps.iteration) == 0
    fresh = tn.nsga2_init(tn.zdt1, 100, 8, seed=4, device="cpu")
    assert fresh.pos.shape == (100, 8)
    assert float(fresh.pos.min()) >= 0.0 and float(fresh.pos.max()) < 1.0


def test_state_round_trips_through_numpy():
    ps = tn.nsga2_init(tn.zdt2, 16, 3, seed=1, device="cpu")
    back = tn.nsga2_state_from_numpy(tn.nsga2_state_to_numpy(ps),
                                     device="cpu")
    for f in tn.NSGA2_TENSOR_FIELDS:
        assert torch.equal(getattr(back, f), getattr(ps, f)), f


# --------------------------------------------------------------------------
# The model (the JAX package's cases) and the CLI
# --------------------------------------------------------------------------


def test_model_steps_match_jax_with_handed_draws():
    opt = NSGA2("zdt2", n=40, dim=5, seed=0, device="cpu")
    js = jn.nsga2_init(jn.zdt2, 40, 5, seed=0)
    for _ in range(3):
        opt.state = port_state(js)
        opt.step(draws=jax_draws(js.key, 40, 5))
        js_prev = js
        js = check_generation(js, opt.state, jn.zdt2, tn.zdt2, None, None)
    opt.state = port_state(js)
    want = np.asarray(js.objs)[np.asarray(js.rank) == 0]
    np.testing.assert_array_equal(opt.pareto_front(), want)
    assert opt.hypervolume([1.1, 1.1]) == pytest.approx(
        float(jn.hypervolume_2d(js.objs, jnp.asarray([1.1, 1.1]), js.viol)),
        rel=1e-6)
    assert opt.igd() == pytest.approx(
        float(jn.igd(js.objs, jn.zdt2_front(256), js.viol)), rel=1e-6)
    assert int(js_prev.iteration) == 2


def test_model_front_spread_on_zdt2():
    opt = NSGA2("zdt2", n=100, dim=8, seed=1, device="cpu")
    opt.run(200)
    front = opt.pareto_front()
    assert front[:, 0].min() < 0.15 and front[:, 0].max() > 0.85


def test_population_stays_in_domain_and_ranks_coherent():
    st = tn.nsga2_run(tn.nsga2_init(tn.zdt1, 64, 6, seed=2, device="cpu"),
                      tn.zdt1, 30)
    assert float(st.pos.min()) >= 0.0 and float(st.pos.max()) <= 1.0
    np.testing.assert_allclose(st.objs.numpy(), tn.zdt1(st.pos).numpy(),
                               atol=1e-5)
    assert torch.equal(st.rank, tn.nondominated_ranks(st.objs))
    assert int(st.iteration) == 30


def test_model_is_deterministic():
    a = NSGA2("zdt3", n=64, dim=6, seed=7, device="cpu")
    b = NSGA2("zdt3", n=64, dim=6, seed=7, device="cpu")
    a.run(25)
    b.run(25)
    assert torch.equal(a.state.objs, b.state.objs)


def test_model_rejects_bad_inputs():
    with pytest.raises(ValueError):
        NSGA2("nope", n=16, dim=4, device="cpu")
    with pytest.raises(ValueError):
        NSGA2("zdt1", n=16, dim=4, lb=1.0, ub=0.0, device="cpu")
    with pytest.raises(ValueError):
        NSGA2("zdt3", n=16, dim=4, device="cpu").igd()


def test_model_custom_objective():
    def bi_sphere(pos):
        return torch.stack([(pos ** 2).sum(1), ((pos - 1.0) ** 2).sum(1)], 1)

    opt = NSGA2(bi_sphere, n=64, dim=3, lb=-1.0, ub=2.0, seed=0,
                device="cpu")
    opt.run(100)
    front = opt.pareto_front()
    assert front[:, 0].min() < 0.05 and front[:, 1].min() < 0.05


def test_model_constrained_zdt1_front_respects_constraint():
    opt = NSGA2("zdt1", n=100, dim=8, seed=0, device="cpu",
                inequalities=[lambda x: 0.3 - x[:, 0]])
    opt.run(150)
    front = opt.pareto_front()
    assert len(front) > 10
    assert front[:, 0].min() >= 0.3 - 1e-3 and front[:, 0].min() < 0.35
    assert front[:, 0].max() > 0.8
    xs = opt.state.pos[opt.state.rank == 0].numpy()
    assert (xs[:, 0] >= 0.3 - 1e-3).all()


def test_model_equality_constraint_with_tolerance():
    opt = NSGA2("zdt1", n=100, dim=6, seed=0, device="cpu",
                equalities=[lambda x: x[:, 0] - 0.5])
    opt.run(200)
    assert abs(float(opt.state.pos[:, 0].median()) - 0.5) < 0.02
    assert abs(opt.pareto_front()[:, 0].min() - 0.5) < 0.02
    assert bool((opt.state.viol <= 1e-4).any())


def test_model_igd_on_zdt1():
    opt = NSGA2("zdt1", n=100, dim=8, seed=0, device="cpu")
    opt.run(150)
    assert opt.igd() < 0.02
    assert opt.igd(reference=tn.zdt1_front(128, device="cpu")) < 0.02
    assert opt.hypervolume([1.1, 1.1]) > 0.7


# --------------------------------------------------------------------------
# The replayed run (a CUDA graph of one generation), with a stand-in graph
# --------------------------------------------------------------------------


class StandInGraph:
    """A CUDA graph stand-in: capturing runs the body once as the stream
    would record it (N1's plain version counts into the capture tally, the
    generator's state is put back); each replay runs it again."""

    capturing = False

    def __init__(self, body):
        self.body = body

    def replay(self):
        StandInGraph.capturing = True
        try:
            self.body()
        finally:
            StandInGraph.capturing = False

    @classmethod
    def capture(cls, body, gen, device):
        state = gen.get_state()
        graph = cls(body)
        graph.replay()
        gen.set_state(state)
        return graph


@pytest.fixture
def stand_in(monkeypatch):
    """The replayed path on the CPU: ``nsga2_run`` replays stand-in graphs,
    N1's plain version counts as the kernel's wrapper does, and the
    captures made are listed."""
    plain = n1.nsga2_ranks_plain
    captures = []

    def counted(*a, **kw):
        if StandInGraph.capturing:
            n1._captured += 1
        else:
            n1.LAUNCHES += 1
        return plain(*a, **kw)

    def capture(body, gen, device):
        captures.append(gen)
        return StandInGraph.capture(body, gen, device)

    monkeypatch.setattr(n1, "nsga2_ranks_plain", counted)
    monkeypatch.setattr(tn, "capture_graph", capture)
    monkeypatch.setattr(tn, "replays_graphs", lambda dev: True)
    monkeypatch.setattr(tn, "_replay", None)
    return captures


def eager_loop(state, objective, steps, violation_fn=None, **params):
    for _ in range(steps):
        state = tn.nsga2_step(state, objective, violation_fn=violation_fn,
                              **params)
    return state


@pytest.mark.parametrize("constrained", [False, True])
def test_replayed_run_equals_the_eager_loop(stand_in, constrained):
    """Replayed generations (two runs, one capture) equal an eager loop of
    ``nsga2_step`` on every field and on the generator's state, and count
    one N1 launch a generation."""
    vf = ((lambda x: violation(x, (constraint,), ())) if constrained
          else None)
    runs = {}
    for replayed in (False, True):
        st = tn.nsga2_init(tn.zdt1, 32, 5, seed=3, violation_fn=vf,
                           device="cpu")
        assert bool((st.viol > 0).any()) == constrained
        before = n1.LAUNCHES
        if replayed:
            st = tn.nsga2_run(tn.nsga2_run(st, tn.zdt1, 2, violation_fn=vf),
                              tn.zdt1, 3, violation_fn=vf)
        else:
            st = eager_loop(st, tn.zdt1, 5, violation_fn=vf)
        runs[replayed] = (st, n1.LAUNCHES - before)
    (eager, le), (graph, lg) = runs[False], runs[True]
    for f in tn.NSGA2_TENSOR_FIELDS:
        assert torch.equal(getattr(eager, f), getattr(graph, f)), f
    assert torch.equal(eager.gen.get_state(), graph.gen.get_state())
    assert le == lg == 5 and len(stand_in) == 1
    assert int(graph.iteration) == 5


def test_replayed_run_captures_again_when_a_parameter_changes(stand_in):
    opt = NSGA2("zdt1", n=32, dim=5, seed=2, device="cpu")
    opt.run(2)
    opt.run(2)
    assert len(stand_in) == 1
    opt.p_cross = 0.5
    opt.run(2)
    assert len(stand_in) == 2
    want = eager_loop(
        tn.nsga2_init(tn.zdt1, 32, 5, seed=2, device="cpu"), tn.zdt1, 4)
    want = eager_loop(want, tn.zdt1, 2, p_cross=0.5)
    for f in tn.NSGA2_TENSOR_FIELDS:
        assert torch.equal(getattr(opt.state, f), getattr(want, f)), f
    other = NSGA2("zdt1", n=32, dim=5, seed=2, device="cpu")
    other.run(1)                       # another generator: a new capture
    assert len(stand_in) == 3 and stand_in[2] is other.state.gen


def test_replayed_run_never_writes_an_earlier_state(stand_in):
    opt = NSGA2("zdt2", n=32, dim=4, seed=5, device="cpu")
    first = opt.state
    kept = {f: getattr(first, f).clone() for f in tn.NSGA2_TENSOR_FIELDS}
    second = opt.run(3)
    after_second = {f: getattr(second, f).clone()
                    for f in tn.NSGA2_TENSOR_FIELDS}
    opt.run(3)
    for f in tn.NSGA2_TENSOR_FIELDS:
        assert torch.equal(getattr(first, f), kept[f]), f
        assert torch.equal(getattr(second, f), after_second[f]), f
    assert int(second.iteration) == 3 and int(opt.state.iteration) == 6


def test_replayed_run_names_an_objective_it_cannot_capture(stand_in):
    def host_bound(pos):
        if StandInGraph.capturing:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return tn.zdt1(pos)

    st = tn.nsga2_init(host_bound, 16, 4, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="could not be captured") as err:
        tn.nsga2_run(st, host_bound, 2)
    assert "host_bound" in str(err.value)
    # Handed draws and the eager step never capture.
    tn.nsga2_run(st, host_bound, 1, draws=[tn.variation_draws(
        st.pos, torch.Generator().manual_seed(1))])
    assert len(stand_in) == 1


def test_model_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        NSGA2("zdt1", n=16, dim=4)
    assert tdsa.NSGA2 is NSGA2


def test_cli_nsga2_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_swarm_algorithm_tpu_torch",
         "nsga2", "--device", "cpu", "--n", "32", "--dim", "6", "--steps",
         "20"], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["problem"] == "zdt1" and row["pop"] == 32
    assert row["backend"] == "torch-cpu" and row["front_size"] >= 1
    assert 0.0 < row["hypervolume@(1.1,1.1)"] <= 1.21
