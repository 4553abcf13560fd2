"""NSGA-II multi-objective search (Deb et al. 2002) in PyTorch.

Counterpart of ``ops/nsga2.py`` of the JAX package.  The population
converges to a Pareto front, ranked by non-dominated sorting and spread by
crowding distance:

- domination is one [P, P] comparison matrix (P = 2N parents and
  offspring); the ranks peel fronts one at a time.  On a CUDA tensor
  :func:`nondominated_ranks` launches kernel N1 (``ops/cuda/nsga2_ranks.py``,
  ``csrc/nsga2_ranks.cu``), which runs the whole peel on the card; on a CPU
  tensor it runs the JAX package's loop in plain PyTorch;
- crowding distance sorts each objective within the fronts with two stable
  sorts (objectives normalized by the population's span, as the JAX
  package does);
- SBX crossover and polynomial mutation are batched elementwise math (the
  genetic algorithm, ``ops/ga.py``, reuses them).

Selection: binary tournament on (rank, -crowding); survivors are the best
N of parents and offspring by the same key.  Each draw can be handed in
(``NSGA2Draws``, the GA's layout), so a test gives both packages the same
numbers.  A generation on the card reads nothing back, and
:func:`nsga2_run` replays it from a CUDA graph there (the JAX package's
run is one compiled ``lax.scan``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device
from . import _family
from ._numerics import fma, rdiv, sqrt_rn
from .cuda import nsga2_ranks as _n1
from .cuda.common import capture_graph, replays_graphs
from .cuda.nsga2_ranks import domination_matrix  # noqa: F401 (the JAX
#   package's ops/nsga2 holds it; here it lives beside the kernel it defines)

ETA_C = 15.0   # SBX crossover distribution index
ETA_M = 20.0   # polynomial-mutation distribution index
P_CROSS = 0.9  # per-pair crossover probability
FEAS_TOL = 1e-4  # constrained domination: a violation at most this is
#   feasible (the JAX package's band for equalities never exactly 0 in f32)


# --------------------------------------------------------------- sorting ops


def nondominated_ranks(
    objs: torch.Tensor,
    viol: Optional[torch.Tensor] = None,
    feas_tol: float = FEAS_TOL,
) -> torch.Tensor:
    """[P] int32 front index per individual (0 = Pareto front).  With
    ``viol``, fronts follow constrained domination (see
    ``domination_matrix``).  Kernel N1 on a CUDA tensor, the plain loop on
    a CPU tensor."""
    if objs.device.type == "cpu":
        return _n1.nsga2_ranks_plain(objs, viol, feas_tol)
    return _n1.nsga2_ranks_cuda(objs, viol, feas_tol)


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(key, stable=True)``: -0 and +0 equal, ties in index
    order."""
    return torch.sort(key, stable=True).indices


def _rank_major_order(key: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """The order by (rank, key), as two stable sorts."""
    o1 = _stable_order(key)
    return o1.index_select(0, _stable_order(rank.index_select(0, o1)))


def crowding_distance(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """[P] crowding distance within each front (larger = lonelier; a
    front's boundary members get +inf)."""
    p, m = objs.shape
    lo = objs.min(0).values
    span = torch.clamp(objs.max(0).values - lo, min=1e-12)
    norm = (objs - lo) / span
    crowd = torch.zeros((p,), dtype=objs.dtype, device=objs.device)
    inf = torch.full((p,), float("inf"), dtype=objs.dtype,
                     device=objs.device)
    for mm in range(m):
        order = _rank_major_order(norm[:, mm], rank)
        r = rank.index_select(0, order)
        v = norm[:, mm].index_select(0, order)
        same = r[1:] == r[:-1]
        no = torch.zeros((1,), dtype=torch.bool, device=objs.device)
        prev_same = torch.cat([no, same])
        next_same = torch.cat([same, no])
        prev_v = torch.cat([v[:1], v[:-1]])
        next_v = torch.cat([v[1:], v[-1:]])
        gap = torch.where(prev_same & next_same, next_v - prev_v, inf)
        # order is a permutation: a scatter adds each gap once.
        crowd = crowd + torch.empty_like(gap).scatter_(0, order, gap)
    return crowd


# ----------------------------------------------------------- variation ops


def _rand(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def sbx_crossover(
    parents_a: torch.Tensor,
    parents_b: torch.Tensor,
    lb: float,
    ub: float,
    eta_c: float,
    p_cross: float,
    gen: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated binary crossover, batched over [K, D] parent pairs.
    ``draws = (u [K, D], do [K, 1])`` are the uniforms of the spread factor
    and of the per-pair crossover test; without them they come from
    ``gen``."""
    if draws is None:
        draws = (_rand(gen, parents_a.shape, parents_a),
                 _rand(gen, (parents_a.shape[0], 1), parents_a))
    u, u_do = draws
    inv = 1.0 / (eta_c + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** inv,
                       rdiv(1.0, 2.0 * (1.0 - u)) ** inv)
    c1 = 0.5 * ((1 + beta) * parents_a + (1 - beta) * parents_b)
    c2 = 0.5 * ((1 - beta) * parents_a + (1 + beta) * parents_b)
    do = u_do < p_cross
    c1 = torch.where(do, c1, parents_a)
    c2 = torch.where(do, c2, parents_b)
    return torch.clamp(c1, lb, ub), torch.clamp(c2, lb, ub)


def polynomial_mutation(
    pos: torch.Tensor,
    lb: float,
    ub: float,
    eta_m: float,
    p_mut: float,
    gen: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Polynomial mutation, batched over [K, D].  ``draws = (u, do)``, both
    [K, D]: the perturbation's uniforms and the per-gene mutation test's;
    without them they come from ``gen``."""
    if draws is None:
        draws = (_rand(gen, pos.shape, pos), _rand(gen, pos.shape, pos))
    u, u_do = draws
    inv = 1.0 / (eta_m + 1.0)
    delta = torch.where(u < 0.5, (2.0 * u) ** inv - 1.0,
                        1.0 - (2.0 * (1.0 - u)) ** inv)
    out = pos + torch.where(u_do < p_mut, delta * (ub - lb),
                            torch.zeros_like(delta))
    return torch.clamp(out, lb, ub)


# One generation's draws, H = ceil(N / 2): the two tournaments' index pairs
# t1, t2 [2, H] in [0, N); SBX's (u [H, D], do [H, 1]); the mutation's
# (u [N, D], do [N, D]).  The genetic algorithm (ops/ga.py) draws the same.
NSGA2Draws = Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...],
                   Tuple[torch.Tensor, ...]]


def variation_draws(pos: torch.Tensor, gen: torch.Generator) -> NSGA2Draws:
    """One generation's draws for a population ``pos`` [N, D], from
    ``gen``."""
    n, d = pos.shape
    half = (n + 1) // 2
    u = lambda *s: torch.rand(s, generator=gen, dtype=pos.dtype,  # noqa: E731
                              device=pos.device)
    idx = lambda: torch.randint(0, n, (2, half), generator=gen,  # noqa: E731
                                device=pos.device)
    return idx(), idx(), (u(half, d), u(half, 1)), (u(n, d), u(n, d))


# ----------------------------------------------------------------- stepping


@dataclass
class NSGA2State(_family.FamilyState):
    """Struct-of-tensors population: N individuals, D dims, M objectives.
    ``viol`` is all zero for an unconstrained problem (constrained
    domination is then Pareto domination)."""

    pos: torch.Tensor        # [N, D]
    objs: torch.Tensor       # [N, M]
    viol: torch.Tensor       # [N] total constraint violation (0 = feasible)
    rank: torch.Tensor       # [N] i32 front index
    crowd: torch.Tensor      # [N] crowding distance
    gen: torch.Generator     # draws (JAX: key)
    iteration: torch.Tensor  # i32 scalar


NSGA2_TENSOR_FIELDS = _family.tensor_fields(NSGA2State)


def _violations(violation_fn, pos, like):
    if violation_fn is None:
        return torch.zeros((pos.shape[0],), dtype=like.dtype,
                           device=like.device)
    return violation_fn(pos)


def nsga2_init(
    objective: Callable,
    n: int,
    dim: int,
    lb: float = 0.0,
    ub: float = 1.0,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    violation_fn: Optional[Callable] = None,
    device: DeviceLike = None,
    pos: Optional[torch.Tensor] = None,
) -> NSGA2State:
    """``objective`` maps [K, D] -> [K, M] (batched, minimization).
    ``violation_fn`` ([K, D] -> [K] total violation, 0 = feasible, e.g.
    ``ops.constraints.violation``) switches ranking to constrained
    domination.  ``pos`` [n, dim] replaces the uniform draw in [lb, ub)
    from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    if pos is None:
        pos = _family.uniform(gen, (n, dim), dtype, dev, lb, ub)
    objs = objective(pos)
    viol = _violations(violation_fn, pos, objs)
    rank = nondominated_ranks(objs, viol)
    return NSGA2State(
        pos=pos, objs=objs, viol=viol, rank=rank,
        crowd=crowding_distance(objs, rank), gen=gen,
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _tournament(idx: torch.Tensor, rank: torch.Tensor,
                crowd: torch.Tensor) -> torch.Tensor:
    """Binary tournament on (rank asc, crowding desc): the winner of each
    column of ``idx`` [2, K]."""
    a, b = idx[0].long(), idx[1].long()
    ra, rb = rank.index_select(0, a), rank.index_select(0, b)
    a_wins = (ra < rb) | ((ra == rb) & (crowd.index_select(0, a)
                                        > crowd.index_select(0, b)))
    return torch.where(a_wins, a, b)


def nsga2_offspring(
    state: NSGA2State,
    lb: float = 0.0,
    ub: float = 1.0,
    eta_c: float = ETA_C,
    eta_m: float = ETA_M,
    p_cross: float = P_CROSS,
    p_mut: Optional[float] = None,
    draws: Optional[NSGA2Draws] = None,
) -> torch.Tensor:
    """N children [N, D]: ceil(N/2) tournament pairs, SBX (both children of
    each pair kept, the surplus one dropped at odd N) and polynomial
    mutation."""
    n, d = state.pos.shape
    if p_mut is None:
        p_mut = 1.0 / d
    t1, t2, sbx_draws, mut_draws = (variation_draws(state.pos, state.gen)
                                    if draws is None else draws)
    pa = state.pos.index_select(0, _tournament(t1, state.rank, state.crowd))
    pb = state.pos.index_select(0, _tournament(t2, state.rank, state.crowd))
    c1, c2 = sbx_crossover(pa, pb, lb, ub, eta_c, p_cross, draws=sbx_draws)
    children = torch.cat([c1, c2], dim=0)[:n]
    return polynomial_mutation(children, lb, ub, eta_m, p_mut,
                               draws=mut_draws)


def nsga2_select(all_objs: torch.Tensor, all_viol: torch.Tensor, n: int):
    """Elitist (mu + lambda) survival over parents and children: (the
    survivors' indices [n], ranks [2N], crowding [2N]).  Survivors by rank
    ascending, crowding descending, as two stable sorts (a float composite
    key would round the crowding away)."""
    all_rank = nondominated_ranks(all_objs, all_viol)
    all_crowd = crowding_distance(all_objs, all_rank)
    return (_rank_major_order(-all_crowd, all_rank)[:n], all_rank,
            all_crowd)


def nsga2_step(
    state: NSGA2State,
    objective: Callable,
    lb: float = 0.0,
    ub: float = 1.0,
    eta_c: float = ETA_C,
    eta_m: float = ETA_M,
    p_cross: float = P_CROSS,
    p_mut: Optional[float] = None,
    violation_fn: Optional[Callable] = None,
    draws: Optional[NSGA2Draws] = None,
) -> NSGA2State:
    """One generation, with no read from the device: tournament mating,
    SBX and polynomial mutation, elitist survival by (rank, crowding).
    Parents' violations ride in the state; only children are evaluated.
    ``draws`` replaces the draws from ``state.gen`` (see ``NSGA2Draws``)."""
    n = state.pos.shape[0]
    children = nsga2_offspring(state, lb, ub, eta_c, eta_m, p_cross, p_mut,
                               draws)
    child_objs = objective(children)
    all_pos = torch.cat([state.pos, children], dim=0)
    all_objs = torch.cat([state.objs, child_objs], dim=0)
    all_viol = torch.cat([state.viol, _violations(violation_fn, children,
                                                  child_objs)])
    survivors, all_rank, all_crowd = nsga2_select(all_objs, all_viol, n)
    pick = lambda x: x.index_select(0, survivors)  # noqa: E731
    return NSGA2State(pos=pick(all_pos), objs=pick(all_objs),
                      viol=pick(all_viol), rank=pick(all_rank),
                      crowd=pick(all_crowd), gen=state.gen,
                      iteration=state.iteration + 1)


def nsga2_run(
    state: NSGA2State,
    objective: Callable,
    n_steps: int,
    lb: float = 0.0,
    ub: float = 1.0,
    eta_c: float = ETA_C,
    eta_m: float = ETA_M,
    p_cross: float = P_CROSS,
    p_mut: Optional[float] = None,
    violation_fn: Optional[Callable] = None,
    draws: Optional[Sequence[NSGA2Draws]] = None,
) -> NSGA2State:
    """``n_steps`` generations; ``draws[i]`` replaces generation i's.  On a
    card without ``draws`` the generations are replayed from a CUDA graph
    of one (``_replayed_run``), equal to the eager loop bit for bit; the
    CPU and handed draws run the loop eagerly."""
    params = (lb, ub, eta_c, eta_m, p_cross, p_mut)
    if draws is None and n_steps > 0 and replays_graphs(state.pos.device):
        return _replayed_run(state, objective, violation_fn, params, n_steps)
    for i in range(n_steps):
        state = nsga2_step(state, objective, *params,
                           violation_fn=violation_fn,
                           draws=None if draws is None else draws[i])
    return state


class _Replay(NamedTuple):
    """A captured generation: its graph, the static state it reads and
    writes (its generator is the run's), the N1 launches its capture
    recorded, and what it was captured for (the objective, the constraint,
    the parameters, the fields' shapes and dtypes)."""

    graph: torch.cuda.CUDAGraph
    static: NSGA2State
    launches: int
    key: tuple


# The last capture, replayed by the next run whose state has the same
# generator and key (a model's later runs).
_replay: Optional[_Replay] = None


def _capture(state: NSGA2State, objective, violation_fn, params,
             key: tuple) -> _Replay:
    """Capture one generation into a CUDA graph over static copies of the
    state's tensors, with its generator registered, the generation's
    outputs copied back into them.  Raises, naming the objective and the
    constraint, if the capture fails (a function that waits for the device
    or leaves it cannot be captured), or if it did not record one N1
    launch."""
    static = state.replace(**{f: getattr(state, f).clone()
                              for f in NSGA2_TENSOR_FIELDS})

    def body():
        out = nsga2_step(static, objective, *params,
                         violation_fn=violation_fn)
        for f in NSGA2_TENSOR_FIELDS:
            getattr(static, f).copy_(getattr(out, f))

    _n1._captured = 0
    try:
        graph = capture_graph(body, state.gen, state.pos.device)
    except Exception as err:
        raise RuntimeError(
            f"NSGA-II's generation could not be captured into a CUDA graph: "
            f"the objective {objective!r} or the constraint {violation_fn!r} "
            "must run on the card without waiting for it (no .item(), no "
            "copy to the host, no numpy)") from err
    if _n1._captured != 1:
        raise RuntimeError("a captured NSGA-II generation must launch N1 "
                           f"once, got {_n1._captured}")
    return _Replay(graph, static, _n1._captured, key)


def _replayed_run(state: NSGA2State, objective, violation_fn, params,
                  n_steps: int) -> NSGA2State:
    """``n_steps`` generations on the card, each a replay of one captured
    generation (captured anew unless the last capture was made for this
    generator and key).  The generator is registered with the graph, so a
    replay draws from its offset at that replay and advances it as an
    eager generation does.  The state is copied into the graph's static
    tensors and the result copied out, so neither the caller's state nor
    a state an earlier run returned is ever written.  Each replay adds
    the N1 launches its capture recorded."""
    global _replay
    key = (objective, violation_fn, params,
           tuple((tuple(getattr(state, f).shape), getattr(state, f).dtype)
                 for f in NSGA2_TENSOR_FIELDS))
    r = _replay
    if r is None or r.static.gen is not state.gen or r.key != key:
        _replay = r = None          # the old graph's memory goes first
        r = _replay = _capture(state, objective, violation_fn, params, key)
    for f in NSGA2_TENSOR_FIELDS:
        getattr(r.static, f).copy_(getattr(state, f))
    for _ in range(n_steps):
        r.graph.replay()
        _n1.LAUNCHES += r.launches
    return r.static.replace(**{f: getattr(r.static, f).clone()
                               for f in NSGA2_TENSOR_FIELDS})


def nsga2_state_from_numpy(arrays: Mapping[str, np.ndarray],
                           device: DeviceLike = None,
                           seed: int = 0) -> NSGA2State:
    """An NSGA2State from numpy arrays named like its fields."""
    return _family.state_from_numpy(NSGA2State, arrays, device, seed)


def nsga2_state_to_numpy(state: NSGA2State) -> dict:
    """Every tensor field as a numpy array."""
    return _family.state_to_numpy(state)


# ------------------------------------------------------ problems & metrics
#
# The JAX package evaluates ZDT inside its compiled generation, where XLA
# sums a row of x[1:] in column order (rows of up to 31 genes; longer rows
# it vectorises), folds ``1 + 9 * (sum / (D - 1))`` into one multiply-add
# with the constant f32(9) * f32(1 / (D - 1)), and contracts ZDT2's and
# ZDT3's ``1 - q * q`` and ``(1 - sqrt q) - q * sin`` likewise.  The
# objectives decide the ranks, and a child that copies its parent must
# score as the parent did, so the port computes the same forms: ZDT1 and
# ZDT2 equal XLA's on the CPU bit for bit (ZDT3 up to XLA's ``sin``).  On
# the card the sum is one reduction, in its own order.


def _zdt_f1_g_q(pos: torch.Tensor):
    k, d = pos.shape
    f1 = pos[:, 0]
    if d == 1:
        s = torch.zeros_like(f1)
    elif pos.device.type == "cuda" or d > 32:
        s = pos[:, 1:].sum(1)
    else:
        s = pos[:, 1]
        for j in range(2, d):
            s = s + pos[:, j]
    nine_r = float(np.float32(9.0) * (np.float32(1.0) / np.float32(d - 1))
                   if d > 1 else float("inf"))
    g = fma(s, nine_r, 1.0)
    return f1, g, f1 / g


def zdt1(pos: torch.Tensor) -> torch.Tensor:
    """ZDT1 (convex front): [K, D] in [0, 1] -> [K, 2]."""
    f1, g, q = _zdt_f1_g_q(pos)
    return torch.stack([f1, g * (1.0 - sqrt_rn(q))], dim=1)


def zdt2(pos: torch.Tensor) -> torch.Tensor:
    """ZDT2 (concave front): [K, D] in [0, 1] -> [K, 2]."""
    f1, g, q = _zdt_f1_g_q(pos)
    return torch.stack([f1, g * fma(-q, q, 1.0)], dim=1)


def zdt3(pos: torch.Tensor) -> torch.Tensor:
    """ZDT3 (disconnected front): [K, D] in [0, 1] -> [K, 2]."""
    f1, g, q = _zdt_f1_g_q(pos)
    h = fma(-q, torch.sin(10.0 * np.pi * f1), 1.0 - sqrt_rn(q))
    return torch.stack([f1, g * h], dim=1)


MOO_PROBLEMS = {"zdt1": zdt1, "zdt2": zdt2, "zdt3": zdt3}


def zdt1_front(k: int = 256, device: DeviceLike = None) -> torch.Tensor:
    """[k, 2] points on the analytic ZDT1 front f2 = 1 - sqrt(f1)."""
    f1 = torch.linspace(0.0, 1.0, k, device=resolve_device(device))
    return torch.stack([f1, 1.0 - torch.sqrt(f1)], dim=1)


def zdt2_front(k: int = 256, device: DeviceLike = None) -> torch.Tensor:
    """[k, 2] points on the analytic ZDT2 front f2 = 1 - f1^2."""
    f1 = torch.linspace(0.0, 1.0, k, device=resolve_device(device))
    return torch.stack([f1, 1.0 - f1 ** 2], dim=1)


MOO_FRONTS = {"zdt1": zdt1_front, "zdt2": zdt2_front}


def igd(
    objs: torch.Tensor,
    ref_front: torch.Tensor,
    viol: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverted generational distance: the mean over reference points of
    the distance to the nearest attained (rank-0, feasible) point; lower
    is better."""
    on_front = nondominated_ranks(objs, viol) == 0
    if viol is not None:
        on_front = on_front & (viol <= FEAS_TOL)
    # Masked points sit at +inf, so they are never nearest.
    pts = torch.where(on_front[:, None], objs,
                      torch.full_like(objs, float("inf")))
    delta = ref_front[:, None, :] - pts[None, :, :]
    dist = torch.sqrt((delta * delta).sum(-1))
    return dist.min(1).values.mean()


def hypervolume_2d(
    objs: torch.Tensor,
    ref: torch.Tensor,
    viol: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hypervolume of the non-dominated subset of 2-D points against a
    reference point (minimization; larger is better): one sort and a
    running minimum.  With ``viol`` infeasible points add no area."""
    ref = torch.as_tensor(ref, dtype=objs.dtype, device=objs.device)
    if viol is not None:
        feasible = viol <= FEAS_TOL
        objs = torch.where(feasible[:, None], objs, ref.expand_as(objs))
    on_front = nondominated_ranks(objs) == 0
    if viol is not None:
        on_front = on_front & feasible
    # Dominated or absent points sit at the reference corner: no area.
    f1 = torch.where(on_front, objs[:, 0], ref[0])
    f2 = torch.where(on_front, objs[:, 1], ref[1])
    order = _stable_order(f1)
    f1s, f2s = f1.index_select(0, order), f2.index_select(0, order)
    # Widths on f1 clamped to the box: nothing past ref[0] adds area.
    f1c = torch.minimum(f1s, ref[0])
    width = torch.cat([f1c[1:], ref[:1]]) - f1c
    running_min = torch.cummin(f2s, 0).values
    height = torch.clamp(ref[1] - running_min, min=0.0)
    return (torch.clamp(width, min=0.0) * height).sum()
