"""The port's ant colony optimization (``ops/aco.py``, kernels B20 and B21's
plain versions in ``ops/cuda/aco_fused.py``, the ``ACO`` model and the CLI)
against the JAX package.

The same numpy inputs and JAX's own draws go through the JAX function and
the port's: the portable construction with the start cities, Gumbel noise
and exploit uniforms of JAX's key chain; the TPU kernels in interpret mode
with host draws (``rng="host"``, ``interpret=True``, as
``tests/test_pallas_aco.py`` runs them) against the port's plain versions,
JAX's host uniforms ``[(C - 1) Cp, A_pad]`` reshaped and sliced to
``[C - 1, C, A]``; three whole fused colony steps; and the cases of
``tests/test_aco.py`` and ``tests/test_pallas_aco.py`` on the port's CPU
path.

Tolerances, each with its reason:

- tours are exact wherever the argmax's winning margin lies outside a band,
  and the steps inside it are counted (an ant's tour is compared up to its
  first such step; at these sizes there are none or a few).  The band of a
  score: ``1e-6 (1 + |logit|)`` where the port computes the scores itself
  (``log`` is each library's own, a few ulps of the two terms), 0 where it
  is handed JAX's; and for the fused path's Gumbel noise ``2e-6 / inner +
  4e-6 + 1e-6 |g|`` with ``inner = -ln(1 - u)`` clipped: XLA contracts the
  bit-field ``log2``'s Horner steps into multiply-adds (2e-6, as
  ``tests/test_torch_ga.py`` bands it), and the outer ``log2`` divides that
  by ``inner``;
- lengths of the fused path equal JAX's bit for bit on a tour compared
  whole (both add ``dist[next, cur]`` step by step, then the closing edge);
  the portable ``tour_lengths`` sums in another order, ``rtol = 1e-6``;
- the deposit matrix against the TPU kernel: the reference's band, ``rtol =
  1e-4, atol = 1e-6`` (``tests/test_pallas_aco.py``); pheromone after whole
  steps ``rtol = 1e-5``, the scatter-adds' order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import aco as ja
from distributed_swarm_algorithm_tpu.ops.pallas import aco_fused as jaf
from distributed_swarm_algorithm_tpu_torch.cli import main as cli_main
from distributed_swarm_algorithm_tpu_torch.ops import aco as ta
from distributed_swarm_algorithm_tpu_torch.ops.cuda import aco_fused as taf

FIELDS = ta.ACO_TENSOR_FIELDS


def circle(c, r=10.0):
    th = np.linspace(0.0, 2 * np.pi, c, endpoint=False)
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


def instance(c, seed=0):
    """(JAX dist, JAX state) of C cities uniform in [0, 10)^2."""
    g = np.random.default_rng(seed)
    dist = ja.coords_to_dist(jnp.asarray(
        g.uniform(0, 10, (c, 2)).astype(np.float32)))
    return dist, ja.aco_init(dist, seed=0)


def to_port(js):
    return ta.aco_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def jax_portable_draws(key, c, n_ants):
    """``construct_tours``'s draws from JAX's key chain: (start [A], Gumbel
    [C - 1, A, C], exploit uniforms [C - 1, A])."""
    key, k0 = jax.random.split(key)
    start = jax.random.randint(k0, (n_ants,), 0, c)
    g, u = [], []
    for k in jax.random.split(key, c - 1):
        kg, kq = jax.random.split(k)
        g.append(jax.random.gumbel(kg, (n_ants, c), jnp.float32))
        u.append(jax.random.uniform(kq, (n_ants,)))
    return t(start), t(jnp.stack(g)), t(jnp.stack(u))


def jax_fused_draws(key, c, n_ants):
    """``fused_construct_tours(rng="host")``'s draws: (start [A], u
    [C - 1, C, A], u_q [C - 1, A]) sliced from its padded operands."""
    cp, a_pad = -(-c // 128) * 128, -(-n_ants // 128) * 128
    _, k0, ku, kq = jax.random.split(key, 4)
    start = jax.random.randint(k0, (a_pad,), 0, c)[:n_ants]
    u = jax.random.uniform(ku, ((c - 1) * cp, a_pad), jnp.float32)
    uq = jax.random.uniform(kq, (c - 1, a_pad), jnp.float32)
    return (t(start).to(torch.int32),
            t(u.reshape(c - 1, cp, a_pad)[:, :c, :n_ants]),
            t(uq[:, :n_ants]))


def near_ties(tours, logits, logit_band, q0, column, g=None, g_band=None,
              uq=None):
    """Per ant, the first step whose argmax margin lies inside the band
    (C - 1 where none does).  Scores are replayed in float64 along the
    port's tours: ``logits`` row (or column) ``cur`` plus ``g[s, a]`` where
    the ant samples, -1e30 at visited cities."""
    a_n, c = tours.shape
    first = np.full(a_n, c - 1)
    lg = np.asarray(logits, np.float64)
    lb = np.asarray(logit_band, np.float64)
    for a in range(a_n):
        seen = np.zeros(c, bool)
        seen[tours[a, 0]] = True
        for s in range(c - 1):
            cur = tours[a, s]
            row, band = (lg[:, cur], lb[:, cur]) if column else (lg[cur],
                                                                 lb[cur])
            greedy = q0 >= 1.0 or (q0 > 0.0 and uq[s, a] < q0)
            if not greedy:
                row = row + g[s, a]
                band = band + g_band[s, a]
            score = np.where(seen, -1e30, row)
            win = tours[a, s + 1]
            others = ~seen & (np.arange(c) != win)
            gap = score[win] - score[others]
            tol = band[win] + band[others]
            if ((gap <= tol) & (tol > 0)).any() or (gap < 0).any():
                first[a] = s
                break
            seen[win] = True
    return first


def gumbel_band(u):
    """The fused path's Gumbel band at uniforms ``u`` (see the module's
    docstring)."""
    v = np.clip(1.0 - u.astype(np.float64), 1e-7, 0.9999999)
    inner = -np.log(v)
    g = -np.log(inner)
    return 2e-6 / inner + 4e-6 + 1e-6 * np.abs(g)


def assert_tours_match(got, want, first, label):
    for a in range(got.shape[0]):
        f = first[a]
        np.testing.assert_array_equal(got[a, :f + 1], want[a, :f + 1],
                                      err_msg=f"{label} ant {a}")
    return int((first < got.shape[1] - 1).sum())


def test_constants_dist_and_lengths():
    assert (ta._EPS, ta._NEG) == (ja._EPS, ja._NEG)
    pts = np.asarray([[0.0, 0.0], [3.0, 4.0], [0.0, 1.0]], np.float32)
    d = ta.coords_to_dist(t(pts))
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(ja.coords_to_dist(pts)))
    assert float(d[0, 1]) == 5.0 and torch.equal(d, d.T)
    sq = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
                    np.float32)
    tours = np.asarray([[0, 1, 2, 3], [0, 2, 1, 3]], np.int32)
    lens = ta.tour_lengths(ta.coords_to_dist(t(sq)), t(tours))
    np.testing.assert_allclose(lens.numpy(), [4.0, 2.0 + 2.0 * np.sqrt(2.0)],
                               rtol=1e-6)
    dist, js = instance(20)
    ts = to_port(js)
    np.testing.assert_array_equal(
        ta.coords_to_dist(t(circle(20).astype(np.float32))).numpy(),
        np.asarray(ja.coords_to_dist(jnp.asarray(circle(20), jnp.float32))))
    tours = np.stack([np.random.default_rng(k).permutation(20)
                      for k in range(8)]).astype(np.int32)
    np.testing.assert_allclose(
        ta.tour_lengths(ts.dist, t(tours)).numpy(),
        np.asarray(ja.tour_lengths(dist, jnp.asarray(tours))), rtol=1e-6)
    # aco_init's pheromone level and the state's fields.
    mine = ta.aco_init(t(dist), seed=0)
    np.testing.assert_allclose(mine.tau.numpy(), np.asarray(js.tau),
                               rtol=1e-6)
    assert mine.best_tour.dtype == torch.int32 and mine.tau.shape == (20, 20)
    assert float(mine.best_len) == math.inf


@pytest.mark.parametrize("c,n_ants,q0", [(9, 16, 0.0), (16, 32, 0.5),
                                         (16, 32, 1.0), (23, 8, 0.9)])
def test_portable_construction_matches_jax(c, n_ants, q0):
    dist, js = instance(c, seed=c)
    key = jax.random.PRNGKey(c)
    want = np.asarray(ja.construct_tours(js.tau, dist, key, n_ants,
                                         q0=q0))
    draws = jax_portable_draws(key, c, n_ants)
    ts = to_port(js)
    got = ta.construct_tours(ts.tau, ts.dist, ts.gen, n_ants, q0=q0,
                             draws=draws).numpy()
    assert got.shape == (n_ants, c) and got.dtype == np.int32
    assert (np.sort(got, 1) == np.arange(c)).all()
    logits = ta.aco_logits(ts.tau, ts.dist, 1.0, 2.0).numpy()
    first = near_ties(got, logits, 1e-6 * (1 + np.abs(logits)), q0,
                      column=False, g=draws[1].numpy()[:, :, :],
                      g_band=np.zeros_like(draws[1].numpy()),
                      uq=draws[2].numpy())
    inside = assert_tours_match(got, want, first, f"C={c} q0={q0}")
    assert inside <= n_ants // 8, inside


def test_deposit_matches_jax():
    # test_aco.py's case, then random tours against the JAX scatter.
    d = torch.ones((4, 4)) - torch.eye(4)
    tours = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    out = ta.deposit(torch.full((4, 4), 2.0), tours,
                     ta.tour_lengths(d, tours), rho=0.5).numpy()
    assert out[0, 1] == out[1, 0] == 1.25 and out[0, 2] == 1.0
    dist, js = instance(16)
    g = np.random.default_rng(5)
    tours = np.stack([g.permutation(16) for _ in range(64)]).astype(np.int32)
    lengths = np.asarray(ja.tour_lengths(dist, jnp.asarray(tours)))
    want = np.asarray(ja.deposit(js.tau, jnp.asarray(tours),
                                 jnp.asarray(lengths), 0.3))
    got = ta.deposit(t(js.tau), t(tours), t(lengths), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_portable_steps_match_jax():
    dist, js = instance(12, seed=3)
    ts = to_port(js)
    key, draws = js.key, []
    for _ in range(3):
        key, kc = jax.random.split(key)
        draws.append(jax_portable_draws(kc, 12, 24))
    want = ja.aco_run(js, 3, 24, rho=0.2, elite=2.0)
    got = ta.aco_run(ts, 3, 24, rho=0.2, elite=2.0, draws=draws)
    np.testing.assert_array_equal(got.best_tour.numpy(),
                                  np.asarray(want.best_tour))
    np.testing.assert_allclose(float(got.best_len), float(want.best_len),
                               rtol=1e-6)
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(want.tau),
                               rtol=1e-5)
    assert int(got.iteration) == 3


# --------------------------------------------------------------------------
# B20 and B21: the plain versions against the TPU kernels in interpret mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("c,n_ants,q0", [(16, 128, 0.0), (16, 64, 0.5),
                                         (16, 64, 1.0), (48, 40, 0.0),
                                         (48, 40, 0.5), (48, 40, 1.0)])
def test_plain_tours_match_the_tpu_kernel(c, n_ants, q0):
    dist, js = instance(c, seed=c)
    key = jax.random.PRNGKey(c + 1)
    want_tours, want_len = (np.asarray(x) for x in jaf.fused_construct_tours(
        js.tau, dist, key, n_ants, q0=q0, rng="host", interpret=True,
        tile_a=128))
    start, u, uq = jax_fused_draws(key, c, n_ants)
    # JAX's own scores, handed to the kernel's entry as its operand.
    eta = 1.0 / (dist + jnp.eye(c) + ja._EPS)
    logits = np.asarray(jnp.log(js.tau + ja._EPS) + 2.0 * jnp.log(eta))
    tours, lengths = taf.construct_tours_t(t(logits), t(dist), start, None,
                                           q0, u, uq)
    got = tours.numpy()
    assert (np.sort(got, 1) == np.arange(c)).all()
    first = near_ties(got, logits, np.zeros_like(logits), q0, column=True,
                      g=np.stack([np.asarray(taf.gumbel_fast(u[s].T))
                                  for s in range(c - 1)]),
                      g_band=np.stack([gumbel_band(u[s].T.numpy())
                                       for s in range(c - 1)]),
                      uq=uq.numpy())
    inside = assert_tours_match(got, want_tours, first, f"C={c} q0={q0}")
    whole = first == c - 1
    np.testing.assert_array_equal(lengths.numpy()[whole], want_len[whole])
    assert inside <= n_ants // 8, inside
    if q0 >= 1.0:
        assert inside == 0
    # The in-kernel lengths are the ordered sums over the tours.
    assert torch.equal(lengths, taf.tour_lengths_in_order(t(dist), tours))
    np.testing.assert_allclose(
        lengths.numpy(), ta.tour_lengths(t(dist), tours).numpy(), rtol=1e-6)


def test_plain_tours_device_draws_and_constant_scores():
    # The Philox draws the kernel makes (seed, not operands), every q0
    # rule; constant scores make every greedy step a tie, which goes to the
    # lowest unvisited city.
    dist, js = instance(33, seed=1)
    c, a = 33, 20
    logits = ta.aco_logits(t(js.tau), t(dist), 1.0, 2.0)
    start = torch.arange(a, dtype=torch.int32) % c
    seed = torch.tensor([77], dtype=torch.int32)
    for q0 in (0.0, 0.5, 1.0):
        tours, lengths = taf.construct_tours_plain(logits, t(dist), start,
                                                   seed, q0)
        assert (np.sort(tours.numpy(), 1) == np.arange(c)).all()
        again = taf.construct_tours_plain(logits, t(dist), start, seed, q0)
        assert torch.equal(tours, again[0]) and torch.equal(lengths,
                                                            again[1])
        other = taf.construct_tours_plain(logits, t(dist), start, seed + 1,
                                          q0)[0]
        assert torch.equal(tours, other) == (q0 >= 1.0)
    flat = torch.zeros((c, c))
    tours, _ = taf.construct_tours_plain(flat, t(dist), start, seed, 1.0)
    for k in range(a):
        rest = [x for x in range(c) if x != int(start[k])]
        assert tours[k, 1:].tolist() == rest
    # The Gumbel transform's clip ends give finite noise.
    g = taf.gumbel_fast(torch.tensor([0.0, 1e-9, 0.5, 0.9999999]))
    assert torch.isfinite(g).all()


def test_plain_deposit_matches_the_tpu_kernel():
    dist, js = instance(16)
    g = np.random.default_rng(5)
    tours = np.stack([g.permutation(16) for _ in range(64)]).astype(np.int32)
    tours[:16] = tours[0]           # shared edges: cells summed over ants
    lengths = np.asarray(ja.tour_lengths(dist, jnp.asarray(tours)))
    want = np.asarray(jaf.fused_deposit_matrix(
        jnp.asarray(tours), jnp.asarray(lengths), tile_a=64, interpret=True))
    got = taf.fused_deposit_matrix(t(tours), t(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    scatter = np.asarray(ja.deposit(jnp.zeros((16, 16)), jnp.asarray(tours),
                                    jnp.asarray(lengths), rho=0.0))
    np.testing.assert_allclose((got + got.T).numpy(), scatter, rtol=1e-4,
                               atol=1e-6)
    # The fixed order: each cell is the sum over ants in ascending order,
    # from 0.
    amount = taf.rdiv(1.0, t(lengths))
    want_cells = np.zeros((16, 16), np.float32)
    nxt = np.roll(tours, -1, 1)
    for a in range(64):
        for k in range(16):
            i, j = tours[a, k], nxt[a, k]
            want_cells[i, j] = np.float32(want_cells[i, j] + amount[a].numpy())
    np.testing.assert_array_equal(got.numpy(), want_cells)
    assert torch.equal(got, taf.deposit_matrix_plain(t(tours), amount))
    # Any in-range tours, not only permutations; entries out of range add
    # nothing (a one-hot row of nothing in the TPU kernel).
    odd = np.asarray([[0, 0, 1, 1, 0], [2, 7, 2, -1, 3]], np.int32)
    amt = torch.tensor([1.0, 2.0])
    d = taf.deposit_matrix_plain(t(odd), amt).numpy()
    want_odd = np.zeros((5, 5), np.float32)
    want_odd[0, 0] = 2.0
    want_odd[0, 1] = 1.0
    want_odd[1, 1] = 1.0
    want_odd[1, 0] = 1.0
    want_odd[3, 2] = 2.0
    np.testing.assert_array_equal(d, want_odd)


def test_fused_steps_match_jax():
    dist, js = instance(16, seed=4)
    ts = to_port(js)
    key, draws = js.key, []
    for _ in range(3):
        key, kc = jax.random.split(key)
        draws.append(jax_fused_draws(kc, 16, 64))
    want = jaf.fused_aco_run(js, 3, 64, rho=0.2, q0=0.3, elite=2.0,
                             rng="host", interpret=True, tile_a=64)
    got = taf.fused_aco_run(ts, 3, 64, rho=0.2, q0=0.3, elite=2.0,
                            rng="host", draws=draws)
    np.testing.assert_array_equal(got.best_tour.numpy(),
                                  np.asarray(want.best_tour))
    assert float(got.best_len) == float(want.best_len)
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(want.tau),
                               rtol=1e-5)
    assert int(got.iteration) == 3 and bool((got.tau > 0).all())


def test_fused_colony_reaches_the_circle48_optimum():
    # test_pallas_aco.py's known-optimum gate on the port's CPU path: 48
    # cities on a circle, within 2% of the circle tour in 30 iterations.
    c, r = 48, 10.0
    th = 2 * math.pi * np.arange(c) / c
    coords = np.stack([r * np.cos(th), r * np.sin(th)], 1).astype(np.float32)
    dist = ta.coords_to_dist(t(coords))
    opt = float(ta.tour_lengths(dist, torch.arange(c)[None, :])[0])
    st = ta.aco_init(dist, seed=0)
    bests = [float(st.best_len)]
    for _ in range(3):
        st = taf.fused_aco_run(st, 10, 256, q0=0.1, elite=4.0)
        bests.append(float(st.best_len))
    assert bests == sorted(bests, reverse=True)
    assert bests[-1] / opt - 1.0 <= 0.02, (bests[-1], opt)
    assert sorted(st.best_tour.tolist()) == list(range(c))


def test_envelope_and_arguments():
    assert taf.aco_cuda_supported(1024, 1024)
    assert taf.aco_cuda_supported(2048, 1)
    assert not taf.aco_cuda_supported(2049, 1)
    with pytest.raises(ValueError, match="2048"):
        taf.require_supported(4096, 8)
    dist, js = instance(16)
    ts = to_port(js)
    with pytest.raises(ValueError, match="rng"):
        taf.fused_construct_tours(ts.tau, ts.dist, ts.gen, 8, rng="nope")
    with pytest.raises(ValueError, match="u must be"):
        taf.construct_tours_plain(ts.tau, ts.dist,
                                  torch.zeros(8, dtype=torch.int32), None,
                                  0.0, torch.zeros(15, 16, 9),
                                  torch.zeros(15, 8))
    with pytest.raises(ValueError, match="CUDA"):
        taf.construct_tours_cuda(ts.tau, ts.dist,
                                 torch.zeros(8, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        taf.deposit_matrix_cuda(torch.zeros((2, 4), dtype=torch.int32),
                                torch.ones(2))
    assert taf.TOURS_LAUNCHES == taf.DEPOSIT_LAUNCHES == 0


# --------------------------------------------------------------------------
# The model cases of tests/test_aco.py, on the port's CPU path
# --------------------------------------------------------------------------


def test_aco_solves_circle_tsp():
    colony = tdsa.ACO(coords=circle(12), n_ants=64, seed=0, rho=0.2,
                      elite=4.0, device="cpu")
    colony.run(120)
    d = ta.coords_to_dist(torch.tensor(circle(12), dtype=torch.float32))
    opt_len = float(ta.tour_lengths(d, torch.arange(12)[None, :])[0])
    assert colony.best_length < opt_len * 1.05
    assert np.sort(colony.best_tour).tolist() == list(range(12))


def test_aco_improves_seeded_and_step_matches_run():
    pts = np.random.default_rng(5).uniform(size=(20, 2)) * 10
    colony = tdsa.ACO(coords=pts, n_ants=32, seed=2, device="cpu")
    colony.run(5)
    early = colony.best_length
    colony.run(60)
    assert colony.best_length <= early
    colony = tdsa.ACO(coords=circle(10), n_ants=32, seed=0, q0=0.9,
                      elite=2.0, device="cpu")
    colony.run(60)
    assert np.sort(colony.best_tour).tolist() == list(range(10))
    pts = np.random.default_rng(7).uniform(size=(15, 2))
    a = tdsa.ACO(coords=pts, n_ants=24, seed=9, device="cpu")
    b = tdsa.ACO(coords=pts, n_ants=24, seed=9, device="cpu")
    a.run(30)
    b.run(30)
    assert a.best_length == b.best_length
    a = tdsa.ACO(coords=circle(8), n_ants=16, seed=3, device="cpu")
    b = tdsa.ACO(coords=circle(8), n_ants=16, seed=3, device="cpu")
    for _ in range(12):
        a.step()
    b.run(12)
    assert a.best_length == b.best_length
    assert int(a.state.iteration) == int(b.state.iteration) == 12


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_out_receives_the_last_tours(use_pallas):
    # run(..., out=) and step(out=) hand back the last iteration's tours and
    # lengths on either path: permutations, their lengths, none below the
    # best, and the colony's state as without out.
    pts = np.random.default_rng(11).uniform(size=(13, 2))
    a = tdsa.ACO(coords=pts, n_ants=20, seed=1, q0=0.3, elite=1.0,
                 use_pallas=use_pallas, device="cpu")
    b = tdsa.ACO(coords=pts, n_ants=20, seed=1, q0=0.3, elite=1.0,
                 use_pallas=use_pallas, device="cpu")
    out = {}
    a.run(6, out=out)
    b.run(6)
    np.testing.assert_array_equal(a.state.tau.numpy(), b.state.tau.numpy())
    tours, lengths = out["tours"], out["lengths"]
    assert tours.shape == (20, 13) and lengths.shape == (20,)
    assert (torch.sort(tours, 1).values == torch.arange(13)).all()
    want = (taf.tour_lengths_in_order if use_pallas
            else ta.tour_lengths)(a.state.dist, tours)
    assert torch.equal(lengths, want)
    assert float(lengths.min()) >= a.best_length
    step_out = {}
    a.step(out=step_out)
    assert not torch.equal(step_out["tours"], tours)


def test_model_validation_backend_switch_and_cli(monkeypatch, capsys):
    with pytest.raises(ValueError):
        tdsa.ACO(device="cpu")
    with pytest.raises(ValueError):
        tdsa.ACO(coords=np.zeros((4, 2)), dist=np.zeros((4, 4)),
                 device="cpu")
    with pytest.raises(ValueError):
        tdsa.ACO(dist=np.zeros((3, 4)), device="cpu")
    with pytest.raises(ValueError, match="2048"):
        tdsa.ACO(coords=np.random.default_rng(0).uniform(size=(2100, 2)),
                 use_pallas=True, device="cpu")
    colony = tdsa.ACO(coords=circle(10), n_ants=32, seed=0, q0=0.5,
                      use_pallas=True, device="cpu")
    assert colony.use_pallas
    colony.step()
    colony.run(20)
    assert np.sort(colony.best_tour).tolist() == list(range(10))
    assert tdsa.ACO(coords=circle(10), device="cpu").use_pallas is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsa.ACO(coords=circle(10))
    monkeypatch.undo()
    assert cli_main(["aco", "--device", "cpu", "--cities", "16", "--ants",
                     "32", "--steps", "10", "--q0", "0.2"]) == 0
    out = capsys.readouterr().out
    assert '"path": "portable"' in out and '"cities": 16' in out
