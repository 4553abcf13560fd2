"""The host side of the redesigned Morton-window separation (B4) and of the
replayed window rollout, on the CPU.

- The cut without a square root: ``s < t`` where ``t = cut_threshold(r)``
  decides every non-negative float32 ``s`` as ``sqrt_rn(s) < r`` does, over
  the threshold's neighbourhood, random floats, subnormals, 0, Inf and NaN,
  for several ``r``.
- ``near_pair_queue``, the staged kernel's warp queue in numpy (the masks in
  shift order, the prefix offsets, the entries decoded from (lane, test)
  alone, each receiver's sum in queue order, crowded warps lane by lane),
  equal under ``np.array_equal`` to ``ops/neighbors.separation_window`` on
  sparse, crowded (all 32 shifts near), co-located and dead-heavy states,
  and, through it, within the JAX package's band of the JAX function.
- The replayed rollout's plumbing (full chunks from static tensors, the
  jitter rows, a shorter last chunk eagerly, the launch counts, the cache)
  against the eager rollout bit for bit across a kill, with a stand-in for
  the CUDA graph that runs the captured body again at each replay (the
  card's tests hold the real graph).

Tolerances: exact, but against the JAX package: ``|model - jax| <= 1e-5 *
sum|terms| + 1e-5`` per agent and axis, the band of
``tests/test_torch_window.py`` (XLA on the CPU fuses multiply-adds).  The
model rounds its near distances with the square root it is handed: the
card's (and numpy's) is IEEE's; PyTorch's on the CPU lands an ulp off for a
few tenths of a percent of inputs, so against the plain version on the CPU
the model takes PyTorch's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_swarm_algorithm_tpu_torch as tdsa
from distributed_swarm_algorithm_tpu.ops import neighbors as jnb
from distributed_swarm_algorithm_tpu_torch.models import swarm as tsw
from distributed_swarm_algorithm_tpu_torch.ops import neighbors as tnb
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    window_separation as twin,
)
from distributed_swarm_algorithm_tpu_torch.state import TENSOR_FIELDS

K_SEP, R, EPS, CELL = 20.0, 2.0, 1e-3, 2.0


def f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def torch_sqrt(x):
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


@pytest.mark.parametrize("r", [2.0, 1.5, 0.1, 3.0, 1e-30, 1e-40, 1e19,
                               3.4e38, float("inf"), 0.0, -1.0,
                               float("nan")])
def test_cut_threshold_decides_as_the_square_root(r):
    t = np.float32(twin.cut_threshold(r))
    rng = np.random.default_rng(7)
    tb = int(t.view(np.uint32))
    near = np.arange(max(tb - 4096, 0), min(tb + 4096, 0x7F800000) + 1)
    s = np.concatenate([
        f32(near),                                       # around t
        f32(rng.integers(0, 0x7F800000, 200_000)),       # any finite >= 0
        f32(rng.integers(0, 0x00800000, 20_000)),        # subnormals
        np.float32([0.0, -0.0, np.inf, np.nan, 4.0, 3.9999998]),
    ]).astype(np.float32)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(s) < np.float32(r)
    np.testing.assert_array_equal(s < t, want)


@pytest.mark.parametrize("r", [2.0, 0.7, 1e-30, 5e18])
def test_cut_threshold_is_the_least_such_float(r):
    t = np.float32(twin.cut_threshold(r))
    below = np.nextafter(t, np.float32(0))
    assert np.sqrt(t) >= np.float32(r) and np.sqrt(below) < np.float32(r)


def states():
    """(label, pos, alive, window) of the kinds of state the queue meets."""
    rng = np.random.default_rng(5)
    out = []
    n = 4096                                           # sparse: ~5% near
    out.append(("sparse", rng.uniform(-40, 40, (n, 2)), rng.random(n) > 0.1,
                16))
    n = 600                                            # every shift near
    out.append(("crowded", rng.uniform(-0.4, 0.4, (n, 2)), np.ones(n, bool),
                16))
    pos = rng.uniform(-30, 30, (1000, 2))              # co-located groups
    pos[1:999:3] = pos[0:999:3]
    pos[:40] = pos[0]
    out.append(("co-located", pos, np.ones(1000, bool), 16))
    n = 3000                                           # dead-heavy
    out.append(("dead-heavy", rng.uniform(-8, 8, (n, 2)), rng.random(n) > 0.9,
                16))
    out.append(("all dead", rng.uniform(-1, 1, (500, 2)), np.zeros(500, bool),
                16))
    out.append(("W=1, a partial warp", rng.uniform(-3, 3, (77, 2)),
                np.ones(77, bool), 1))
    out.append(("W=40, three groups", rng.uniform(-6, 6, (1500, 2)),
                rng.random(1500) > 0.2, 40))
    out.append(("n=1", np.zeros((1, 2)), np.ones(1, bool), 16))
    return out


STATES = states()


def sorted_state(pos, alive):
    pos = torch.from_numpy(np.asarray(pos, dtype=np.float32))
    alive = torch.from_numpy(np.asarray(alive))
    order = torch.sort(tnb.morton_keys(pos, CELL), stable=True).indices
    return pos[order].contiguous(), alive[order].contiguous()


@pytest.mark.parametrize("label,pos,alive,window", STATES,
                         ids=[s[0] for s in STATES])
def test_queue_model_equals_the_plain_sweep(label, pos, alive, window):
    p, a = sorted_state(pos, alive)
    got, counts = twin.near_pair_queue(p.numpy(), a.numpy(), K_SEP, R, EPS,
                                       window, sqrt=torch_sqrt)
    want = tnb.separation_window(p, a, K_SEP, R, EPS, CELL, window,
                                 presorted=True).numpy()
    assert np.array_equal(got, want)
    # The queue covers every near (slot, shift) pair once.
    near = 0
    for s, valid in tnb.window_shifts(p.shape[0], window):
        d = p - torch.roll(p, s, 0)
        both = valid & a & torch.roll(a, s, 0)
        near += int((both & (torch.sqrt((d * d).sum(1)) < R)).sum())
    assert int(counts.total.sum()) == near
    assert (counts.most <= 32).all() and (counts.total <= 32 * 32).all()
    queued = (counts.crowded == 0) & (counts.total > 0)
    assert (counts.rounds[queued] == -(-counts.total[queued] // 32)).all()
    assert (counts.rounds[queued] < counts.most[queued]).all()
    assert (counts.rounds[counts.total == 0] == 0).all()
    if label == "crowded":
        assert (counts.most == 32).any() and counts.crowded.any()
    if label == "sparse":
        assert counts.rounds.sum() > 0 and not counts.crowded.all()
    if label == "all dead":
        assert not got.any() and counts.total.sum() == 0


@pytest.mark.parametrize("label,pos,alive,window", STATES[:4],
                         ids=[s[0] for s in STATES[:4]])
def test_queue_model_is_within_the_band_of_the_jax_sweep(label, pos, alive,
                                                         window):
    p, a = sorted_state(pos, alive)
    got, _ = twin.near_pair_queue(p.numpy(), a.numpy(), K_SEP, R, EPS,
                                  window)
    want = np.asarray(jnb.separation_window(
        jnp.asarray(p.numpy()), jnp.asarray(a.numpy()), K_SEP, R, EPS, CELL,
        window, presorted=True))
    scale = tnb.separation_window(p, a, K_SEP, R, EPS, CELL, window,
                                  presorted=True, absolute=True).numpy()
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-5).all()


class StandInGraph:
    """A CUDA graph stand-in: capturing runs the body once as the stream
    would record it (the window wrapper counts into its capture tally, the
    generator's state is put back), and each replay runs it again."""

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
    """The window kernel's entry replaced by the plain sweep, counted as
    the kernel's wrapper counts, and the graph by ``StandInGraph``."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: StandInGraph.capturing)
    monkeypatch.setattr(tsw, "capture_graph", StandInGraph.capture)
    monkeypatch.setattr(tsw, "_chunk", None)

    def kernel(pos, alive, k_sep, r, eps, cell, window, presorted=False):
        out = tnb.separation_window(pos, alive, k_sep, r, eps, cell, window,
                                    presorted=presorted)
        if StandInGraph.capturing:
            twin._captured += 1
        else:
            twin.LAUNCHES += 1
        return out

    monkeypatch.setattr(twin, "separation_window", kernel)
    return monkeypatch


def scenario(n=320, seed=4):
    st = tdsa.make_swarm(n, spread=10.0, seed=seed, device="cpu")
    st = tdsa.with_tasks(st, [[1.0, 1.0], [-2.0, 3.0]])
    return st.replace(target=torch.full_like(st.pos, 30.0),
                      has_target=torch.ones_like(st.has_target))


@pytest.mark.parametrize("spans,with_jitter", [((40, 21), False),
                                               ((16, 16), True),
                                               ((59, 41), True),
                                               ((8, 3), False)])
def test_replayed_rollout_equals_the_eager_one(stand_in, spans, with_jitter):
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="window", sort_every=8)
    n = 320
    jitter = None
    if with_jitter:
        jitter = torch.from_numpy(np.random.default_rng(0).integers(
            0, 3, (sum(spans), n)).astype(np.int32))
    runs = {}
    for replayed in (False, True):
        stand_in.setattr(tsw, "replays_graphs", lambda dev: replayed)
        st, at, before, chunks = scenario(n), 0, twin.LAUNCHES, []
        for k, ticks in enumerate(spans):
            if k:
                st = tdsa.kill(st, [n - 1])
            st = tsw.swarm_rollout(
                st, None, cfg, ticks,
                jitter=None if jitter is None else jitter[at:at + ticks])
            at += ticks
            chunks.append(tsw._chunk)
        assert twin.LAUNCHES - before == sum(spans)
        runs[replayed] = st
    eager, replayed = runs[False], runs[True]
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(eager, f), getattr(replayed, f)), f
    assert torch.equal(eager.gen.get_state(), replayed.gen.get_state())
    assert [int(v) for v in tdsa.current_leader(replayed)] == [
        int(v) for v in tdsa.current_leader(eager)]
    # One capture serves the swarm's later rollouts.
    assert chunks[0] is not None and chunks[-1] is chunks[0]


def test_replayed_rollout_keeps_to_its_regime_and_raises(stand_in):
    stand_in.setattr(tsw, "replays_graphs", lambda dev: True)
    cfg = tdsa.DEFAULT_CONFIG.replace(separation_mode="window", sort_every=8)
    st = scenario()
    # Fewer ticks than a chunk and record=True stay eager.
    tsw.swarm_rollout(st, None, cfg, 7)
    tsw.swarm_rollout(st, None, cfg, 16, record=True)
    assert tsw._chunk is None
    out, plan = tsw.swarm_rollout(st, None, cfg, 16, return_plan=True)
    first = tsw._chunk
    assert plan is None and first is not None
    # Other obstacles, another generator or another config capture anew.
    obstacles = torch.tensor([[100.0, 100.0, 1.0]])
    tsw.swarm_rollout(out, obstacles, cfg, 8)
    assert tsw._chunk is not first and tsw._chunk.obstacles is obstacles
    tsw.swarm_rollout(out, obstacles, cfg.replace(sort_every=4), 8)
    assert tsw._chunk.key[0].sort_every == 4
    # A capture that does not launch the kernel once a tick raises, and
    # nothing runs eagerly in its place.
    stand_in.setattr(tsw, "_chunk", None)
    stand_in.setattr(twin, "separation_window",
                     lambda pos, *a, **kw: torch.zeros_like(pos))
    before = twin.LAUNCHES
    with pytest.raises(RuntimeError, match="once a tick"):
        tsw.swarm_rollout(st, None, cfg, 16)
    assert tsw._chunk is None and twin.LAUNCHES == before
    # The pallas, hashgrid and dense modes do not permute the agent axis.
    for mode in ("pallas", "hashgrid", "dense"):
        assert not tsw._permuting(cfg.replace(separation_mode=mode))
