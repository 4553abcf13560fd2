"""The host side of the redesigned SHADE generation (B14) and of its
replayed run, on the CPU.

- The generation can come from a counter tensor on the device (what a run
  replayed from a CUDA graph hands the kernel): the plain version draws
  exactly what it draws from the same generation as an int.
- The kernel's geometry: two [D][block] tiles (x and the trial) a block,
  128 lanes while they fit, inside the first version's envelope D <= 363.
- ``fused_shade_run`` writes the archive window in place on the run's own
  archive: still the JAX package's run (the band of
  ``tests/test_torch_shade.py``), and the caller's state is never written.
- The replay's plumbing (generations two at a time from static tensors, the
  odd last one eagerly, the counter, the launch counts, the cache) against
  the eager loop bit for bit, with a stand-in for the CUDA graph that runs
  the captured body again at each replay (the card's tests hold the real
  graph).

Tolerances: exact (``torch.equal``) but against the JAX package, whose band
``tests/test_torch_shade.py`` states (positions ``rtol = 1e-5`` and ``atol
= max(1e-5, 4e-6 hw)``: XLA fuses the mutant's products and sums, and
where it cancels the band is a few ulps of its largest term; fitness
``2e-5``, the success memory ``1e-5``).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu.ops import objectives as jobj
from distributed_swarm_algorithm_tpu.ops import shade as jsh
from distributed_swarm_algorithm_tpu.ops.pallas import shade_fused as jsf
from distributed_swarm_algorithm_tpu_torch.ops import objectives as tobj
from distributed_swarm_algorithm_tpu_torch.ops import shade as tsh
from distributed_swarm_algorithm_tpu_torch.ops.cuda import common, family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import shade_fused as tsf

FIELDS = tsh.SHADE_TENSOR_FIELDS
TOL = dict(rtol=1e-5, atol=1e-5)
OBJ_TOL = dict(rtol=2e-5, atol=2e-5)


def step_inputs(name, n, d, seed):
    """One generation's operands, drawn with numpy."""
    _, hw = tobj.get_objective(name)
    g = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32))
    pos = f32(g.uniform(-hw, hw, (d, n)))
    scalars = torch.tensor(
        [seed + 7, *g.integers(1, n // 128, 3), *g.integers(0, 384, 3),
         int(g.integers(0, 128)), int(g.integers(0, 65537))],
        dtype=torch.int32)
    return hw, (scalars, pos, tsf.OBJECTIVES_T[name](pos),
                f32(g.uniform(0.01, 1.0, (1, n))), f32(g.uniform(size=(1, n))),
                f32(g.uniform(-hw, hw, (d, n))),
                f32(g.uniform(-hw, hw, (d, 128))))


@pytest.mark.parametrize("step", [0, 1, 77, 255, 2**31 - 1])
@pytest.mark.parametrize("name,d", [("rastrigin", 30), ("griewank", 7),
                                    ("levy", 1)])
def test_step_from_a_counter_tensor_equals_an_int_step(step, name, d):
    hw, args = step_inputs(name, 512, d, step % 97)
    kw = dict(objective_name=name, half_width=hw, tile_n=128)
    want = tsf.fused_shade_step_plain(*args, step=step, **kw)
    got = tsf.fused_shade_step_t(
        *args, step=torch.tensor([step], dtype=torch.int32), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # Another generation draws other crossover and source uniforms.
    other = tsf.fused_shade_step_plain(*args, step=step ^ 1, **kw)
    assert not torch.equal(other[0], want[0])


@pytest.mark.parametrize("d", [1, 4, 29, 30, 31, 100, 227, 228, 363, 364,
                               908])
def test_kernel_geometry_keeps_both_tiles_in_a_block(d):
    block = tsf.kernel_block(d)
    if d > tsf.MAX_DIM:
        assert block == 0
        assert not tsf.shade_pallas_supported("sphere", torch.float32, d)
        return
    assert block in (128, 64, 32)
    assert 2 * d * block * 4 <= family.MAX_SHARED_BYTES
    if block < 128:
        assert 2 * d * (2 * block) * 4 > family.MAX_SHARED_BYTES
    assert tsf.shade_pallas_supported("sphere", torch.float32, d)


def jax_run_draws(key, steps, n_pad, d, tile_n):
    """What JAX's ``fused_shade_run(rng="host")`` draws per generation, in
    the port's ``SHADEGenDraws`` order (as ``tests/test_torch_shade.py``
    gathers them)."""
    base_key = jax.random.fold_in(key, 0x5AADE)
    n_tiles = n_pad // tile_n
    out = []
    for g in range(steps):
        kk = jax.random.fold_in(base_key, g)
        (k_slot, k_f, k_cr, k_sh, k_ln, k_win, k_hc,
         k_hs) = jax.random.split(kk, 8)
        lanes = jax.random.randint(k_ln, (4,), 0, tile_n)
        lanes = lanes.at[3].set(jax.random.randint(k_hs, (), 0, 128))
        kc1, kc2 = jax.random.split(k_hc)
        draws = (
            jax.random.randint(k_slot, (n_pad,), 0, jsh.H),
            jax.random.cauchy(k_f, (n_pad,), np.float32),
            jax.random.normal(k_cr, (n_pad,), np.float32),
            jax.random.randint(k_sh, (3,), 1, max(n_tiles, 2)),
            lanes,
            jax.random.randint(k_win, (), 0, n_pad // 128),
            jax.random.uniform(kc1, (d, n_pad), np.float32),
            jax.random.uniform(kc2, (1, n_pad), np.float32))
        out.append(tuple(torch.from_numpy(np.array(a)) for a in draws))
    return out


@pytest.mark.parametrize("name,n,frac", [("griewank", 896, 2),
                                         ("rastrigin", 1280, 8)])
def test_in_place_archive_window_is_still_the_jax_run(name, n, frac):
    # D = 30, three generations, as tests/test_torch_shade.py compares
    # whole runs; a window of half the lanes (frac 2) moves most of the
    # archive every generation.
    d, steps = 30, 3
    jfn, hw = jobj.get_objective(name)
    js = jsh.shade_run(jsh.shade_init(jfn, n, d, hw, seed=n), jfn, 1,
                       half_width=hw)
    ts = tsh.shade_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    before = {f: getattr(ts, f).clone() for f in FIELDS}
    tile, _ = family.lane_tiling(n, 128, d)
    tile, n_pad, _ = family.shrink_tile_for_donors(n, tile)
    draws = jax_run_draws(js.key, steps, n_pad, d, tile)
    want = jsf.fused_shade_run(js, name, steps, half_width=hw, tile_n=128,
                               rng="host", interpret=True,
                               archive_window_frac=frac)
    got = tsf.fused_shade_run(ts, name, steps, half_width=hw, tile_n=128,
                              rng="host", draws=draws,
                              archive_window_frac=frac)
    pos_tol = dict(rtol=1e-5, atol=max(1e-5, 4e-6 * hw))
    for f in ("pos", "archive", "best_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **pos_tol,
                                   err_msg=f)
    for f in ("fit", "best_fit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **OBJ_TOL,
                                   err_msg=f)
    for f in ("m_f", "m_cr"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    for f in ("mem_k", "archive_n"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert not np.array_equal(got.archive.numpy(), before["archive"].numpy())
    for f in FIELDS:                # the caller's state is not written
        assert torch.equal(getattr(ts, f), before[f]), f


class StandInGraph:
    """A CUDA graph stand-in: capturing runs the body once as the stream
    would record it (the wrappers count into their capture tallies, the
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
    """The SHADE wrapper's kernel replaced by its plain version, counted as
    the kernel's wrapper counts (into the capture tally while a graph
    captures), and the graph by ``StandInGraph``."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: StandInGraph.capturing)
    monkeypatch.setattr(tsf, "capture_graph", StandInGraph.capture)
    monkeypatch.setattr(tsf, "_replay", None)

    def kernel(*args, step=0, out=None, **kw):
        pos, fit = tsf.fused_shade_step_plain(*args, step=step, **kw)
        if out is not None:
            out[0].copy_(pos)
            out[1].copy_(fit)
            pos, fit = out
        if StandInGraph.capturing:
            tsf._captured += 1
        else:
            tsf.LAUNCHES += 1
        return pos, fit

    monkeypatch.setattr(tsf, "fused_shade_step_cuda", kernel)
    monkeypatch.setattr(tsf, "fused_shade_step_t", kernel)
    return monkeypatch


@pytest.mark.parametrize("steps", [[2], [5, 3], [8, 1, 4]])
def test_replayed_run_equals_the_eager_loop(stand_in, steps):
    fn, hw = tobj.get_objective("rastrigin")
    runs = {}
    for replayed in (False, True):
        stand_in.setattr(tsf, "replays_graphs", lambda dev: replayed)
        st = tsh.shade_init(fn, 700, 5, hw, seed=3, device="cpu")
        before, captures = tsf.LAUNCHES, []
        for k in steps:
            st = tsf.fused_shade_run(st, "rastrigin", k, half_width=hw,
                                     tile_n=128)
            captures.append(tsf._replay)
        assert tsf.LAUNCHES - before == sum(steps)
        runs[replayed] = st
    eager, replayed = runs[False], runs[True]
    for f in FIELDS:
        assert torch.equal(getattr(eager, f), getattr(replayed, f)), f
    assert torch.equal(eager.gen.get_state(), replayed.gen.get_state())
    # One capture, kept for the model's later runs of two generations or
    # more; a run of one generation runs eagerly.
    assert captures[0] is not None
    assert all(c is captures[0] for c in captures)


def test_replayed_run_captures_anew_and_raises_where_capture_fails(
        stand_in):
    stand_in.setattr(tsf, "replays_graphs", lambda dev: True)
    fn, hw = tobj.get_objective("sphere")
    st = tsh.shade_init(fn, 512, 4, hw, seed=1, device="cpu")
    one = tsf.fused_shade_run(st, "sphere", 1, half_width=hw, tile_n=128)
    assert tsf._replay is None
    two = tsf.fused_shade_run(one, "sphere", 2, half_width=hw, tile_n=128)
    first = tsf._replay
    other = tsh.shade_init(fn, 512, 4, hw, seed=1, device="cpu")
    tsf.fused_shade_run(other, "sphere", 2, half_width=hw, tile_n=128)
    assert tsf._replay is not first           # another generator
    tsf.fused_shade_run(two, "griewank", 2, half_width=hw, tile_n=128)
    assert tsf._replay.key[5] == "griewank"   # other parameters
    # A capture that does not launch the kernel once a generation raises,
    # and nothing runs eagerly in its place.
    stand_in.setattr(tsf, "_replay", None)
    stand_in.setattr(tsf, "fused_shade_step_cuda",
                     lambda *a, out=None, **kw: out)
    before = tsf.LAUNCHES
    with pytest.raises(RuntimeError, match="twice"):
        tsf.fused_shade_run(two, "sphere", 4, half_width=hw, tile_n=128)
    assert tsf._replay is None and tsf.LAUNCHES == before


def test_capture_helper_is_only_for_a_card():
    assert common.replays_graphs(torch.device("cuda", 0))
    assert not common.replays_graphs(torch.device("cpu"))
