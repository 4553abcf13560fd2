"""The redesigned GA kernel (B15, ``csrc/ga_fused.cu``) on the CPU: its
geometry (``ops/cuda/ga_fused.py: ga_geometry``), which the wrapper hands
to the kernel's entry, against the lanes the plain version reads; its
elitism, which follows the elite from generation to generation without a
rescan (``next_elite`` below), against ``torch.argmin``; and its
arithmetic, one power a draw and selected SBX coefficients
(``sbx_beta_selected``, ``mutation_delta_selected``, ``sbx_child_selected``
below), against the plain version's arms bit for bit.

Parent A's tournament reads two lanes of the tile's current generation
(``roll_lanes``): each must lie in a block of the tile's cluster, at the
place the kernel looks for it, for every lane shift a launch may draw.
Each variant's shared memory must fit a block, and the two variants
together must cover every D the first version took (any D).
"""

import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops._numerics import rdiv
from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import ga_fused as tgf
from distributed_swarm_algorithm_tpu_torch.ops.cuda.pso_fused import (
    MAX_SHARED_BYTES,
)
from distributed_swarm_algorithm_tpu_torch.ops.nsga2 import ETA_C, ETA_M


# The cluster kernel's forms (csrc/ga_fused.cu: gene, and the elite it
# follows), in PyTorch: one power of a selected argument, selected
# coefficients.  The same operations on the same operands as the plain
# version's arms (ga_fused.sbx_beta, mutation_delta, sbx_child), so the
# same bits.


def sbx_beta_selected(u, inv_c):
    """``sbx_beta`` as the kernel computes it: the argument selected
    first, then raised once."""
    arg = torch.where(u <= 0.5, 2.0 * u + 1e-12,
                      rdiv(1.0, 2.0 * (1.0 - u) + 1e-12))
    return tgf.pow_fast(arg, inv_c)


def mutation_delta_selected(um, inv_m):
    """``mutation_delta`` as the kernel computes it: one power of the
    selected argument, then ``p - 1`` or ``1 - p``."""
    lo = um < 0.5
    p = tgf.pow_fast(torch.where(lo, 2.0 * um + 1e-12,
                                 2.0 * (1.0 - um) + 1e-12), inv_m)
    return torch.where(lo, p - 1.0, 1.0 - p)


def sbx_child_selected(beta, uc, parent_a, parent_b, cross_lo, cross_hi):
    """``sbx_child`` as the kernel computes it: the coefficients
    ``p = lo ? 1 + beta : 1 - beta`` and ``q = lo ? 1 - beta : 1 + beta``
    selected per lane, then ``0.5 (p A + q B)`` where the lane crosses."""
    lo = uc < cross_lo
    cross = lo | (uc < cross_hi)
    p = torch.where(lo, 1.0 + beta, 1.0 - beta)
    q = torch.where(lo, 1.0 - beta, 1.0 + beta)
    return torch.where(cross, 0.5 * (p * parent_a + q * parent_b), parent_a)


def next_elite(ev, wv, wi, mv, mi):
    """The cluster kernel's elite for the next generation, without a
    rescan: from the current elite's fitness ``ev``, the children's (max,
    first lane) ``(wv, wi)`` and (min, first lane) ``(mv, mi)``.  Where
    ``ev < wv`` lane wi takes the elite's fitness, and the first least of
    the replaced row is wi where ``ev < mv`` or ``ev == mv`` and ``wi <
    mi``, else mi: ``torch.argmin``'s first-lane rule.  Returns the (value,
    lane) pair."""
    if ev < wv and (ev < mv or (ev == mv and wi < mi)):
        return ev, wi
    return mv, mi


def read_lanes(tile_n, shift):
    """[tile_n] the lane each lane of a tile reads at ``shift``, as the
    plain version rolls (``family.roll_lanes``)."""
    lanes = torch.arange(tile_n, dtype=torch.float32).reshape(1, 1, tile_n)
    return family.roll_lanes(lanes, torch.tensor(shift))[0].long()


def kernel_shift(tile_n, dls, shift):
    """The kernel's rolled shift for launch shifts ``dls`` at a step's
    rotation ``shift``: ``(dl mod tile_n + shift) mod tile_n`` (the launch's
    floor mod once, then 32-bit arithmetic, as the kernel)."""
    return (torch.remainder(dls, tile_n) + shift) % tile_n


def kernel_lanes(tile_n, shifts):
    """[len(shifts), tile_n] the lane the cluster kernel reads for each lane
    jl at each rolled shift: ``jl - shift``, wrapped into the tile."""
    e = torch.arange(tile_n)[None, :] - shifts[:, None]
    return torch.where(e < 0, e + tile_n, e)


@pytest.mark.parametrize("tile_n,dim", [(128, 30), (384, 30), (1000, 33),
                                        (4096, 30), (8192, 30)])
def test_ga_parents_lie_in_the_tiles_cluster(tile_n, dim):
    geo = tgf.ga_geometry(dim, tile_n)
    assert geo.variant == 0
    jl = torch.arange(tile_n)
    rank, t = jl // geo.lanes, jl % geo.lanes
    # Each lane of the tile is one thread's, in exactly one block.
    assert bool((rank < geo.cluster).all())
    assert geo.lanes <= geo.threads <= family.CLUSTER_MAX_LANES
    assert geo.threads % 32 == 0
    assert torch.equal(torch.unique(rank * geo.lanes + t), jl)
    # Every launch shift from -tile_n to 2 tile_n at each step's rotations
    # (parent A's two, parent B's two) rolls by its residue...
    dls = torch.arange(-tile_n, 2 * tile_n)
    for shift in {s for row in family.LANE_SHIFTS for s in row}:
        assert torch.equal(kernel_shift(tile_n, dls, shift),
                           torch.remainder(dls + shift, tile_n)), shift
    # ... and at every residue each lane reads the lane the plain version
    # rolls in, in a block of the tile's cluster, where the kernel looks.
    for shifts in torch.arange(tile_n).split(512):
        got = kernel_lanes(tile_n, shifts)
        want = (jl[None, :] - shifts[:, None]) % tile_n
        assert torch.equal(got, want)
        owner, at = got // geo.lanes, got % geo.lanes
        assert bool((owner < geo.cluster).all())
        assert torch.equal(owner * geo.lanes + at, want)
    for dl in (-tile_n, -1, 0, 1, tile_n - 114, tile_n - 1, tile_n,
               2 * tile_n - 1):
        for shift in (s for row in family.LANE_SHIFTS for s in row):
            rolled = kernel_shift(tile_n, torch.tensor([dl]), shift)
            assert torch.equal(kernel_lanes(tile_n, rolled)[0],
                               read_lanes(tile_n, dl + shift)), (dl, shift)


def _tiles(dim):
    """The tiles a run takes at this D (the JAX package's lane tiling of a
    large swarm) and explicit ones."""
    auto, _ = family.lane_tiling(1 << 20, None, dim)
    return sorted({auto, 96, 100, 128, 1000, 4096, 8192, 16384})


@pytest.mark.parametrize("dims", [range(1, 300), range(300, 4000, 7),
                                  range(4000, 9000, 97)])
def test_ga_variants_cover_any_width_within_a_block(dims):
    for dim in dims:
        for tile_n in _tiles(dim):
            geo = tgf.ga_geometry(dim, tile_n)
            assert geo.shared <= MAX_SHARED_BYTES, (dim, tile_n)
            if geo.variant == 0:
                assert geo.cluster in family.CLUSTER_SIZES
                assert geo.lanes == -(-tile_n // geo.cluster)
                assert geo.lanes <= family.CLUSTER_MAX_LANES
                assert geo.threads == -(-geo.lanes // 32) * 32
                # Two generations of the block's lanes, and its slots: the
                # warps' pairs, two inboxes of the blocks' pairs, the
                # constants and the elite.
                assert geo.shared == 4 * (2 * dim * geo.lanes
                                          + 2 * geo.lanes + 202)
            else:
                # One block a tile, through global scratch.
                assert (geo.cluster, geo.lanes, geo.shared) == (1, tile_n, 0)
                assert geo.threads == tgf.tile_threads(tile_n)
                assert 32 <= geo.threads <= 512 and geo.threads % 32 == 0
                assert tgf.global_geometry(dim, tile_n) == geo
            if tile_n == family.lane_tiling(1 << 20, None, dim)[0]:
                # A run's own tile stays on chip up to D = 3,618.
                assert geo.variant == (0 if dim <= 3618 else 1), dim
    # The main path: 16 blocks of 256 lanes, 62 KB each, three an SM.
    geo = tgf.ga_geometry(30, 4096)
    assert geo == (0, 16, 256, 256, 64296)
    assert 3 * (geo.shared + 1024) <= 228 * 1024
    # A tile of 8,192 in 16 blocks of 512 lanes up to D = 55; past it, and
    # past a tile of 8,192, the first version.
    assert tgf.ga_geometry(30, 8192)[:3] == (0, 16, 512)
    assert tgf.ga_geometry(55, 8192).variant == 0
    assert tgf.ga_geometry(56, 8192).variant == 1
    assert tgf.ga_geometry(30, 16384).variant == 1
    assert tgf.ga_geometry(3618, 128)[:3] == (0, 16, 8)
    assert tgf.ga_geometry(3619, 128).variant == 1
    # The smaller clusters the card tests reach: 1, 2, 4 and 8 blocks.
    assert [tgf.ga_geometry(30, t)[1] for t in (128, 512, 1000, 2048)] == [
        1, 2, 4, 8]
    assert tgf.ga_geometry(30, 1000)[2:4] == (250, 256)   # a ragged block


def _arg(values, sign):
    """(value, first lane) of the max (sign +1) or min (sign -1) of a row,
    by the kernel's rule: strictly better, or equal at a lower lane."""
    best_v, best_i = None, None
    for i, v in values:
        if best_v is None or (v > best_v if sign > 0 else v < best_v) or (
                v == best_v and i < best_i):
            best_v, best_i = v, i
    return best_v, best_i


@pytest.mark.parametrize("n_lanes,cluster", [(8, 1), (12, 4), (37, 8),
                                             (64, 16)])
def test_next_elite_is_the_argmin_of_the_replaced_row(n_lanes, cluster):
    # Rows from a few values with ties and both zeros; the elite drawn from
    # the same values (ev == m, ev == wv and ev above every child happen).
    g = np.random.default_rng(n_lanes + cluster)
    pool = np.array([-1.0, -0.0, 0.0, 0.5, 1.0, 2.0], dtype=np.float32)
    lanes = -(-n_lanes // cluster)
    bits = lambda v: np.float32(v).view(np.int32)  # noqa: E731
    for trial in range(300):
        row = torch.from_numpy(g.choice(pool, n_lanes))
        if trial % 7 == 0:
            row[:] = row[0]                        # every child equal
        ev = float(g.choice(pool))
        # The cluster's pairs: each block's, reduced in a random order.
        blocks = [[(i, float(row[i])) for i in range(r * lanes,
                                                     min(n_lanes,
                                                         (r + 1) * lanes))]
                  for r in range(cluster)]
        order = g.permutation(cluster)
        pairs = [_arg(blocks[r], s) for r in order for s in (1, -1)
                 if blocks[r]]
        wv, wi = _arg([(i, v) for v, i in pairs[0::2]], 1)
        mv, mi = _arg([(i, v) for v, i in pairs[1::2]], -1)
        assert wi == int(torch.argmax(row)) and mi == int(torch.argmin(row))
        assert (wv, mv) == (float(row.max()), float(row.min()))
        # The plain version's replaced row and its argmin.
        rep = row.clone()
        if ev < wv:
            rep[wi] = ev
        want_i = int(torch.argmin(rep))
        got_v, got_i = next_elite(ev, wv, wi, mv, mi)
        assert got_i == want_i, (row.tolist(), ev, wi, mi)
        assert bits(got_v) == bits(float(rep[want_i])), (row.tolist(), ev)


def _uniform_grid():
    """U[0, 1) draws as the kernel makes them (``k / 2^23``): every 97th,
    the edges 0, 1/2 and 1 - 2^-23 and their neighbours, 1 - ulp, and
    random ones."""
    k = np.concatenate([np.arange(0, 1 << 23, 97),
                        [0, 1, 2, (1 << 22) - 1, 1 << 22, (1 << 22) + 1,
                         (1 << 23) - 2, (1 << 23) - 1]])
    u = np.append((k / float(1 << 23)).astype(np.float32),
                  np.nextafter(np.float32(1), np.float32(0)))
    rnd = np.random.default_rng(5).random(20000, dtype=np.float32)
    return torch.from_numpy(np.concatenate([u, rnd]))


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("eta", [ETA_C, ETA_M, 2.0, 30.0])
def test_one_power_forms_equal_the_two_arms(eta):
    u = _uniform_grid()
    assert {0.0, 0.5, float(np.nextafter(np.float32(1), np.float32(0)))} <= {
        float(v) for v in u}
    inv = 1.0 / (eta + 1.0)
    assert _same_bits(sbx_beta_selected(u, inv), tgf.sbx_beta(u, inv))
    assert _same_bits(mutation_delta_selected(u, inv),
                      tgf.mutation_delta(u, inv))


@pytest.mark.parametrize("p_cross", [0.0, 0.3, 0.9, 1.0])
def test_selected_coefficients_equal_the_three_arms(p_cross):
    g = np.random.default_rng(int(p_cross * 10))
    u = _uniform_grid()
    m = u.numel()
    beta = tgf.sbx_beta(u, 1.0 / (ETA_C + 1.0))
    lo, hi = np.float32(0.5 * p_cross), np.float32(p_cross)
    edges = [0.0, lo, np.nextafter(lo, np.float32(0)),
             np.nextafter(lo, np.float32(1)), hi,
             np.nextafter(hi, np.float32(0)), np.nextafter(hi, np.float32(1))]
    uc = torch.from_numpy(np.where(
        g.random(m) < 0.3, g.choice(np.array(edges, dtype=np.float32), m),
        g.random(m, dtype=np.float32)).astype(np.float32))
    pa = torch.from_numpy(g.uniform(-5.12, 5.12, m).astype(np.float32))
    pb = torch.from_numpy(g.uniform(-5.12, 5.12, m).astype(np.float32))
    pa[::11] = -0.0
    pb[::13] = 0.0
    want = tgf.sbx_child(beta, uc, pa, pb, 0.5 * p_cross, p_cross)
    got = sbx_child_selected(beta, uc, pa, pb, 0.5 * p_cross, p_cross)
    assert _same_bits(got, want)


@pytest.mark.parametrize("rng", ["host", "device"])
@pytest.mark.parametrize("dim,p_mut", [(1, 0.3), (6, 0.1), (30, 1.0 / 30.0),
                                       (31, 0.05)])
def test_plain_tallies_the_work_the_function_needs(dim, p_mut, rng):
    # The plain version's tallies, on which B15's bound charges delta,
    # stream 1 and the crossover, against a count of the same draws: the
    # mutating elements, the elements of each group of four dimensions
    # (the last one shorter) that holds one, and the crossing lanes'.
    n, k, step0 = 256, (1 if rng == "host" else 3), 7
    g = np.random.default_rng(dim)
    scalars = torch.from_numpy(g.integers(0, 1000, 6).astype(np.int32))
    pos = torch.from_numpy(g.uniform(-5.12, 5.12, (dim, n))
                           .astype(np.float32))
    fit = torch.from_numpy(g.random((1, n), dtype=np.float32))
    gen = torch.Generator().manual_seed(dim)
    draws = (tgf.host_draws(gen, (dim, n), (1, n), "cpu") if rng == "host"
             else ())
    counts = {}
    tgf.fused_ga_step_plain(scalars, pos, fit, *draws,
                            objective_name="rastrigin", p_mut=p_mut,
                            tile_n=128, rng=rng, k_steps=k, step0=step0,
                            counts=counts)
    want = {"mutated": [], "mutating_group_elements": [],
            "crossing_elements": []}
    for step in range(step0, step0 + k):
        if rng == "host":
            uc, ud = draws[1].numpy(), draws[3].numpy()
        else:
            uc, ud = (tgf.philox_uniforms(scalars[0:1], n, rows, step,
                                          s).numpy()
                      for rows, s in ((1, 3), (dim, 2)))
        mut = ud < np.float32(p_mut)
        assert 0 < int(mut.sum()) < mut.size
        want["mutated"].append(int(mut.sum()))
        want["mutating_group_elements"].append(sum(
            min(4, dim - q) * int(mut[q:q + 4].any(axis=0).sum())
            for q in range(0, dim, 4)))
        want["crossing_elements"].append(
            int((uc < np.float32(tgf.P_CROSS)).sum()) * dim)
    assert {key: [int(v) for v in vals]
            for key, vals in counts.items()} == want
