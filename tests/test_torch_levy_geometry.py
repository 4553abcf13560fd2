"""The geometry of the redesigned parallel-tempering (B18) and Harris-hawks
(B13) kernels, which their wrappers hand to the kernels' entries
(``ops/cuda/tempering_fused.py: pt_geometry``, ``ops/cuda/hho_fused.py:
hho_geometry``), and the two rules the kernels follow in place of their
first versions': PT's running best kept per warp, HHO's lanes regrouped by
branch (``hho_fused.branch_order``).

A PT block owns a run of a tile's chains and stages a halo of h chains on
each side: after r exchange rounds a chain depends on the chains within r
of it, so every own chain's cone of h chains must lie in its window, and
the blocks' own runs must cover each tile exactly once.  Each variant's
shared memory must fit a block, and the variants together must cover
every D the first versions took (PT D <= 360 at the widest halo, HHO D <=
605).  Integer bookkeeping and orderings: exact.
"""

import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    hho_fused as thf,
    tempering_fused as tpf,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda.pso_fused import (
    MAX_SHARED_BYTES,
)

# The halos a launch can need: ceil(k / swap_every) for k <= 16.
HALOS = sorted({tpf.halo(k, s) for k in range(1, 17) for s in range(1, 17)})


def windows(geo, tile_n, halo_lanes):
    """Per block of a tile: the columns it owns and the columns its window
    stages (tile columns only), as the kernel places them: window thread t
    holds column b * own - h + t, the own lanes t in [h, h + own)."""
    out = []
    for b in range(-(-tile_n // geo.own)):
        c0 = b * geo.own
        staged = min(geo.window, geo.own + 2 * halo_lanes)
        cols = np.arange(c0 - halo_lanes, c0 - halo_lanes + staged)
        cols = cols[(cols >= 0) & (cols < tile_n)]
        owned = np.arange(c0, min(c0 + geo.own, tile_n))
        out.append((owned, cols))
    return out


@pytest.mark.parametrize("halo_lanes", HALOS)
@pytest.mark.parametrize("tile_n", [128, 200, 1000, 4096, 8192])
def test_pt_windows_hold_every_cone_and_tile_each_tile_once(halo_lanes,
                                                            tile_n):
    for dim in (1, 30, 109, 110, 215, 216):
        geo = tpf.pt_geometry(dim, halo_lanes)
        if geo.own == 0:
            continue
        assert geo.window % 32 == 0
        seen = np.zeros(tile_n, dtype=np.int64)
        for owned, cols in windows(geo, tile_n, halo_lanes):
            seen[owned] += 1
            staged = set(cols.tolist())
            for c in owned:
                cone = range(max(c - halo_lanes, 0),
                             min(c + halo_lanes + 1, tile_n))
                assert staged.issuperset(cone), (dim, c)
        assert bool((seen == 1).all()), dim


@pytest.mark.parametrize("dims", [range(1, 110), range(110, 216),
                                  range(216, 361)])
def test_pt_variants_cover_every_width_to_360(dims):
    for dim in dims:
        for halo_lanes in HALOS:
            geo = tpf.pt_geometry(dim, halo_lanes)
            assert geo.shared + tpf.STATIC_RESERVE <= MAX_SHARED_BYTES
            if geo.variant == 0:
                # Windows of 256 threads owning 256 - 2h chains, two planes
                # of positions and candidates.
                assert (geo.window, geo.own) == (256, 256 - 2 * halo_lanes)
                assert dim <= 109
                assert geo.shared == 4 * (2 * dim * 256 + 8 * dim + 1024)
            else:
                assert dim > 109
                assert geo == tpf.candidate_tile_geometry(dim, halo_lanes)
                assert geo.own == tpf.kernel_block(dim, halo_lanes) > 0
    # Past the first version's envelope no variant runs.
    assert tpf.kernel_block(361, 16) == 0
    assert not tpf.pt_pallas_supported("rastrigin", torch.float32, 361)


@pytest.mark.parametrize("swap_every,share", [(5, 4096 / 4352),
                                              (1, 4096 / 4864)])
def test_pt_main_path_fills_its_warps(swap_every, share):
    # The main path: 16 steps a launch, a tile of 4,096 chains at D = 30.
    h = tpf.halo(16, swap_every)
    geo = tpf.pt_geometry(30, h)
    blocks = -(-4096 // geo.own)
    assert geo[:3] == (0, 256, 256 - 2 * h)
    assert 4096 / (blocks * geo.window) == pytest.approx(share)
    if swap_every == 5:
        # 17 blocks of 248 chains: 94% of the threads on owned chains
        # (80% in the first version's 160-thread windows of 128), and 3
        # blocks (24 warps) an SM in 65 KB each.
        assert (blocks, geo.own) == (17, 248)
        assert share >= 0.9
        first = tpf.candidate_tile_geometry(30, h)
        assert 4096 / (32 * first.window) == pytest.approx(0.8)
        assert 3 * (geo.shared + tpf.STATIC_RESERVE) <= 228 * 1024


def per_lane_best(fits, mine):
    """The first version's rule: each own lane keeps its least fitness,
    moving only on a strict improvement; the block takes the least, the
    first lane on ties.  Returns (value, lane, step) of the position the
    block reports (the step at which that lane's best was set)."""
    steps, lanes = fits.shape
    best = fits[0].copy()
    when = np.zeros(lanes, dtype=np.int64)
    for s in range(1, steps):
        better = fits[s] < best
        best = np.where(better, fits[s], best)
        when = np.where(better, s, when)
    own = np.flatnonzero(mine)
    lane = own[np.argmin(best[own])]     # the first of the least
    return best[lane], int(lane), int(when[lane])


def warp_best(fits, mine):
    """The redesign's rule: each warp keeps (value, lane, step), replaced
    where a step's own lane is strictly less in (value, lane) order; the
    block takes the least (value, lane) of its warps."""
    steps, lanes = fits.shape
    kept = []
    for w0 in range(0, lanes, 32):
        wv, wl, ws = np.inf, np.iinfo(np.int64).max, -1
        for s in range(steps):
            for lane in range(w0, min(w0 + 32, lanes)):
                if mine[lane] and (fits[s, lane] < wv or (
                        fits[s, lane] == wv and lane < wl)):
                    wv, wl, ws = fits[s, lane], lane, s
        kept.append((wv, wl, ws))
    return min(kept, key=lambda v: (v[0], v[1]))


@pytest.mark.parametrize("seed", range(12))
def test_pt_warp_running_best_is_the_per_lane_rule(seed):
    # Few distinct values, so ties across lanes and equal values at
    # different steps are common; a halo of lanes that are not owned (and
    # a warp with none owned) sits on each side.
    g = np.random.default_rng(seed)
    steps, lanes, halo_lanes = 17, 96, [0, 4, 16, 40][seed % 4]
    fits = g.integers(0, 4 if seed % 3 else 2, (steps, lanes)).astype(
        np.float64)
    if seed % 2:
        fits[:, ::7] = np.inf      # lanes stuck at +inf, never better
    mine = np.zeros(lanes, dtype=bool)
    mine[halo_lanes:lanes - halo_lanes] = True
    assert warp_best(fits, mine) == per_lane_best(fits, mine)


@pytest.mark.parametrize("n", [1, 31, 256, 300, 1000, 4096])
@pytest.mark.parametrize("frac", [0.0, 0.4, 0.6, 1.0])
def test_hho_branch_order_is_a_stable_sort_by_class(n, frac):
    # The classes from the plain version's branches on drawn rows: the
    # kernel's order (counts per warp, a prefix, ballot ranks) is a
    # permutation of each block of 256 lanes, stable within each class,
    # and torch.argsort(class, stable=True) of the block.
    g = torch.Generator().manual_seed(n)
    u_e0, u_q, u_r = (torch.rand(n, generator=g) for _ in range(3))
    cls = thf.lane_classes(u_e0, u_q, u_r, torch.tensor(frac))
    explore, dive, _ = thf.branches(u_e0, u_r, torch.tensor(frac))
    assert torch.equal(explore, cls <= thf.BELOW)
    assert torch.equal(dive, cls == thf.DIVE)
    order = thf.branch_order(cls)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    for b0 in range(0, n, thf.SORTED_LANES):
        block = order[b0:b0 + thf.SORTED_LANES]
        assert bool(((block >= b0)
                     & (block < b0 + thf.SORTED_LANES)).all())
        want = b0 + torch.argsort(cls[b0:b0 + thf.SORTED_LANES],
                                  stable=True)
        assert torch.equal(block, want)
        c = cls[block]
        assert bool((c[1:] >= c[:-1]).all())
        same = c[1:] == c[:-1]
        assert bool((block[1:][same] > block[:-1][same]).all())


@pytest.mark.parametrize("klass", range(4))
def test_hho_branch_order_of_one_class_is_the_identity(klass):
    cls = torch.full((1000,), klass)
    assert torch.equal(thf.branch_order(cls), torch.arange(1000))


@pytest.mark.parametrize("dims", [range(1, 112), range(112, 606)])
def test_hho_variants_cover_every_width_to_605(dims):
    for dim in dims:
        geo = thf.hho_geometry(dim)
        assert geo.shared <= MAX_SHARED_BYTES, dim
        if dim <= 111:
            # Blocks of 256 hawks: positions and z columns, the rabbit and
            # the mean, four rows and the warps' counts.
            assert geo == (0, 256, 4 * (2 * dim * 256
                                        + 2 * (-(-dim // 4) * 4)
                                        + 4 * 256 + 16))
        else:
            # The first version: the hawks and the two trial points.
            assert geo.variant == 1
            assert geo.lanes == thf.kernel_block(dim) in (32, 64, 128)
            assert geo.shared == 3 * dim * geo.lanes * 4
            assert thf.trial_tile_geometry(dim) == geo
    assert thf.kernel_block(606) == 0
    assert not thf.hho_pallas_supported("rastrigin", torch.float32, 606)
    # The main path: 3 blocks of 256 hawks (24 warps) an SM at D = 30.
    assert thf.hho_geometry(30) == (0, 256, 65856)
    assert 3 * (65856 + 1024) <= 228 * 1024


@pytest.mark.parametrize("t0", [0, 100, 200, 255])
def test_hho_kept_tally_is_the_diving_lanes_that_keep_x(t0):
    # The bound charges the final clip and evaluation to a diving lane only
    # where it keeps x at a launch's first step (chip_smoke.py:
    # levy_bound_ms): the plain version's tally of those lanes is the
    # diving lanes whose position comes out as their x clipped.  Some x lie
    # outside the domain, and a third of the lanes come with a fitness of
    # -inf, which no y or z beats.
    g = torch.Generator().manual_seed(t0)
    d, n = 5, 512
    pos = torch.rand((d, n), generator=g) * 12.0 - 6.0
    fit = thf.OBJECTIVES_T["rastrigin"](pos)
    fit[:, ::3] = -float("inf")
    draws = thf.host_draws(g, pos.shape, fit.shape, "cpu")
    scalars = torch.tensor([7, 1, t0, 37], dtype=torch.int32)
    counts = {}
    out, _ = thf.fused_hho_step_plain(
        scalars, pos[:, :1].clone(), pos.mean(1, keepdim=True), pos, fit,
        draws, objective_name="rastrigin", t_max=256, tile_n=128,
        rng="host", counts=counts)
    frac = thf.step_fraction(scalars[2], 0, 256)
    _, dive, _ = thf.branches(draws[0], draws[3], frac)
    same = (out == torch.clamp(pos, -5.12, 5.12)).all(0, keepdim=True)
    kept = int(counts["kept"][0])
    assert kept == int((dive & same).sum())
    assert 0 < kept <= int(counts["dive"][0])
