"""The geometry of the redesigned bat (B7) and ABC (B17) kernels, which
their wrappers hand to the kernels' entries (``ops/cuda/bat_fused.py:
bat_geometry``, ``ops/cuda/abc_fused.py: abc_geometry``), against the
lanes the plain versions read.

An ABC lane's employed bee reads its partner from the tile's current
sources (``roll_lanes``): every such lane must lie in a block of the tile's
cluster, at the place the kernel looks for it, for every lane shift the
launch may draw.  Each variant's shared memory must fit a block, and the
variants together must cover every D the first versions took (bat D <=
605, ABC any D).  The geometry is integer bookkeeping: exact.
"""

import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    abc_fused as taf,
    bat_fused as tbf,
    family,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda.pso_fused import (
    MAX_SHARED_BYTES,
)


def read_lanes(tile_n, shift):
    """[tile_n] the lane each lane of a tile reads at ``shift``, as the
    plain version rolls (``family.roll_lanes``)."""
    lanes = torch.arange(tile_n, dtype=torch.float32).reshape(1, 1, tile_n)
    return family.roll_lanes(lanes, torch.tensor(shift))[0].long()


def kernel_partner(jl, tile_n, dl, shift):
    """The lane the cluster kernel reads for lane ``jl``: ``jl - (dl mod
    tile_n + shift) mod tile_n``, wrapped into the tile."""
    e = jl - (dl % tile_n + shift) % tile_n
    return torch.where(e < 0, e + tile_n, e)


@pytest.mark.parametrize("tile_n,dim", [(128, 30), (384, 30), (1000, 33),
                                        (4096, 30)])
def test_abc_partners_lie_in_the_tiles_cluster(tile_n, dim):
    geo = taf.abc_geometry(dim, tile_n)
    assert geo.variant == 0
    jl = torch.arange(tile_n)
    rank, t = jl // geo.lanes, jl % geo.lanes
    # Each lane of the tile is one thread's, in exactly one block.
    assert bool((rank < geo.cluster).all())
    assert geo.lanes <= geo.threads <= family.CLUSTER_MAX_LANES
    assert geo.threads % 32 == 0
    assert torch.equal(torch.unique(rank * geo.lanes + t), jl)
    for dl in range(-tile_n, 2 * tile_n, 1 if tile_n < 4096 else 3):
        for la, lb, _ in family.LANE_SHIFTS:
            # The employed partner, from the current sources in the cluster.
            want = read_lanes(tile_n, dl + la)
            got = kernel_partner(jl, tile_n, dl, la)
            assert torch.equal(got, want), (dl, la)
            owner, at = got // geo.lanes, got % geo.lanes
            assert bool((owner < geo.cluster).all())
            assert torch.equal(owner * geo.lanes + at, want)
            # The onlooker partner, from the launch's input tile.
            assert torch.equal(kernel_partner(jl, tile_n, dl, lb),
                               read_lanes(tile_n, dl + lb)), (dl, lb)


def _tiles(dim):
    """The tiles a run takes at this D (the JAX package's lane tiling of a
    large swarm) and explicit ones."""
    auto, _ = family.lane_tiling(1 << 20, None, dim)
    return sorted({auto, 96, 100, 128, 1000, 4096, 8192, 16384})


@pytest.mark.parametrize("dims", [range(1, 300), range(300, 2600, 7),
                                  range(2600, 8000, 97)])
def test_abc_variants_cover_any_width_within_a_block(dims):
    for dim in dims:
        for tile_n in _tiles(dim):
            geo = taf.abc_geometry(dim, tile_n)
            assert geo.shared <= MAX_SHARED_BYTES, (dim, tile_n)
            if geo.variant == 0:
                assert geo.cluster in family.CLUSTER_SIZES
                # A block's share: the last block may hold fewer lanes, or
                # none (16 blocks of 7 lanes for a tile of 100), and then
                # only takes part in the barriers.
                assert geo.lanes == -(-tile_n // geo.cluster)
                assert geo.lanes <= family.CLUSTER_MAX_LANES
                # The block's sources on chip, and its reduction slots.
                assert geo.shared == 4 * (dim * geo.lanes + 16 + 1)
            else:
                # One block a tile, through global scratch.
                assert (geo.cluster, geo.lanes, geo.shared) == (1, tile_n, 0)
                assert 32 <= geo.threads <= 512 and geo.threads % 32 == 0
    # The main path's tile stays on chip across a cluster of 16 blocks of
    # 256 lanes up to D = 226; past it, and past a tile of 8,192, the tile
    # goes through global scratch.
    assert taf.abc_geometry(30, 4096)[:3] == (0, 16, 256)
    assert taf.abc_geometry(226, 4096).variant == 0
    assert taf.abc_geometry(227, 4096).variant == 1
    assert taf.abc_geometry(30, 8192)[:3] == (0, 16, 512)
    assert taf.abc_geometry(30, 16384).variant == 1


@pytest.mark.parametrize("dims", [range(1, 227), range(227, 606)])
def test_bat_variants_cover_every_width_to_605(dims):
    for dim in dims:
        geo = tbf.bat_geometry(dim)
        assert geo.shared <= MAX_SHARED_BYTES, dim
        if dim <= 226:
            # Blocks of 128 bats: the best column, pos and vel.
            assert geo == (0, 128, 4 * (2 * dim * 128 + -(-dim // 4) * 4))
        else:
            # The first version: pos, vel and the candidate.
            assert geo.variant == 1
            assert geo.lanes == tbf.kernel_block(dim) in (32, 64)
            assert geo.shared == 3 * dim * geo.lanes * 4
            assert tbf.candidate_tile_geometry(dim) == geo
    # Past the first version's envelope no variant runs, and the support
    # check says so before any launch.
    assert tbf.kernel_block(606) == 0
    assert not tbf.bat_pallas_supported("rastrigin", torch.float32, 606)
    # The main path: 7 blocks of 128 bats an SM at D = 30 (31 KB each).
    assert tbf.bat_geometry(30) == (0, 128, 30848)
    assert 7 * (30848 + 1024) <= 228 * 1024
