"""The geometry of the redesigned cuckoo (B12) and DE (B10) kernels, which
their wrappers hand to the kernels' entries (``ops/cuda/cuckoo_fused.py:
cuckoo_geometry``, ``ops/cuda/de_fused.py: de_geometry``), against the
lanes the plain versions read.

A cuckoo lane reads its egg from the tile's candidates of the same
generation (``roll_lanes``): every such lane must lie in a block of the
tile's cluster, at the place the kernel looks for it.  A DE lane reads its
three donors from the launch's input: every such lane must lie in the
window its block stages (``donor_window``), at the element the kernel
reads at that step.  Each variant's shared memory must fit a block, and
the variants together must cover cuckoo at any D and DE at D <= 908.  The
geometry is integer bookkeeping: exact.
"""

import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    cuckoo_fused as tcf,
    de_fused as tdf,
    family,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda.pso_fused import (
    MAX_SHARED_BYTES,
)


def read_lanes(tile_n, shift):
    """[tile_n] the lane each lane of a tile reads at ``shift``, as the
    plain versions roll (``family.roll_lanes``)."""
    lanes = torch.arange(tile_n, dtype=torch.float32).reshape(1, 1, tile_n)
    return family.roll_lanes(lanes, torch.tensor(shift))[0].long()


CASES = [(128, 1), (128, 30), (128, 100), (384, 8), (384, 30), (384, 64),
         (4096, 8), (4096, 30)]


@pytest.mark.parametrize("tile_n,dim", CASES)
def test_cuckoo_eggs_lie_in_the_tiles_cluster(tile_n, dim):
    geo = tcf.cuckoo_geometry(dim, tile_n)
    assert geo.variant == 0
    j = torch.arange(tile_n)
    block, lane = j // geo.lanes, j % geo.lanes
    for l_egg in range(tile_n):
        for row in tcf.LANE_SHIFTS:
            egg = read_lanes(tile_n, l_egg + row[0])
            # The owner block of the egg, and the lane there, hold it.
            owner, at = egg // geo.lanes, egg % geo.lanes
            assert bool((owner < geo.cluster).all())
            assert torch.equal(owner * geo.lanes + at, egg)
            assert bool((at < geo.lanes).all())
    # Each lane of the tile is one thread's, in exactly one block.
    assert bool((block < geo.cluster).all())
    assert geo.lanes <= geo.threads <= tcf.CLUSTER_MAX_LANES
    assert geo.threads % 32 == 0
    assert torch.equal(torch.unique(block * geo.lanes + lane), j)


@pytest.mark.parametrize("tile_n,dim", CASES)
def test_de_donors_lie_in_the_staged_windows(tile_n, dim):
    geo = tdf.de_geometry(dim, tile_n)
    assert geo.variant == 0
    j = torch.arange(tile_n)
    block, t = j // geo.lanes, j % geo.lanes
    # The shared memory holds the block's lanes and the three windows.
    windows = [tdf.donor_window(geo.lanes, tile_n, 0, 0, k)[1]
               for k in range(3)]
    assert geo.shared >= 4 * dim * (geo.lanes + sum(windows))
    for k in range(3):
        # The element lane t reads at each schedule row lies in the window.
        at = [t + tdf.SHIFT_MAX[k] - row[k] for row in tdf.LANE_SHIFTS]
        assert all(bool((a >= 0).all()) and bool((a < windows[k]).all())
                   for a in at)
        for lshift in range(tile_n):
            staged = [tdf.donor_window(geo.lanes, tile_n, j0, lshift, k)
                      for j0 in range(0, tile_n, geo.lanes)]
            assert {length for _, length in staged} == {windows[k]}
            first = torch.tensor([start for start, _ in staged])[block]
            for row, a in zip(tdf.LANE_SHIFTS, at):
                donor = read_lanes(tile_n, lshift + row[k])
                assert torch.equal((first + a) % tile_n, donor)


def _tiles(dim):
    """The tiles a run takes at this D (the JAX package's lane tiling of a
    large swarm) and explicit ones."""
    auto, _ = family.lane_tiling(1 << 20, None, dim)
    return sorted({auto, 96, 128, 160, 1000, 4096, 8192, 16384})


@pytest.mark.parametrize("dims", [range(1, 200), range(200, 2600, 7),
                                  range(2600, 6000, 97)])
def test_cuckoo_variants_cover_any_width_within_a_block(dims):
    for dim in dims:
        for tile_n in _tiles(dim):
            geo = tcf.cuckoo_geometry(dim, tile_n)
            assert geo.shared <= MAX_SHARED_BYTES, (dim, tile_n)
            if geo.variant == 0:
                assert geo.cluster in tcf.CLUSTER_SIZES
                assert geo.cluster * geo.lanes >= tile_n
                assert (geo.cluster - 1) * geo.lanes < tile_n
                # Positions and a generation's candidates on chip.
                assert geo.shared >= 4 * 2 * dim * geo.lanes
            else:
                # One block a tile, through global scratch.
                assert (geo.cluster, geo.lanes, geo.shared) == (1, tile_n, 0)
                assert 32 <= geo.threads <= 512 and geo.threads % 32 == 0
    # The main path's tile stays on chip across a cluster of 16.
    assert tcf.cuckoo_geometry(30, 4096)[:3] == (0, 16, 256)


@pytest.mark.parametrize("dims", [range(1, 180), range(180, 909)])
def test_de_variants_cover_every_width_to_908(dims):
    for dim in dims:
        for tile_n in _tiles(dim):
            geo = tdf.de_geometry(dim, tile_n)
            assert geo.shared <= MAX_SHARED_BYTES, (dim, tile_n)
            if geo.variant == 0:
                assert geo.lanes % 32 == 0
                assert 32 <= geo.lanes <= tdf.STAGED_MAX_LANES
                assert geo.lanes <= tile_n + 31
            else:
                assert dim >= 180
                assert geo.lanes == tdf.kernel_block(dim) > 0
                assert geo.shared == 2 * dim * geo.lanes * 4
    with pytest.raises(ValueError, match="908"):
        tdf.de_geometry(909, 128)
    # The main path's block holds the most warps an SM takes.
    assert tdf.de_geometry(30, 4096).variant == 0
