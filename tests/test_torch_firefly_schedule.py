"""The firefly kernel's schedule (``ops/cuda/firefly_fused.py``), on the CPU.

The kernel sorts rows and sources by fitness and gives each block of sorted
rows the number of source tiles it visits (:func:`block_tiles`); it skips
the rest, so the count must cover every brighter pair, including NaN,
+-inf, -0 against +0 and ties that straddle a tile boundary.  These tests
hold the wrapper's helpers against a brute-force count of the brighter
pairs at small N, and the split plan against the card's width.
"""

import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops.cuda import firefly_fused as ff


def _fitness(n, kind, seed):
    g = np.random.default_rng(seed)
    if kind == "random":
        f = g.standard_normal(n)
    elif kind == "sorted":
        f = np.sort(g.standard_normal(n))
    elif kind == "reverse":
        f = -np.sort(g.standard_normal(n))
    elif kind == "equal":
        f = np.full(n, 2.0)
    elif kind == "ties":           # runs of 50 equal values across tiles
        f = np.floor(g.permutation(n) / 50.0)
    elif kind == "nan-inf":
        f = g.standard_normal(n)
        f[g.random(n) < 0.1] = np.nan
        f[g.random(n) < 0.05] = np.inf
        f[g.random(n) < 0.05] = -np.inf
    else:                          # signed zeros among a few values
        f = g.choice([-0.0, 0.0, -1.0, 1.0], n)
    return torch.from_numpy(f.astype(np.float32))


def _brute_tiles(fit_rows, fit_src, rows):
    """Tiles of each row block by counting: one past the last sorted source
    brighter than some row of the block, in tiles."""
    out = []
    brighter = (fit_src.double()[None, :] < fit_rows.double()[:, None])
    for s in range(0, fit_rows.shape[0], rows):
        hit = brighter[s:s + rows].any(0).nonzero().flatten()
        last = int(hit.max()) + 1 if hit.numel() else 0
        out.append(-(-last // ff.TILE_J))
    return out


KINDS = ["random", "sorted", "reverse", "equal", "ties", "nan-inf", "zeros"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,nj,dim", [(1, None, 30), (63, None, 5),
                                      (300, None, 30), (1000, None, 40),
                                      (257, None, 100), (300, 1000, 30),
                                      (129, 64, 70)])
def test_block_tiles_cover_every_brighter_pair(kind, n, nj, dim):
    fit = _fitness(n, kind, n)
    fit_j = None if nj is None else _fitness(nj, kind, nj + 1)
    order_i, order_j, tiles = ff.attraction_schedule(fit, fit_j, dim)
    src = fit if fit_j is None else fit_j
    rows = ff.rows_per_block(dim)
    assert tiles.dtype == torch.int32
    assert tiles.shape == (-(-n // rows),)
    if fit_j is None:
        assert order_j is order_i
    for order, f in ((order_i, fit), (order_j, src)):
        assert sorted(order.tolist()) == list(range(f.shape[0]))
        key = torch.where(torch.isnan(f[order]), torch.inf, f[order])
        assert bool((key[1:] >= key[:-1]).all())
    want = _brute_tiles(fit[order_i], src[order_j], rows)
    assert tiles.tolist() == want


def test_rows_per_block_and_workspace():
    assert [ff.rows_per_block(d) for d in (0, 1, 30, 32, 33, 64, 65, 128,
                                           129)] == [0, 64, 64, 64, 32, 32,
                                                     16, 16, 0]
    # Square: 64 padded rows of 32 floats, norm and fitness, then 2 splits
    # of 32 partial sums and a weight sum.
    assert ff.workspace_floats(60, 60, 30, 2, True) == 64 * 34 + 2 * 64 * 33
    assert ff.workspace_floats(60, 130, 40, 1, False) == (
        64 * 66 + 192 * 66 + 64 * 65)


@pytest.mark.parametrize("n,splits", [(65_536, 2), (16_384, 5), (1, 1),
                                      (1000, 16)])
def test_split_plan_fills_the_card(n, splits):
    # 132 SMs, as on the H100: at 16,384 rows the row blocks alone (256)
    # would underfill the card; the split leaves at least 2 x 132 blocks of
    # work on a square call's triangle.
    got, chunk = ff.split_plan(n, n, 30, 132)
    tiles_max = -(-n // ff.TILE_J)
    assert got == splits and got * chunk >= tiles_max
    assert (got - 1) * chunk < tiles_max
    if n == 16_384:
        fit = _fitness(n, "random", 0)
        _, _, tiles = ff.attraction_schedule(fit, None, 30)
        work = int((-(-tiles.long() // chunk)).sum())
        assert work >= 2 * 132
