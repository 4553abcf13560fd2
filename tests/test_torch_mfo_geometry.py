"""Kernel B16's redesign on the CPU (``ops/cuda/mfo_fused.py``): the plain
version's tallies of what the kernel needs (the moths at the fixed point at
a launch's start, the moths still moving at each step, the steps each moth
takes) against a direct count, the order in which a block regroups its
moving moths, and the geometry's shared memory over the envelope.

This file imports no JAX.  The tallies are integers and the order a
permutation: every check is exact.
"""

import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops.cuda import family
from distributed_swarm_algorithm_tpu_torch.ops.cuda import mfo_fused as tmf

NAME, HW = "rastrigin", 5.12


def launch_inputs(n, d, n_flames, seed, fixed_share=0.5):
    """One launch's operands with about ``fixed_share`` of the moths equal
    to their flames: a flame component of -0 beside a moth's +0, a moth
    equal to a flame outside the domain, moths past ``n_flames`` equal to
    theirs."""
    g = np.random.default_rng(seed)
    pos = g.uniform(-HW, HW, (d, n)).astype(np.float32)
    flames = g.uniform(-HW, HW, (d, n)).astype(np.float32)
    same = np.nonzero(g.uniform(size=n) < fixed_share)[0]
    pos[:, same] = flames[:, same]
    flames[0, same[0]], pos[0, same[0]] = -0.0, 0.0
    flames[1, same[1]] = pos[1, same[1]] = 2 * HW
    pos, flames = torch.from_numpy(pos), torch.from_numpy(flames)
    ffit = tmf.OBJECTIVES_T[NAME](flames)
    ffit[0, ::9] = float("inf")
    scalars = torch.tensor([seed, n_flames, -70000], dtype=torch.int32)
    last = flames[:, n_flames - 1:n_flames].contiguous()
    return [scalars, last, pos, flames, ffit], same


@pytest.mark.parametrize("n,d,n_flames,k", [
    (512, 6, 300, 8), (384, 5, 384, 4), (256, 3, 1, 1), (640, 30, 500, 8)])
def test_counts_equal_a_direct_count(n, d, n_flames, k):
    args, same = launch_inputs(n, d, n_flames, seed=n + k)
    kw = dict(objective_name=NAME, half_width=HW, tile_n=128, step0=11)
    counts = {}
    want = tmf.fused_mfo_step_plain(*args, k_steps=k, **kw, counts=counts)
    scalars, last, pos, flames, ffit = args
    # The fixed point by its definition, moth by moth.
    p, f = pos.numpy(), flames.numpy()
    own = np.arange(n) < n_flames
    fixed = np.array([own[j] and all(p[i, j] == f[i, j] and abs(f[i, j])
                                     <= HW for i in range(d))
                      for j in range(n)])
    assert fixed.sum() > 0 and not fixed[same[1]]
    assert int(counts["stopped_at_start"][0]) == int(fixed.sum())
    # The steps one at a time: an own moth stops after the step that
    # improves its flame.
    moving, steps = ~fixed, np.zeros(n, dtype=np.int64)
    x, fl, ff = pos, flames, ffit
    for s in range(k):
        assert int(counts["moving"][s]) == int(moving.sum()), s
        steps += moving
        x, fit, fl, ff_next = tmf.fused_mfo_step_plain(
            scalars, last, x, fl, ff, **dict(kw, step0=11 + s))
        better = (ff_next < ff).numpy()[0]
        moving = moving & ~(better & own)
        ff = ff_next
    np.testing.assert_array_equal(counts["lane_steps"][0].numpy(), steps)
    assert len(counts["moving"]) == k and len(counts["lane_steps"]) == 1
    # k steps one at a time are the launch of k steps.
    for a, b in zip((x, fit, fl, ff), want):
        assert torch.equal(a, b)


def test_no_moth_stops_where_the_fixed_point_may_fail():
    # An infinite domain or a spiral exponent that can overflow: every moth
    # takes every step.
    args, _ = launch_inputs(256, 4, 200, seed=3)
    for hw, b in ((float("inf"), 1.0), (HW, 1e31), (float("nan"), 1.0)):
        counts = {}
        tmf.fused_mfo_step_plain(*args, objective_name=NAME, half_width=hw,
                                 b=b, tile_n=128, k_steps=3, counts=counts)
        assert int(counts["stopped_at_start"][0]) == 0
        assert [int(c) for c in counts["moving"]] == [256] * 3
    assert tmf.can_stop(HW, -1e30) and not tmf.can_stop(-float("inf"), 1.0)


@pytest.mark.parametrize("n", [128, 300, 77, 1024])
def test_regrouped_order_keeps_every_lane_exactly_once(n):
    g = torch.Generator().manual_seed(n)
    for share in (0.0, 0.1, 0.5, 1.0):
        moving = torch.rand(n, generator=g) < share
        order = family.branch_order(torch.where(moving, 0, 1),
                                    tmf.SORTED_LANES)
        assert sorted(order.tolist()) == list(range(n))
        for b0 in range(0, n, tmf.SORTED_LANES):
            block = order[b0:b0 + tmf.SORTED_LANES]
            lanes = torch.arange(b0, b0 + block.numel())
            # The moving moths first, then the others, each in lane order.
            want = torch.cat([lanes[moving[lanes]], lanes[~moving[lanes]]])
            assert torch.equal(block, want), (n, share, b0)


def test_tiles_fit_shared_memory_over_the_envelope():
    for d in range(1, 909):
        geo = tmf.mfo_geometry(d)
        assert 0 < geo.shared <= family.MAX_SHARED_BYTES, d
        if d <= 225:
            assert geo == (0, 128, tmf.sorted_bytes(d)), d
        else:
            assert geo == tmf.lane_geometry(d), d
            assert geo.variant == 1 and geo.lanes == tmf.kernel_block(d) > 0
            assert geo.shared == 2 * d * geo.lanes * 4
    assert tmf.sorted_bytes(225) <= family.MAX_SHARED_BYTES
    assert tmf.sorted_bytes(226) > family.MAX_SHARED_BYTES
    # 7 blocks of 128 moths an SM at the main path's D = 30 (228 KB an SM,
    # 1 KB of it reserved a block).
    assert 7 * (tmf.sorted_bytes(30) + 1024) <= 228 * 1024
    assert tmf.kernel_block(908) == 32 and tmf.kernel_block(909) == 0
