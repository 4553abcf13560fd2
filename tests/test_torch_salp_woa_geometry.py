"""The geometry of the redesigned salp (B9) and whale (B11) kernels, which
their wrappers hand to the kernels' entries (``ops/cuda/salp_fused.py:
salp_geometry``, ``ops/cuda/woa_fused.py: woa_geometry``), and the rules
the kernels follow in place of their first versions': the salp block keeps
each lane's best fitness and step only and rebuilds its winner by replaying
the chain from the launch's input (``salp_fused.winner_replay`` is that
replay in PyTorch); the whale block regroups its lanes by branch
(``woa_fused.branch_order``) and only contracting whales draw A and C (the
plain version's ``counts`` tally, which the bound reads).

Each variant's shared memory must fit a block, and together they must cover
every D the first versions took (salp D <= 452, whale D <= 1816).  The
replay, the orders and the tallies: exact.  No JAX here.
"""

import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    salp_fused as tsf,
    woa_fused as twf,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda.pso_fused import (
    MAX_SHARED_BYTES,
    OBJECTIVES_T,
    philox_uniforms,
)

TILES = [128, 256, 384, 512, 1024, 4096, 8192]


# --------------------------------------------------------------------------
# Salp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tile_n", TILES)
def test_salp_geometry_fits_and_covers_every_width_to_452(tile_n):
    for dim in range(1, 453):
        geo = tsf.salp_geometry(dim, tile_n)
        assert geo is not None, (dim, tile_n)
        assert geo.lanes in tsf.SALP_LANES and tile_n % geo.lanes == 0
        assert geo.shared == tsf.chain_bytes(dim, geo.lanes)
        assert geo.shared <= MAX_SHARED_BYTES
        # The most lanes that fit: twice as many would not.
        wider = 2 * geo.lanes
        assert (wider > tsf.SALP_LANES[0] or tile_n % wider
                or tsf.chain_bytes(dim, wider) > MAX_SHARED_BYTES)
    assert tsf.salp_geometry(453, tile_n) is None
    assert tsf.salp_geometry(0, tile_n) is None


def test_salp_geometry_at_the_main_path():
    # 1,048,576 x 30 in tiles of 4,096: blocks owning 512 lanes, 528
    # threads (17 warps), the window's columns, the published columns (rows
    # of 32) and the reduction in 68,096 bytes.
    geo = tsf.salp_geometry(30, 4096)
    assert geo == tsf.SalpGeometry(512, 4 * (30 * 528 + 2 * 17 * 32 + 96))
    assert tsf.kernel_block(30) == 512 and tsf.kernel_block(452) == 64
    assert tsf.kernel_block(453) == 0


def _chain_states(scalars, food, pos, fit, r2, r3, name, hw, t_max, tile_n,
                  k, step0):
    """Positions [k + 1, D, N] and fitness [k + 1, N] after 0 .. k steps of
    one launch, each from the plain version (a launch of s steps)."""
    states, fits = [pos], [fit[0]]
    for s in range(1, k + 1):
        p, f, _, _ = tsf.salp_steps_plain(scalars, food, pos, fit, r2, r3,
                                          name, hw, t_max, tile_n, s, step0)
        states.append(p)
        fits.append(f[0])
    return torch.stack(states), torch.stack(fits)


@pytest.mark.parametrize("rng", ["device", "host"])
@pytest.mark.parametrize("k", range(1, 17))
def test_salp_winner_replay_reproduces_the_chain(rng, k):
    # Three tiles of 128 lanes: every lane's running best (the first least
    # of its input fitness and its k steps' fitness, as the plain version
    # keeps it) replayed from the launch's input over its window, tile lane
    # 0 through the link, global lane 0 through the leader's draws.
    g = np.random.default_rng(100 * k + (rng == "host"))
    d, n, tile_n, hw = 3, 384, 128, 5.12
    pos = torch.from_numpy(g.uniform(-hw, hw, (d, n)).astype(np.float32))
    fit = OBJECTIVES_T["rastrigin"](pos)
    food = pos[:, 200:201].contiguous()
    scalars = torch.tensor([int(g.integers(0, 2**31)), int(g.integers(0, 50))],
                           dtype=torch.int32)
    r2 = r3 = None
    if rng == "host":
        r2, r3 = (torch.from_numpy(g.uniform(size=(d, 1)).astype(np.float32))
                  for _ in range(2))
    step0 = int(g.integers(0, 2**32))
    states, fits = _chain_states(scalars, food, pos, fit, r2, r3,
                                 "rastrigin", hw, 60, tile_n, k, step0)
    steps = torch.argmin(fits, dim=0)          # the first least, per lane
    for lane in range(n):
        b = int(steps[lane])
        got = tsf.winner_replay(scalars, food, pos, r2, r3, hw, 60, tile_n,
                                step0, lane, b)
        assert torch.equal(got, states[b, :, lane]), (lane, b)
    # And the plain version's launch best is the first least lane's.
    _, _, best_fit, best_pos = tsf.salp_steps_plain(
        scalars, food, pos, fit, r2, r3, "rastrigin", hw, 60, tile_n, k,
        step0)
    win = int(torch.argmin(fits.min(dim=0).values))
    assert float(best_fit) == float(fits[steps[win], win])
    assert torch.equal(best_pos[:, 0], states[steps[win], :, win])


def winner_case(kind: str, device="cpu"):
    """One salp launch (positional args, keywords) on sphere whose winner
    sits at a chosen lane and step: ``(args, kw, lane, step)``.  Four tiles
    of 2,048 lanes (blocks of 512), D = 4, k = 16, device draws, every
    position -v0 (v0 = 2^-14, so every mean is exact) and every input
    fitness 1e30 unless the case says otherwise:

    - ``step0``: lane 2,560 (a block's first lane) with input fitness -1;
    - ``step1``: lane 2,560 at +v0, which reaches 0 after one step;
    - ``stepk``: lane 2,560 at (2^16 - 1) v0, which falls to 0 only at
      step 16, its window reaching into the previous block's lanes;
    - ``link``: the same at lane 2,048, a tile's lane 0, through the link;
    - ``leader``: global lane 0, the food at 0 and t_max = 1, so the
      leader's move vanishes (c1 underflows) from its second step on."""
    d, n, tile_n, k = 4, 8192, 2048, 16
    v0 = 2.0 ** -14
    pos = torch.full((d, n), -v0)
    fit = torch.full((1, n), 1e30)
    food = torch.full((d, 1), -v0)
    it0, t_max = 3, 60
    lane, step = {"step0": (2560, 0), "step1": (2560, 1),
                  "stepk": (2560, k), "link": (2048, k),
                  "leader": (0, 2)}[kind]
    if kind == "step0":
        pos[:, lane] = 0.5
        fit[0, lane] = -1.0
    elif kind == "step1":
        pos[:, lane] = v0
    elif kind in ("stepk", "link"):
        pos[:, lane] = (2 ** k - 1) * v0
    else:
        food.zero_()
        it0, t_max = 0, 1
    args = [torch.tensor([2025, it0], dtype=torch.int32, device=device),
            food.to(device), pos.to(device), fit.to(device)]
    kw = dict(objective_name="sphere", half_width=5.12, t_max=t_max,
              tile_n=tile_n, rng="device", k_steps=k, step0=77)
    return args, kw, lane, step


@pytest.mark.parametrize("kind", ["step0", "step1", "stepk", "link",
                                  "leader"])
def test_salp_winner_cases_put_the_winner_where_they_say(kind):
    args, kw, lane, step = winner_case(kind)
    scalars, food, pos, fit = args
    states, fits = _chain_states(scalars, food, pos, fit, None, None,
                                 "sphere", kw["half_width"], kw["t_max"],
                                 kw["tile_n"], kw["k_steps"], kw["step0"])
    best = fits.min(dim=0).values
    win = int(torch.argmin(best))
    assert (win, int(torch.argmin(fits[:, win]))) == (lane, step)
    assert tsf.salp_geometry(4, kw["tile_n"]).lanes == 512
    want = tsf.fused_salp_step_plain(*args, **kw)
    assert torch.equal(want[3][:, 0], states[step, :, lane])
    assert torch.equal(want[3][:, 0], tsf.winner_replay(
        scalars, food, pos, None, None, kw["half_width"], kw["t_max"],
        kw["tile_n"], kw["step0"], lane, step))


# --------------------------------------------------------------------------
# Whale
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [range(1, 225), range(225, 1817)])
def test_woa_variants_cover_every_width_to_1816(dims):
    for dim in dims:
        geo = twf.woa_geometry(dim)
        assert geo.shared <= MAX_SHARED_BYTES, dim
        if dim <= 224:
            assert geo == twf.WoaGeometry(0, 256, twf.sorted_bytes(dim))
        else:
            assert geo == twf.lane_geometry(dim)
            assert geo.variant == 1 and geo.lanes == twf.kernel_block(dim)
            assert geo.shared == dim * geo.lanes * 4
    assert twf.sorted_bytes(225) > MAX_SHARED_BYTES
    assert twf.kernel_block(1817) == 0


@pytest.mark.parametrize("n", [1, 31, 256, 300, 1000, 4096])
@pytest.mark.parametrize("share", [0.0, 0.3, 0.5, 1.0])
def test_woa_branch_order_is_a_stable_sort_by_class(n, share):
    # The classes from drawn rows: the kernel's order (counts per warp, a
    # prefix, ballot ranks) is a permutation of each block of 256 lanes,
    # stable within each class: torch.argsort(class, stable=True) of the
    # block, the contracting lanes first.
    g = torch.Generator().manual_seed(n)
    u_p = torch.rand(n, generator=g) * (0.5 / max(share, 1e-9)) \
        if share else 0.5 + 0.5 * torch.rand(n, generator=g)
    cls = twf.lane_classes(u_p)
    assert torch.equal(cls == twf.CONTRACT, u_p < 0.5)
    order = twf.branch_order(cls)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    for b0 in range(0, n, twf.SORTED_LANES):
        block = order[b0:b0 + twf.SORTED_LANES]
        want = b0 + torch.argsort(cls[b0:b0 + twf.SORTED_LANES],
                                  stable=True)
        assert torch.equal(block, want)
        c = cls[block]
        assert bool((c[1:] >= c[:-1]).all())


@pytest.mark.parametrize("klass", [0, 1])
def test_woa_branch_order_of_one_class_is_the_identity(klass):
    cls = torch.full((1000,), klass)
    assert torch.equal(twf.branch_order(cls), torch.arange(1000))


@pytest.mark.parametrize("rng,k,t0", [("device", 8, 3), ("device", 3, 700),
                                      ("host", 1, 0)])
def test_woa_contract_tally_counts_the_contracting_elements(rng, k, t0):
    # counts["contract"] holds each step's lanes with u_p < 1/2 times D,
    # from the step's own draws, and leaves the launch's results unchanged.
    g = np.random.default_rng(k + t0)
    d, n, tile_n, hw = 5, 512, 128, 5.12
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32))
    pos = to(g.uniform(-hw, hw, (d, n)))
    best = pos[:, 9:10].contiguous()
    scalars = torch.tensor([31, 2, t0, 77], dtype=torch.int32)
    draws = (to(g.uniform(size=(d, n))), to(g.uniform(size=(d, n))),
             to(g.uniform(size=(1, n))), to(g.uniform(size=(1, n))))
    kw = dict(objective_name="rastrigin", half_width=hw, t_max=500,
              tile_n=tile_n, rng=rng, k_steps=k, step0=2**32 - 2)
    host = draws if rng == "host" else (None,) * 4
    counts = {}
    got = twf.fused_woa_step_plain(scalars, best, pos, *host, **kw,
                                   counts=counts)
    want = twf.fused_woa_step_plain(scalars, best, pos, *host, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if rng == "host":
        u_p = [draws[2]]
    else:
        u_p = [philox_uniforms(scalars[0:1], n, 4, kw["step0"] + s, 2)[0:1]
               for s in range(k)]
    assert [int(c) for c in counts["contract"]] == [
        int((u < 0.5).sum()) * d for u in u_p]
    assert 0 < sum(int(c) for c in counts["contract"]) < k * n * d
