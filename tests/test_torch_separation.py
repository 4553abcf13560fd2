"""The port's all-pairs separation against the JAX package's Pallas kernel.

The same numpy inputs go through ``separation_pallas`` (run in interpret
mode on the CPU, as the JAX package's own tests run it) and through the
port's plain version, which is what the port runs on a CPU tensor.  The
cases mirror tests/test_pallas_separation.py.

Tolerance: rtol=1e-4, atol=1e-4, the JAX package's own band for this
kernel.  Both sides compute the same formula in f32, but sum the pairs in
another order (the Pallas kernel per 128-wide tile, PyTorch over the whole
row), and close pairs reach forces of 1e4 and more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_swarm_algorithm_tpu.ops.pallas.separation import (
    separation_pallas,
)
from distributed_swarm_algorithm_tpu_torch.ops.cuda import (
    separation as port_sep,
)

K_SEP, R, EPS = 20.0, 2.0, 1e-3
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_swarm(n, d, seed, co_locate=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5, 5, (n, d)).astype(np.float32)
    if co_locate:
        pos[1] = pos[0]
        pos[2] = pos[0]
    alive = rng.random(n) > 0.2
    alive[0] = True
    return pos, alive


def _both(pos, alive):
    want = separation_pallas(
        jnp.asarray(pos), jnp.asarray(alive), K_SEP, R, EPS,
        tile_i=64, tile_j=128, interpret=True,
    )
    got = port_sep.separation(
        torch.from_numpy(pos), torch.from_numpy(alive), K_SEP, R, EPS
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize(
    "n,d,seed,co_locate",
    [
        (256, 2, 0, False),   # 2-D
        (192, 3, 1, False),   # 3-D
        (300, 2, 2, False),   # n not a multiple of any tile
        (20, 2, 5, False),    # tiny n
        (128, 2, 3, True),    # three co-located agents
    ],
    ids=["2d", "3d", "unaligned", "tiny", "colocated"],
)
def test_plain_matches_pallas(n, d, seed, co_locate):
    pos, alive = _random_swarm(n, d, seed, co_locate)
    want, got = _both(pos, alive)
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got, want, **TOL)


def test_colocated_agents_finite_and_equal():
    pos, alive = _random_swarm(128, 2, 3, co_locate=True)
    alive[:3] = True
    want, got = _both(pos, alive)
    assert np.isfinite(got).all()
    # The trio feels the same outside neighbors and nothing from itself.
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[2], got[0])
    np.testing.assert_allclose(got[:3], want[:3], **TOL)


def test_dead_agents_feel_and_exert_nothing():
    pos, alive = _random_swarm(64, 2, 4)
    want, got = _both(pos, alive)
    np.testing.assert_array_equal(got[~alive], 0.0)
    # Exerting nothing: moving the dead agents does not change the rest.
    moved = pos.copy()
    moved[~alive] = pos[alive][: int((~alive).sum())]
    _, got_moved = _both(moved, alive)
    np.testing.assert_array_equal(got_moved[alive], got[alive])
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_chunks_agree_with_one_chunk(monkeypatch):
    # The chunking over receiver rows that lets the plain version run at
    # N = 65,536 on the card changes no result.
    pos, alive = _random_swarm(300, 2, 6)
    whole = port_sep.separation_plain(
        torch.from_numpy(pos), torch.from_numpy(alive), K_SEP, R, EPS
    )
    monkeypatch.setattr(port_sep, "_PLAIN_PAIRS_PER_CHUNK", 300 * 7)
    chunked = port_sep.separation_plain(
        torch.from_numpy(pos), torch.from_numpy(alive), K_SEP, R, EPS
    )
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
