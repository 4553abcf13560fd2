"""The auction's bidding loop: kernel N2 and its plain version.

The JAX package runs Bertsekas' forward auction on the padded square as a
``lax.while_loop`` of Jacobi bidding rounds (``ops/auction.py:
_auction_square``, the loop at ``:148`` around ``_auction_round``), whose
trip count only the device knows.  No ``pallas_call`` lies on it; this
module is its counterpart on the card:

- :func:`auction_square_cuda` launches ``csrc/auction.cu`` (one block runs
  every round, the per-task state in shared memory) on CUDA tensors and
  raises on anything else: a solve reads nothing back, and a launch whose
  device flag ``run`` is false runs zero rounds, so the swarm's tick
  launches it every tick and decides on the device whether to re-solve;
- :func:`auction_square_plain` is the JAX loop in plain PyTorch, one
  :func:`auction_round` a round, its flag read on the host each round;
- :func:`auction_round` is JAX's round.

Both return the same four tensors exactly, prices included: the round has
only additions, subtractions and maxima.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, family

I32 = torch.int32
_BIG_ID = torch.iinfo(torch.int32).max

# Launches of the CUDA kernel since the count was last set to 0.  Only
# auction_square_cuda adds to it, once per launch; a launch while the
# stream captures a CUDA graph adds to _captured instead, and each replay
# of a captured rollout adds what its capture recorded.
LAUNCHES = 0
_captured = 0

_fns = None   # the C entries, bound at the first launch

Square = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _lib():
    global _fns
    if _fns is None:
        lib = _build.load("auction")
        fn = lib.dsa_auction_f32
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        state = lib.dsa_auction_state_bytes
        state.argtypes = [ctypes.c_int]
        state.restype = ctypes.c_longlong
        shared = lib.dsa_auction_state_in_shared
        shared.argtypes = [ctypes.c_int]
        shared.restype = ctypes.c_int
        _fns = (fn, state, shared)
    return _fns


def auction_round(values: torch.Tensor, eps: torch.Tensor,
                  agent_task: torch.Tensor, task_agent: torch.Tensor,
                  prices: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One Jacobi round on the square ``values`` [S, S]: every unseated
    agent bids its best-minus-second-best margin plus ``eps`` for its best
    task; each task with bids takes the highest (ties to the lowest agent
    id), evicting its previous owner.  Returns ``(agent_task, task_agent,
    prices)``."""
    s = values.shape[0]
    dev = values.device
    idx = torch.arange(s, dtype=I32, device=dev)     # agent ids, task ids
    neg = float("-inf")

    v = values - prices[None, :]                        # [S, S] net values
    w1 = v.amax(1)                                      # best value
    j1 = torch.argmax(v, 1)                             # its lowest index
    w2 = v.scatter(1, j1[:, None], neg).amax(1)         # second best
    w2 = torch.where(torch.isfinite(w2), w2, w1)        # S == 1: no margin

    bidding = agent_task < 0
    bid = (prices[j1] + (w1 - w2)) + eps
    bid_v = torch.where(bidding, bid, neg)
    best_bid = torch.full_like(prices, neg).scatter_reduce(0, j1, bid_v,
                                                           "amax")
    has_bid = torch.isfinite(best_bid)
    at_best = bidding & (bid_v >= best_bid[j1])
    winner = torch.full((s,), _BIG_ID, dtype=I32, device=dev).scatter_reduce(
        0, j1, torch.where(at_best, idx, _BIG_ID), "amin")

    # Evict the previous owners of contested tasks, seat the winners (two
    # disjoint sets of agents: a winner bid, so it was unseated).  Slot s
    # takes the writes JAX drops.
    at = torch.cat([agent_task, agent_task.new_zeros(1)])
    prev = torch.where(has_bid, task_agent, -1)
    at[torch.where(prev >= 0, prev, s).long()] = -1
    seat = torch.where(has_bid, winner, s).long()
    at[seat] = torch.where(has_bid, idx, -1)
    return (at[:s], torch.where(has_bid, winner, task_agent),
            torch.where(has_bid, best_bid, prices))


def auction_square_plain(values: torch.Tensor, prices: torch.Tensor,
                         eps: torch.Tensor, max_rounds: int,
                         run: Optional[torch.Tensor] = None,
                         counts: Optional[dict] = None) -> Square:
    """The forward auction on the square until every agent is seated or
    ``max_rounds`` rounds ran: ``(agent_task, task_agent, prices, rounds)``,
    the last a 0-dim int32.  With ``run`` false, zero rounds.  The flag is
    read on the host each round (the JAX loop, for a CPU tensor and as the
    yardstick of the kernel).  ``counts`` (a dict) gains ``bidder_rows``,
    the value rows the rounds read (the unseated agents, summed over the
    rounds)."""
    s = values.shape[0]
    dev = values.device
    agent_task = torch.full((s,), -1, dtype=I32, device=dev)
    task_agent = torch.full((s,), -1, dtype=I32, device=dev)
    eps = torch.as_tensor(eps, dtype=values.dtype, device=dev)
    rounds = 0
    if run is None or bool(run):
        while rounds < max_rounds and bool((agent_task < 0).any()):
            if counts is not None:
                counts["bidder_rows"] = (counts.get("bidder_rows", 0)
                                         + int((agent_task < 0).sum()))
            agent_task, task_agent, prices = auction_round(
                values, eps, agent_task, task_agent, prices)
            rounds += 1
    return (agent_task, task_agent, prices.clone(),
            torch.full((), rounds, dtype=I32, device=dev))


def auction_square_cuda(values: torch.Tensor, prices: torch.Tensor,
                        eps: torch.Tensor, max_rounds: int,
                        run: torch.Tensor) -> Square:
    """Launch N2 on ``values`` [S, S] float32, the starting ``prices`` [S],
    ``eps`` (0-dim float32) and ``run`` (0-dim bool), all on one CUDA
    device.  Returns ``(agent_task, task_agent, prices, rounds)`` without
    waiting for the card."""
    global LAUNCHES, _captured
    s = values.shape[0]
    if values.ndim != 2 or values.shape[1] != s:
        raise ValueError(f"auction_square_cuda takes a square [S, S] value "
                         f"matrix, got {tuple(values.shape)}")
    rounds = torch.empty((), dtype=I32, device=values.device)
    family.check_operands("auction_square_cuda", rounds, 1, values,
                          {"prices": (prices, (s,)), "eps": (eps, ())})
    if run.dtype != torch.bool or run.numel() != 1 or run.device != \
            values.device:
        raise ValueError("auction_square_cuda: run must be one bool on "
                         f"{values.device}")
    fn, state, in_shared = _lib()
    scratch = (None if in_shared(s)
               else torch.empty(state(s), dtype=torch.uint8,
                                device=values.device))
    agent_task = torch.empty((s,), dtype=I32, device=values.device)
    task_agent = torch.empty((s,), dtype=I32, device=values.device)
    prices_out = torch.empty_like(prices)
    err = fn(values.data_ptr(), prices.data_ptr(), eps.data_ptr(),
             run.data_ptr(), agent_task.data_ptr(), task_agent.data_ptr(),
             prices_out.data_ptr(), rounds.data_ptr(), family.ptr(scratch),
             s, int(max_rounds), *family.stream_args(values))
    family.check_launch(err, "auction")
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        LAUNCHES += 1
    return agent_task, task_agent, prices_out, rounds
