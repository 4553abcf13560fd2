"""Shared helpers for the fused-kernel modules (the port's own copy of
``ops/pallas/common.py`` of the JAX package)."""

from __future__ import annotations

import torch


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m


def cyclic_pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad a [N, ...] float tensor to ``n_pad`` rows by duplicating the
    leading rows cyclically (as float32).

    The invariant every fused run relies on: duplicates are legal
    population members, so the population optimum is preserved: the min
    over a multiset superset of the real members cannot be worse, and the
    padding is sliced off on return.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    if n_pad < n:
        raise ValueError(
            f"cyclic_pad_rows: n_pad={n_pad} < n={n} would silently drop "
            "population members; callers must pass n_pad >= x.shape[0]"
        )
    if n_pad == n:
        return x
    reps = -(-n_pad // n)
    return x.repeat((reps,) + (1,) * (x.ndim - 1))[:n_pad]


def replays_graphs(device: torch.device) -> bool:
    """Whether a run on ``device`` replays captured CUDA graphs: on a card
    only."""
    return device.type == "cuda"


def capture_graph(body, gen: torch.Generator,
                  device: torch.device) -> torch.cuda.CUDAGraph:
    """A CUDA graph of ``body()`` captured on a side stream, with ``gen``
    registered, so a replay draws from the generator's offset at that
    replay and advances it as the eager calls do.  No
    ``torch.cuda.graph`` context, whose entry synchronizes.  A capture
    that fails raises; the generator then gets a fresh state at the seed
    and offset it had (a failed capture leaves its state marked as
    capturing, and every later draw would raise)."""
    saved = gen.get_state()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                body()
            finally:
                graph.capture_end()
    except BaseException:
        fresh = torch.Generator(device=device)
        fresh.set_state(saved)
        gen.graphsafe_set_state(fresh.graphsafe_get_state())
        raise
    torch.cuda.current_stream(device).wait_stream(side)
    return graph
