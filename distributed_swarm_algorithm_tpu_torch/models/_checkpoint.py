"""Checkpoint and restore of a swarm state through ``torch.save``.

A checkpoint holds every tensor field (on the CPU) and the generator's
state, so a restored swarm draws the same election jitter as the one that
was saved.  It loads with ``weights_only=True``: tensors and plain values,
nothing that runs code.
"""

from __future__ import annotations

import torch

from ..state import TENSOR_FIELDS, SwarmState
from ..utils.platform import DeviceLike, resolve_device


def save(path: str, state: SwarmState) -> None:
    """Write ``state`` to ``path``."""
    torch.save(
        {
            "fields": {f: getattr(state, f).cpu() for f in TENSOR_FIELDS},
            "gen_state": state.gen.get_state(),
            "gen_device": state.gen.device.type,
        },
        path,
    )


def load(path: str, device: DeviceLike = None) -> SwarmState:
    """Read a state written by :func:`save` onto ``device``.  The
    generator's state carries over only to a device of the same type as
    the one it was saved from."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if ckpt["gen_device"] != dev.type:
        raise ValueError(
            f"checkpoint {path} holds a {ckpt['gen_device']} generator; "
            f"load it onto a {ckpt['gen_device']} device, not {dev}"
        )
    gen = torch.Generator(device=dev)
    gen.set_state(ckpt["gen_state"])
    fields = ckpt["fields"]
    missing = [f for f in TENSOR_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"checkpoint {path} lacks fields {missing}")
    return SwarmState(
        gen=gen, **{f: fields[f].to(dev) for f in TENSOR_FIELDS}
    )


class CheckpointMixin:
    """save()/load() over the model's ``state``."""

    def save(self, path: str) -> None:
        """Checkpoint the model state."""
        save(path, self.state)

    def load(self, path: str) -> None:
        """Restore state saved by :meth:`save` onto the model's device."""
        self.state = load(path, self.state.device)
