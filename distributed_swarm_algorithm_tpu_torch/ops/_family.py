"""Plumbing the optimizer families' states share: dataclass conveniences,
the numpy converters and the uniform draw.

Each family's state (``ops/bat.py``, ``ops/gwo.py``, ``ops/salp.py``,
``ops/woa.py``) is a dataclass of tensors with the JAX state's field names
and dtypes, its ``key`` replaced by ``gen``, a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..state import _generator
from ..utils.platform import DeviceLike, resolve_device


class FamilyState:
    """Mixin of the family dataclasses: ``replace`` and ``device``."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.pos.device


def tensor_fields(cls) -> tuple:
    """The tensor fields of a family's state, ``gen`` left out."""
    return tuple(f.name for f in dataclasses.fields(cls) if f.name != "gen")


def state_from_numpy(cls, arrays: Mapping[str, np.ndarray],
                     device: DeviceLike = None, seed: int = 0):
    """A ``cls`` state from numpy arrays named like its fields (a JAX
    state's fields as numpy; its ``key`` is ignored).  Dtypes are kept as
    given; ``gen`` is a fresh generator seeded with ``seed``."""
    dev = resolve_device(device)
    fields = tensor_fields(cls)
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {missing}")
    return cls(
        gen=_generator(dev, seed),
        **{f: torch.from_numpy(np.array(arrays[f], copy=True)).to(dev)
           for f in fields},
    )


def state_to_numpy(state) -> dict:
    """Every tensor field as a numpy array (the generator is left out)."""
    return {f: getattr(state, f).cpu().numpy()
            for f in tensor_fields(type(state))}


def uniform(gen: torch.Generator, shape, dtype, device, lo: float,
            hi: float) -> torch.Tensor:
    """U[lo, hi) from ``gen``, as ``lo + (hi - lo) * u``."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return lo + (hi - lo) * u


def init_population(objective, n: int, dim: int, half_width: float,
                    seed: int, dtype, device: DeviceLike):
    """(gen, pos [n, dim] uniform in the domain, fit [n]) of a new
    population, drawn from a generator seeded with ``seed`` (not JAX's
    numbers for the same seed)."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    pos = uniform(gen, (n, dim), dtype, dev, -half_width, half_width)
    return gen, pos, objective(pos)


def track_best(fit, pos, best_fit, best_pos):
    """The incumbent after a step, selected on the device: the first of
    the population's least fitnesses replaces it where strictly lower."""
    b = torch.argmin(fit)
    improved = fit[b] < best_fit
    return (torch.where(improved, fit[b], best_fit),
            torch.where(improved, pos[b], best_pos))
