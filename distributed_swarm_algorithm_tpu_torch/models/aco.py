"""User-facing ACO (ant colony) TSP solver."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import aco as _k
from ..ops.cuda import aco_fused as _af
from ..utils.platform import DeviceLike, resolve_device


class ACO:
    """Ant-colony TSP solver over a coordinate set or a distance matrix, on
    the CUDA card, or on the CPU with ``device="cpu"``.

    Two compute paths with the same ACOState contract: the portable colony
    step (``ops/aco.py``: every ant samples its next city at once by masked
    Gumbel-argmax over row ``cur`` of the pheromone-heuristic scores) and
    the fused path (``ops/cuda/aco_fused.py``: whole tours in one CUDA
    kernel, the scores read by column as the JAX package's kernel reads
    them, Gumbel noise drawn on the chip, and the deposit matrix in a
    second kernel), taken on a card for C <= 2,048 cities, or forced with
    ``use_pallas=True`` (on the CPU that runs the kernels' plain versions).

    >>> import numpy as np
    >>> pts = np.random.default_rng(0).uniform(size=(24, 2))
    >>> colony = ACO(coords=pts, n_ants=64, seed=0, device="cpu")
    >>> colony.run(50)
    >>> colony.best_length  # doctest: +SKIP
    """

    def __init__(
        self,
        coords=None,
        dist=None,
        n_ants: int = 64,
        alpha: float = 1.0,
        beta: float = 2.0,
        rho: float = 0.1,
        q0: float = 0.0,
        elite: float = 0.0,
        seed: int = 0,
        tau0: Optional[float] = None,
        use_pallas: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        if (coords is None) == (dist is None):
            raise ValueError("pass exactly one of coords= or dist=")
        self.device = resolve_device(device)
        as_f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32)).to(self.device)
        if dist is None:
            dist = _k.coords_to_dist(as_f32(coords))
        else:
            dist = as_f32(dist)
            if dist.ndim != 2 or dist.shape[0] != dist.shape[1]:
                raise ValueError(
                    f"dist must be square, got {tuple(dist.shape)}")
        self.n_ants = int(n_ants)
        self.alpha, self.beta = float(alpha), float(beta)
        self.rho, self.q0, self.elite = float(rho), float(q0), float(elite)
        supported = _af.aco_cuda_supported(dist.shape[0], self.n_ants)
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            _af.require_supported(dist.shape[0], self.n_ants)
        else:
            self.use_pallas = bool(use_pallas)
        self.state = _k.aco_init(dist, seed=seed, tau0=tau0)

    def _args(self):
        return (self.n_ants, self.alpha, self.beta, self.rho, self.q0,
                self.elite)

    def step(self, out: Optional[dict] = None) -> _k.ACOState:
        step = _af.fused_aco_step if self.use_pallas else _k.aco_step
        self.state = step(self.state, *self._args(), out=out)
        return self.state

    def run(self, n_steps: int, out: Optional[dict] = None) -> _k.ACOState:
        """Advance ``n_steps`` iterations and return the new state, without
        waiting for the card (reading a field does).  A dict ``out``
        receives the last iteration's ``tours`` [A, C] and ``lengths``
        [A]."""
        run = _af.fused_aco_run if self.use_pallas else _k.aco_run
        self.state = run(self.state, n_steps, *self._args(), out=out)
        return self.state

    @property
    def best_length(self) -> float:
        return float(self.state.best_len)

    @property
    def best_tour(self) -> np.ndarray:
        return self.state.best_tour.cpu().numpy()
