"""User-facing parallel-tempering model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import tempering as _k
from ..ops.cuda import tempering_fused as _tf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class ParallelTempering:
    """Parallel tempering (replica exchange) on the CUDA card, or on the
    CPU with ``device="cpu"``: ``n`` Metropolis chains on a geometric
    temperature ladder, exchanging replicas with the detailed-balance
    probability every ``swap_every`` steps.

    Two compute paths with the same PTState contract: the portable path
    (``ops/tempering.py``, the global XOR-parity exchange) and the fused
    CUDA kernel (``ops/cuda/tempering_fused.py``, on-chip Box-Muller
    proposals, the tile-local adjacent-lane exchange, the best state
    visited recorded in the kernel), taken on a card for named objectives
    in float32 with n >= 128 and D <= 360, or forced with
    ``use_pallas=True`` (on the CPU that runs the kernel's plain version).

    >>> opt = ParallelTempering("rastrigin", n=32, dim=6, seed=0,
    ...                         device="cpu")
    >>> opt.run(2000)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        t_min: float = _k.T_MIN,
        t_max: float = _k.T_MAX,
        sigma0: float = _k.SIGMA0,
        swap_every: int = _k.SWAP_EVERY,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        use_pallas: Optional[bool] = None,
        steps_per_kernel: int = 16,
        device: DeviceLike = None,
    ):
        if isinstance(objective, str):
            fn, default_hw = get_objective(objective)
            self.objective_name: Optional[str] = objective
        else:
            fn, default_hw = objective, 5.12
            self.objective_name = None
        self.objective = fn
        self.half_width = float(
            half_width if half_width is not None else default_hw
        )
        if not 0 < t_min < t_max:
            raise ValueError(f"need 0 < t_min ({t_min}) < t_max ({t_max})")
        if swap_every <= 0:
            raise ValueError(f"swap_every ({swap_every}) must be positive")
        self.sigma0 = float(sigma0)
        self.swap_every = int(swap_every)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.pt_init(fn, n, dim, self.half_width,
                                t_min=float(t_min), t_max=float(t_max),
                                seed=seed, device=self.device, **kwargs)
        supported = (
            n >= 128            # one full lane tile
            and self.objective_name is not None
            and _tf.pt_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, n >= 128 and D <= 360"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.PTState:
        self.state = _k.pt_step(self.state, self.objective, self.half_width,
                                self.sigma0, self.swap_every)
        return self.state

    def run(self, n_steps: int) -> _k.PTState:
        """Advance ``n_steps`` steps and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _tf.fused_pt_run(
                self.state, self.objective_name, n_steps, self.half_width,
                self.sigma0, self.swap_every,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.pt_run(self.state, self.objective, n_steps,
                                   self.half_width, self.sigma0,
                                   self.swap_every)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
