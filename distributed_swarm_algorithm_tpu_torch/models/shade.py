"""User-facing SHADE model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import shade as _k
from ..ops.cuda import shade_fused as _sf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class SHADE:
    """Success-history adaptive differential evolution on the CUDA card, or
    on the CPU with ``device="cpu"``.

    Two compute paths with the same SHADEState contract: the portable path
    (``ops/shade.py``, exact current-to-pbest/1 with an archive) and the
    fused CUDA kernel (``ops/cuda/shade_fused.py``, SHADE-R: rotational
    donors and an elite pool of per-tile champions), taken on a card for
    named objectives in float32 with the default ``p_best``, a population
    of at least 512 (4 lane tiles of 128) and D <= 363, or forced with
    ``use_pallas=True`` (on the CPU that runs the kernel's plain version).

    >>> opt = SHADE("rastrigin", n=256, dim=10, seed=0, device="cpu")
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        p_best: float = _k.P_BEST,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        use_pallas: Optional[bool] = None,
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
        if not 0.0 < p_best <= 1.0:
            raise ValueError(f"p_best ({p_best}) must be in (0, 1]")
        self.p_best = float(p_best)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.shade_init(fn, n, dim, self.half_width, seed=seed,
                                   device=self.device, **kwargs)
        supported = (
            p_best == _k.P_BEST     # SHADE-R uses its own elite pool
            and n >= 512            # rotational donors need >= 4 tiles
            and self.objective_name is not None
            and _sf.shade_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, default p_best, n >= 512 "
                "and D <= 363"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.SHADEState:
        self.state = _k.shade_step(self.state, self.objective,
                                   self.half_width, self.p_best)
        return self.state

    def run(self, n_steps: int) -> _k.SHADEState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _sf.fused_shade_run(
                self.state, self.objective_name, n_steps, self.half_width,
            )
        else:
            self.state = _k.shade_run(self.state, self.objective, n_steps,
                                      self.half_width, self.p_best)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
