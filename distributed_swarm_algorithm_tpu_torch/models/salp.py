"""User-facing salp-swarm model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import salp as _k
from ..ops.cuda import salp_fused as _sf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class Salp:
    """Salp swarm algorithm on the CUDA card, or on the CPU with
    ``device="cpu"``: a leader explores around the food source under a
    shrinking envelope, the followers average down the chain.

    ``run`` uses the fused CUDA kernel (``ops/cuda/salp_fused.py``) on a
    card for named objectives in float32 inside the kernel's envelope and
    at least one 128-lane tile of salps, forced with ``use_pallas=True``
    (on the CPU that runs the kernel's plain version) or disabled with
    ``use_pallas=False``; ``step`` always takes the portable path.

    >>> opt = Salp("sphere", n=1024, dim=6, seed=0)
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        t_max: int = _k.T_MAX,
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
        if t_max <= 0:
            raise ValueError(f"t_max ({t_max}) must be positive")
        self.t_max = int(t_max)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.salp_init(fn, n, dim, self.half_width, seed=seed,
                                  device=self.device, **kwargs)
        supported = (
            n >= 128            # one full lane tile
            and self.objective_name is not None
            and _sf.salp_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, D <= 452 and n >= 128"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.SalpState:
        self.state = _k.salp_step(
            self.state, self.objective, self.half_width, self.t_max
        )
        return self.state

    def run(self, n_steps: int) -> _k.SalpState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _sf.fused_salp_run(
                self.state, self.objective_name, n_steps,
                self.half_width, self.t_max,
            )
        else:
            self.state = _k.salp_run(
                self.state, self.objective, n_steps, self.half_width,
                self.t_max,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
