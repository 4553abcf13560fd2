"""User-facing whale-optimization model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import woa as _k
from ..ops.cuda import woa_fused as _wf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class WOA:
    """Whale optimization algorithm on the CUDA card, or on the CPU with
    ``device="cpu"``: each whale encircles the incumbent best, searches
    toward a random peer, or spirals in; it explores while ``a`` decays
    from 2 and exploits fully once ``t_max`` iterations have elapsed.

    Two compute paths with the same WOAState contract: the portable path
    (``ops/woa.py``, independent random peers) and the fused CUDA kernel
    (``ops/cuda/woa_fused.py``, the rotational peer and a per-launch best),
    taken on a card for named objectives in float32 inside the kernel's
    envelope, or forced with ``use_pallas=True`` (on the CPU that runs the
    kernel's plain version).

    >>> opt = WOA("sphere", n=64, dim=6, t_max=200, seed=0)
    >>> opt.run(200)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        t_max: int = 500,
        spiral_b: float = _k.SPIRAL_B,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        use_pallas: Optional[bool] = None,
        steps_per_kernel: int = 8,
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
        if t_max < 1:
            raise ValueError(f"t_max must be >= 1, got {t_max}")
        self.t_max = int(t_max)
        self.spiral_b = float(spiral_b)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.woa_init(fn, n, dim, self.half_width, seed=seed,
                                 device=self.device, **kwargs)
        supported = (
            self.objective_name is not None
            and _wf.woa_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state and D <= 1816"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.WOAState:
        self.state = _k.woa_step(
            self.state, self.objective, self.half_width, self.t_max,
            self.spiral_b,
        )
        return self.state

    def run(self, n_steps: int) -> _k.WOAState:
        """Advance ``n_steps`` updates and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _wf.fused_woa_run(
                self.state, self.objective_name, n_steps,
                self.half_width, self.t_max, self.spiral_b,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.woa_run(
                self.state, self.objective, n_steps, self.half_width,
                self.t_max, self.spiral_b,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
