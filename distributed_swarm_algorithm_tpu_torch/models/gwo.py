"""User-facing grey-wolf-optimizer model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import gwo as _k
from ..ops.cuda import gwo_fused as _gf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class GWO:
    """Grey wolf optimizer on the CUDA card, or on the CPU with
    ``device="cpu"``: the pack moves toward its alpha/beta/delta leaders,
    explores while ``a`` decays from 2 and exploits fully once ``t_max``
    iterations have elapsed.

    ``run`` uses the fused CUDA kernel (``ops/cuda/gwo_fused.py``) on a
    card for named objectives in float32 inside the kernel's envelope,
    forced with ``use_pallas=True`` (on the CPU that runs the kernel's
    plain version) or disabled with ``use_pallas=False``; ``step`` always
    takes the portable path.

    >>> opt = GWO("rastrigin", n=256, dim=10, t_max=300, seed=0)
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        t_max: int = 500,
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
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.gwo_init(fn, n, dim, self.half_width, seed=seed,
                                 device=self.device, **kwargs)
        supported = self.objective_name is not None and (
            _gf.gwo_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state and D <= 908"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.GWOState:
        self.state = _k.gwo_step(
            self.state, self.objective, self.half_width, self.t_max
        )
        return self.state

    def run(self, n_steps: int) -> _k.GWOState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _gf.fused_gwo_run(
                self.state, self.objective_name, n_steps,
                half_width=self.half_width, t_max=self.t_max,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.gwo_run(
                self.state, self.objective, n_steps, self.half_width,
                self.t_max,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.leader_fit[0])
