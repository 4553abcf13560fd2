"""User-facing bat-algorithm model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import bat as _k
from ..ops.cuda import bat_fused as _bf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class Bat:
    """Bat algorithm (echolocation search, Yang 2010) on the CUDA card, or
    on the CPU with ``device="cpu"``.

    Per-bat loudness/pulse adaptation schedules each individual's own
    exploration -> exploitation transition.

    ``run`` uses the fused CUDA kernel (``ops/cuda/bat_fused.py``) on a
    card for named objectives in float32 inside the kernel's envelope,
    forced with ``use_pallas=True`` (on the CPU that runs the kernel's
    plain version: slow, for testing) or disabled with
    ``use_pallas=False``.  ``step`` always takes the portable path.

    >>> opt = Bat("sphere", n=64, dim=6, seed=0)
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        f_min: float = _k.F_MIN,
        f_max: float = _k.F_MAX,
        alpha: float = _k.ALPHA,
        gamma: float = _k.GAMMA,
        r0: float = _k.R0,
        sigma_local: float = _k.SIGMA_LOCAL,
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
        if f_max < f_min:
            raise ValueError(f"f_max ({f_max}) must be >= f_min ({f_min})")
        self.f_min, self.f_max = float(f_min), float(f_max)
        self.alpha, self.gamma = float(alpha), float(gamma)
        self.r0, self.sigma_local = float(r0), float(sigma_local)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.bat_init(fn, n, dim, self.half_width, seed=seed,
                                 device=self.device, **kwargs)
        supported = self.objective_name is not None and (
            _bf.bat_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state and D <= 605"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.BatState:
        self.state = _k.bat_step(
            self.state, self.objective, self.half_width, self.f_min,
            self.f_max, self.alpha, self.gamma, self.r0, self.sigma_local,
        )
        return self.state

    def run(self, n_steps: int) -> _k.BatState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _bf.fused_bat_run(
                self.state, self.objective_name, n_steps,
                half_width=self.half_width, f_min=self.f_min,
                f_max=self.f_max, alpha=self.alpha, gamma=self.gamma,
                r0=self.r0, sigma_local=self.sigma_local,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.bat_run(
                self.state, self.objective, n_steps, self.half_width,
                self.f_min, self.f_max, self.alpha, self.gamma, self.r0,
                self.sigma_local,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
