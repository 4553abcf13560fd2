"""User-facing moth-flame-optimization model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import mfo as _k
from ..ops.cuda import mfo_fused as _mf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class MFO:
    """Moth-flame optimization on the CUDA card, or on the CPU with
    ``device="cpu"``: each moth spirals around its flame, the flames keep
    the best positions seen, and the flame count shrinks over ``t_max``.

    Two compute paths with the same MFOState contract: the portable path
    (``ops/mfo.py``, the flames merged and sorted every generation) and the
    fused CUDA kernel (``ops/cuda/mfo_fused.py``, positional flames updated
    per step and re-sorted every ``sort_blocks`` launches), taken on a card
    for named objectives in float32 and D <= 908, or forced with
    ``use_pallas=True`` (on the CPU that runs the kernel's plain version).

    >>> opt = MFO("sphere", n=64, dim=6, t_max=200, seed=0, device="cpu")
    >>> opt.run(200)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        t_max: int = _k.T_MAX,
        b: float = _k.SPIRAL_B,
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
        if t_max <= 0:
            raise ValueError(f"t_max ({t_max}) must be positive")
        self.t_max = int(t_max)
        self.b = float(b)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.mfo_init(fn, n, dim, self.half_width, seed=seed,
                                 device=self.device, **kwargs)
        supported = (
            self.objective_name is not None
            and _mf.mfo_pallas_supported(
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

    def step(self) -> _k.MFOState:
        self.state = _k.mfo_step(self.state, self.objective, self.half_width,
                                 self.t_max, self.b)
        return self.state

    def run(self, n_steps: int) -> _k.MFOState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _mf.fused_mfo_run(
                self.state, self.objective_name, n_steps, self.half_width,
                self.t_max, self.b, steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.mfo_run(self.state, self.objective, n_steps,
                                    self.half_width, self.t_max, self.b)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.flame_fit[0])
