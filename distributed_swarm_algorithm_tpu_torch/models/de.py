"""User-facing differential-evolution model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import de as _k
from ..ops.cuda import de_fused as _df
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class DE:
    """Differential evolution (rand/1/bin by default) on the CUDA card, or
    on the CPU with ``device="cpu"``.

    Two compute paths with the same DEState contract: the portable path
    (``ops/de.py``, exact rand/1/bin donors by row gathers) and the fused
    CUDA kernel (``ops/cuda/de_fused.py``, rotational block-start donors),
    taken on a card for named objectives in float32 with the rand1bin
    variant, a population of at least 512 (4 lane tiles of 128) and D <=
    908, or forced with ``use_pallas=True`` (on the CPU that runs the
    kernel's plain version).

    >>> opt = DE("rastrigin", n=256, dim=10, seed=0, device="cpu")
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        f: float = _k.F,
        cr: float = _k.CR,
        variant: str = "rand1bin",
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
        self.f, self.cr = float(f), float(cr)
        self.variant = variant
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.de_init(fn, n, dim, self.half_width, seed=seed,
                                device=self.device, **kwargs)
        supported = (
            variant == "rand1bin"
            and n >= 512          # rotational donors need >= 4 lane tiles
            and self.objective_name is not None
            and _df.de_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, variant='rand1bin', "
                "n >= 512 and D <= 908"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.DEState:
        self.state = _k.de_step(
            self.state, self.objective, self.f, self.cr, self.half_width,
            self.variant,
        )
        return self.state

    def run(self, n_steps: int) -> _k.DEState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _df.fused_de_run(
                self.state, self.objective_name, n_steps, self.f, self.cr,
                self.half_width, steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.de_run(
                self.state, self.objective, n_steps, self.f, self.cr,
                self.half_width, self.variant,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
