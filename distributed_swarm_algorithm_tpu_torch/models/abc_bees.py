"""User-facing artificial-bee-colony optimizer model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import abc as _k
from ..ops.cuda import abc_fused as _af
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class ABC:
    """Artificial bee colony (employed, onlooker and scout phases) on the
    CUDA card, or on the CPU with ``device="cpu"``.

    Two compute paths with the same ABCState contract: the portable path
    (``ops/abc.py``, the exact multinomial onlooker recruitment) and the
    fused CUDA kernel (``ops/cuda/abc_fused.py``, Bernoulli recruitment and
    rotational partners), taken on a card for named objectives in float32
    with n >= 512, or forced with ``use_pallas=True`` (on the CPU that runs
    the kernel's plain version).  ``limit`` defaults to ``n * dim``
    (Karaboga's rule of thumb).

    >>> opt = ABC("rastrigin", n=256, dim=10, seed=0, device="cpu")
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        limit: Optional[int] = None,
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
        self.limit = int(limit if limit is not None else n * dim)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.abc_init(fn, n, dim, self.half_width, seed=seed,
                                 device=self.device, **kwargs)
        supported = (
            n >= 512            # rotational partners need >= 4 lane tiles
            and self.objective_name is not None
            and _af.abc_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, and n >= 512"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.ABCState:
        self.state = _k.abc_step(self.state, self.objective,
                                 self.half_width, self.limit)
        return self.state

    def run(self, n_steps: int) -> _k.ABCState:
        """Advance ``n_steps`` cycles and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _af.fused_abc_run(
                self.state, self.objective_name, n_steps, self.half_width,
                self.limit, steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.abc_run(self.state, self.objective, n_steps,
                                    self.half_width, self.limit)
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
