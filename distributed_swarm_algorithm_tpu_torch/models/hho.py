"""User-facing Harris-hawks model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import hho as _k
from ..ops.cuda import hho_fused as _hf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class HarrisHawks:
    """Harris hawks optimization (cooperative pursuit, Heidari 2019) on the
    CUDA card, or on the CPU with ``device="cpu"``.

    The prey's decaying escape energy gates each hawk between exploration
    perches and four besiege strategies (soft or hard, with or without Levy
    rapid dives).  Two compute paths with the same HHOState contract: the
    portable path (``ops/hho.py``) and the fused CUDA kernel
    (``ops/cuda/hho_fused.py``, block-start rabbit, mean and rotational
    peer), taken on a card for named objectives in float32 with n >= 512
    and D <= 605, or forced with ``use_pallas=True`` (on the CPU that runs
    the kernel's plain version).

    >>> opt = HarrisHawks("sphere", n=64, dim=6, seed=0, device="cpu")
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
        levy_beta: float = _k.LEVY_BETA,
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
        self.levy_beta = float(levy_beta)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.hho_init(fn, n, dim, self.half_width, seed=seed,
                                 device=self.device, **kwargs)
        supported = (
            n >= 512            # rotational peers need >= 4 lane tiles
            and self.objective_name is not None
            and _hf.hho_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, n >= 512 and D <= 605"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.HHOState:
        self.state = _k.hho_step(
            self.state, self.objective, self.half_width, self.t_max,
            self.levy_beta,
        )
        return self.state

    def run(self, n_steps: int) -> _k.HHOState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _hf.fused_hho_run(
                self.state, self.objective_name, n_steps, self.half_width,
                self.t_max, self.levy_beta,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.hho_run(
                self.state, self.objective, n_steps, self.half_width,
                self.t_max, self.levy_beta,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
