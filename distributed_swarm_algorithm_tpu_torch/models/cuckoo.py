"""User-facing cuckoo-search model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import cuckoo as _k
from ..ops.cuda import cuckoo_fused as _cf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class Cuckoo:
    """Cuckoo search (Levy flights and nest abandonment, Yang & Deb 2009)
    on the CUDA card, or on the CPU with ``device="cpu"``.

    Two compute paths with the same CuckooState contract: the portable path
    (``ops/cuckoo.py``, random egg targets and permuted peers) and the
    fused CUDA kernel (``ops/cuda/cuckoo_fused.py``, the rotational egg
    drop and peers, in-kernel Box-Muller Levy flights), taken on a card for
    named objectives in float32 with n >= 512 (4 lane tiles of 128), or
    forced with ``use_pallas=True`` (on the CPU that runs the kernel's
    plain version).

    >>> opt = Cuckoo("rastrigin", n=64, dim=8, seed=0, device="cpu")
    >>> opt.run(400)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        pa: float = _k.PA,
        step_scale: float = _k.STEP_SCALE,
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
        if not 0.0 <= pa <= 1.0:
            raise ValueError(f"pa must be in [0, 1], got {pa}")
        self.pa = float(pa)
        self.step_scale = float(step_scale)
        self.levy_beta = float(levy_beta)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.cuckoo_init(fn, n, dim, self.half_width, seed=seed,
                                    device=self.device, **kwargs)
        supported = (
            n >= 512            # rotational peers need >= 4 lane tiles
            and self.objective_name is not None
            and _cf.cuckoo_pallas_supported(
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

    def step(self) -> _k.CuckooState:
        self.state = _k.cuckoo_step(
            self.state, self.objective, self.half_width, self.pa,
            self.step_scale, self.levy_beta,
        )
        return self.state

    def run(self, n_steps: int) -> _k.CuckooState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _cf.fused_cuckoo_run(
                self.state, self.objective_name, n_steps, self.half_width,
                self.pa, self.step_scale, self.levy_beta,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.cuckoo_run(
                self.state, self.objective, n_steps, self.half_width,
                self.pa, self.step_scale, self.levy_beta,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
