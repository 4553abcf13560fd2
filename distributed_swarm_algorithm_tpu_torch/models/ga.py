"""User-facing genetic-algorithm model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import ga as _k
from ..ops.cuda import ga_fused as _gf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class GA:
    """Real-coded genetic algorithm on the CUDA card, or on the CPU with
    ``device="cpu"``: binary tournaments, SBX crossover, polynomial mutation
    and elitism.

    Two compute paths with the same GAState contract: the portable path
    (``ops/ga.py``, iid tournaments and global ``n_elite``-elitism) and the
    fused CUDA kernel (``ops/cuda/ga_fused.py``, rotational tournaments and
    per-tile elitism), taken on a card for named objectives in float32 with
    the default ``n_elite`` and a population of at least 512 (4 lane tiles
    of 128), or forced with ``use_pallas=True`` (on the CPU that runs the
    kernel's plain version).

    >>> opt = GA("rastrigin", n=256, dim=10, seed=0, device="cpu")
    >>> opt.run(300)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        eta_c: float = _k.ETA_C,
        eta_m: float = _k.ETA_M,
        p_cross: float = _k.P_CROSS,
        p_mut: Optional[float] = None,
        n_elite: int = _k.N_ELITE,
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
        if not 0 <= n_elite < n:
            raise ValueError(f"n_elite ({n_elite}) must be in [0, n)")
        self.eta_c, self.eta_m = float(eta_c), float(eta_m)
        self.p_cross = float(p_cross)
        self.p_mut = None if p_mut is None else float(p_mut)
        self.n_elite = int(n_elite)
        self.steps_per_kernel = int(steps_per_kernel)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.ga_init(fn, n, dim, self.half_width, seed=seed,
                                device=self.device, **kwargs)
        supported = (
            n >= 512            # rotational donors need >= 4 lane tiles
            and self.objective_name is not None
            # the fused kernel's elitism is fixed per-tile-1; a non-default
            # n_elite (0 included) stays on the portable path
            and n_elite == _k.N_ELITE
            and _gf.ga_pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, n >= 512, and the default "
                "n_elite (the fused kernel's elitism is per-tile-1, not "
                "configurable)"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.GAState:
        self.state = _k.ga_step(
            self.state, self.objective, self.half_width, self.eta_c,
            self.eta_m, self.p_cross, self.p_mut, self.n_elite,
        )
        return self.state

    def run(self, n_steps: int) -> _k.GAState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        if self.use_pallas:
            self.state = _gf.fused_ga_run(
                self.state, self.objective_name, n_steps, self.half_width,
                self.eta_c, self.eta_m, self.p_cross, self.p_mut,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.ga_run(
                self.state, self.objective, n_steps, self.half_width,
                self.eta_c, self.eta_m, self.p_cross, self.p_mut,
                self.n_elite,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
