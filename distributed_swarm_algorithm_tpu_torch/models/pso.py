"""User-facing PSO optimizer model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import pso as _k
from ..ops import topology as _topo
from ..ops.cuda import pso_fused as _pf
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class PSO:
    """Global-best particle swarm optimizer on the CUDA card, or on the CPU
    with ``device="cpu"``.

    Two compute paths with the same PSOState contract:
      - portable PyTorch (``ops/pso.py``; any objective, any topology),
      - the fused CUDA kernel (``ops/cuda/pso_fused.py``), taken
        automatically on a card for named objectives in float32 with the
        gbest topology inside the kernel's envelope
        (``pso_fused.pallas_supported``), or forced with
        ``use_pallas=True`` (on the CPU that runs the kernel's plain
        version: slow, for testing).  The option keeps the JAX package's
        name and means "the fused kernel".

    >>> opt = PSO("rastrigin", n=4096, dim=30, seed=0)
    >>> opt.run(500)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        w: float = _k.W,
        c1: float = _k.C1,
        c2: float = _k.C2,
        vmax_frac: float = 0.5,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        use_pallas: Optional[bool] = None,
        steps_per_kernel: int = 8,
        topology: str = "gbest",
        ring_radius: int = 1,
        grid_cols: int = 0,
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
        self.w, self.c1, self.c2 = float(w), float(c1), float(c2)
        self.vmax_frac = float(vmax_frac)
        self.steps_per_kernel = int(steps_per_kernel)
        if topology not in _topo.TOPOLOGIES:
            raise ValueError(
                f"unknown topology {topology!r}; "
                f"available: {_topo.TOPOLOGIES}"
            )
        self.topology = topology
        self.ring_radius = int(ring_radius)
        self.grid_cols = int(grid_cols)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.pso_init(
            fn, n, dim, self.half_width, seed=seed, device=self.device,
            **kwargs
        )

        # The fused kernel implements the gbest attractor only.
        supported = (
            topology == "gbest"
            and self.objective_name is not None
            and _pf.pallas_supported(
                self.objective_name, self.state.pos.dtype,
                self.state.pos.shape[-1],
            )
        )
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs a named objective from "
                "ops.objectives, float32 state, topology='gbest' and a "
                "dimension inside the kernel's envelope (D <= 605; "
                f"michalewicz: D <= {_pf.MICHALEWICZ_DIM_MAX})"
            )
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.PSOState:
        self.state = _k.pso_step(
            self.state, self.objective, self.w, self.c1, self.c2,
            self.half_width, self.vmax_frac,
            self.topology, self.ring_radius, self.grid_cols,
        )
        return self.state

    def run(self, n_steps: int) -> _k.PSOState:
        """Advance ``n_steps`` iterations and return the new state.

        ``run`` returns with device work possibly still in flight: it does
        not wait for the card.  Reading any state field (``opt.best``,
        ``state.gbest_fit``, ...) synchronizes, which is where device-side
        failures surface; callers timing ``run()`` alone measure the
        enqueue only.
        """
        if self.use_pallas:
            self.state = _pf.fused_pso_run(
                self.state, self.objective_name, n_steps,
                self.w, self.c1, self.c2, self.half_width, self.vmax_frac,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _k.pso_run(
                self.state, self.objective, n_steps, self.w, self.c1,
                self.c2, self.half_width, self.vmax_frac,
                self.topology, self.ring_radius, self.grid_cols,
            )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.gbest_fit)
