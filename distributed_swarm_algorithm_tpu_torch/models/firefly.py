"""User-facing firefly-algorithm model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import firefly as _k
from ..ops.cuda import firefly_fused as _ff
from ..ops.objectives import get_objective
from ..utils.platform import DeviceLike, resolve_device


class Firefly:
    """Firefly algorithm (all-pairs brightness attraction, Yang 2008) on the
    CUDA card, or on the CPU with ``device="cpu"``.

    Synchronous generation-at-once variant (``ops/firefly.py``); the random
    walk scale ``alpha0`` decays by ``alpha_decay`` per iteration.

    Two compute paths with the same FireflyState contract and update rule:
    the portable step holds the [N, N] weight matrix (the CPU's path); the
    fused path (``ops/cuda/firefly_fused.py``) streams the pairs through the
    CUDA kernel with no pairwise temporary, taken on a card for float32
    state with D <= 128 at any n, or forced with ``use_pallas=True`` (on the
    CPU that runs the kernel's plain version).  Any objective callable works
    on both.

    >>> opt = Firefly("sphere", n=64, dim=4, seed=0, device="cpu")
    >>> opt.run(150)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        half_width: Optional[float] = None,
        beta0: float = _k.BETA0,
        gamma: float = _k.GAMMA,
        alpha0: float = _k.ALPHA0,
        alpha_decay: float = _k.ALPHA_DECAY,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        use_pallas: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        if isinstance(objective, str):
            fn, default_hw = get_objective(objective)
        else:
            fn, default_hw = objective, 5.12
        self.objective = fn
        self.half_width = float(
            half_width if half_width is not None else default_hw
        )
        self.beta0 = float(beta0)
        self.gamma = float(gamma)
        self.alpha0 = float(alpha0)
        self.alpha_decay = float(alpha_decay)
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.firefly_init(fn, n, dim, self.half_width, seed=seed,
                                     device=self.device, **kwargs)
        supported = _ff.firefly_cuda_supported(self.state.pos.dtype, dim)
        if use_pallas is None:
            self.use_pallas = supported and self.device.type == "cuda"
        elif use_pallas and not supported:
            raise ValueError(
                "use_pallas=True needs float32 state with D <= "
                f"{_ff.D_MAX}")
        else:
            self.use_pallas = bool(use_pallas)

    def step(self) -> _k.FireflyState:
        """One generation, on the same path as :meth:`run`."""
        return self.run(1)

    def run(self, n_steps: int) -> _k.FireflyState:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        run = _ff.fused_firefly_run if self.use_pallas else _k.firefly_run
        self.state = run(
            self.state, self.objective, n_steps, self.half_width,
            self.beta0, self.gamma, self.alpha0, self.alpha_decay,
        )
        return self.state

    @property
    def best(self) -> float:
        return float(self.state.best_fit)
