"""User-facing memetic (gradient-hybrid) PSO model."""

from __future__ import annotations

from ..ops import memetic as _m
from ..ops import pso as _k
from .pso import PSO


class MemeticPSO(PSO):
    """PSO + periodic autograd local refinement of personal bests.

    Same constructor as :class:`PSO` plus the refinement schedule.  Two
    compute paths: the portable path (any callable objective), and, for
    named objectives in float32 with the gbest topology, the fused
    composition (``ops.memetic.fused_memetic_run``): fused PSO blocks with
    the gradient refinement applied in the same transposed layout.
    ``use_pallas`` selects between them as in :class:`PSO`.

    >>> opt = MemeticPSO("rosenbrock", n=512, dim=10, refine_every=5)
    >>> opt.run(100)
    >>> opt.best  # doctest: +SKIP
    """

    def __init__(
        self,
        objective,
        n: int,
        dim: int,
        refine_every: int = 10,
        refine_steps: int = 5,
        lr: float = 0.01,
        **kwargs,
    ):
        super().__init__(objective, n, dim, **kwargs)
        if refine_every < 1:
            raise ValueError(
                f"refine_every must be >= 1, got {refine_every} "
                "(use PSO for no refinement)"
            )
        self.refine_every = int(refine_every)
        self.refine_steps = int(refine_steps)
        self.lr = float(lr)

    def step(self) -> _k.PSOState:
        """One PSO step + refinement on the same schedule as :meth:`run`
        (a refinement pass fires when the post-step iteration counter hits
        a ``refine_every`` multiple; the counter is read from the device).
        Always portable (per-step use)."""
        state = super().step()
        if int(state.iteration) % self.refine_every == 0:
            self.state = _m.refine_pbest(
                state, self.objective, self.refine_steps, self.lr,
                self.half_width,
            )
        return self.state

    def run(self, n_steps: int) -> _k.PSOState:
        if self.use_pallas:
            self.state = _m.fused_memetic_run(
                self.state, self.objective_name, self.objective,
                n_steps, self.refine_every, self.refine_steps, self.lr,
                self.w, self.c1, self.c2, self.half_width,
                self.vmax_frac,
                steps_per_kernel=self.steps_per_kernel,
            )
        else:
            self.state = _m.memetic_run(
                self.state, self.objective, n_steps,
                self.refine_every, self.refine_steps, self.lr,
                self.w, self.c1, self.c2, self.half_width,
                self.vmax_frac, self.topology, self.ring_radius,
                self.grid_cols,
            )
        return self.state
