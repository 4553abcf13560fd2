"""User-facing NSGA-II multi-objective model."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops import nsga2 as _k
from ..ops.constraints import violation as _violation
from ..utils.platform import DeviceLike, resolve_device


class NSGA2:
    """NSGA-II (Deb et al. 2002): elitist multi-objective search, on the
    CUDA card (its ranks by kernel N1), or on the CPU with
    ``device="cpu"``.

    ``objective`` maps [K, D] -> [K, M] batched (minimization), or names a
    ZDT problem ("zdt1" | "zdt2" | "zdt3", domain [0, 1]).
    ``inequalities`` / ``equalities`` (batched [K, D] -> [K]; feasible
    where g <= 0 / h == 0) switch ranking to Deb's constrained domination.

    >>> opt = NSGA2("zdt1", n=128, dim=12, seed=0, device="cpu")
    >>> opt.run(150)
    >>> front = opt.pareto_front()  # doctest: +SKIP
    """

    def __init__(
        self,
        objective: Union[str, Callable],
        n: int,
        dim: int,
        lb: float = 0.0,
        ub: float = 1.0,
        eta_c: float = _k.ETA_C,
        eta_m: float = _k.ETA_M,
        p_cross: float = _k.P_CROSS,
        p_mut: Optional[float] = None,
        inequalities=(),
        equalities=(),
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        if isinstance(objective, str):
            try:
                fn = _k.MOO_PROBLEMS[objective]
            except KeyError:
                raise ValueError(
                    f"unknown multi-objective problem {objective!r}; "
                    f"have {sorted(_k.MOO_PROBLEMS)}"
                ) from None
            self.problem_name: Optional[str] = objective
        else:
            fn = objective
            self.problem_name = None
        if ub <= lb:
            raise ValueError(f"ub ({ub}) must be > lb ({lb})")
        self.objective = fn
        self.lb, self.ub = float(lb), float(ub)
        self.eta_c, self.eta_m = float(eta_c), float(eta_m)
        self.p_cross = float(p_cross)
        self.p_mut = None if p_mut is None else float(p_mut)
        if inequalities or equalities:
            ineqs, eqs = tuple(inequalities), tuple(equalities)
            self.violation_fn = lambda x: _violation(x, ineqs, eqs)
        else:
            self.violation_fn = None
        self.device = resolve_device(device)
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.state = _k.nsga2_init(
            fn, n, dim, self.lb, self.ub, seed=seed,
            violation_fn=self.violation_fn, device=self.device, **kwargs)

    def step(self, draws: Optional[_k.NSGA2Draws] = None) -> _k.NSGA2State:
        """One generation; ``draws`` replaces the generator's (see
        ``ops.nsga2.NSGA2Draws``)."""
        self.state = _k.nsga2_step(
            self.state, self.objective, self.lb, self.ub, self.eta_c,
            self.eta_m, self.p_cross, self.p_mut, self.violation_fn,
            draws=draws)
        return self.state

    def run(self, n_steps: int) -> _k.NSGA2State:
        """Advance ``n_steps`` generations and return the new state, without
        waiting for the card (reading a field does)."""
        self.state = _k.nsga2_run(
            self.state, self.objective, n_steps, self.lb, self.ub,
            self.eta_c, self.eta_m, self.p_cross, self.p_mut,
            self.violation_fn)
        return self.state

    def igd(self, reference=None, k: int = 256) -> float:
        """Inverted generational distance (lower = better convergence and
        coverage) against ``reference`` ([R, M]) or, omitted, the analytic
        front of the named problem (zdt1, zdt2)."""
        if reference is None:
            try:
                reference = _k.MOO_FRONTS[self.problem_name](k, self.device)
            except KeyError:
                raise ValueError(
                    "no analytic front for this problem; pass an explicit "
                    "reference ([R, M] array)"
                ) from None
        ref = torch.as_tensor(reference, dtype=self.state.objs.dtype,
                              device=self.device)
        return float(_k.igd(self.state.objs, ref, self.state.viol))

    def pareto_front(self) -> np.ndarray:
        """[K, M] objective vectors of the current rank-0 individuals."""
        mask = self.state.rank.cpu().numpy() == 0
        return self.state.objs.cpu().numpy()[mask]

    def hypervolume(self, ref) -> float:
        """2-D hypervolume of the population against ``ref`` (infeasible
        individuals add no area)."""
        m = self.state.objs.shape[1]
        if m != 2:
            raise ValueError(
                f"hypervolume() supports 2 objectives, problem has {m}")
        return float(_k.hypervolume_2d(self.state.objs, ref,
                                       self.state.viol))
