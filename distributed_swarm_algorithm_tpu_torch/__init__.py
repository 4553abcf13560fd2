"""distributed_swarm_algorithm_tpu_torch — the swarm framework on PyTorch
and CUDA for an NVIDIA H100.

A port of ``distributed_swarm_algorithm_tpu`` (JAX on a TPU), which stays
beside it as the reference every part of the port is tested against.  The
module layout follows the reference's, so each module here has one
counterpart there.  This package imports PyTorch and numpy, never JAX.

Ported so far: the whole-swarm protocol tick (``swarm_tick``,
``swarm_rollout``, ``VectorSwarm``) with dense, all-pairs kernel
("pallas"), Morton-window kernel ("window"), spatial-hash ("grid"),
torus hashgrid ("hashgrid", with its shared plan and Verlet carry) or no
separation, greedy or auction allocation (``allocation_mode="auction"``:
Bertsekas' auction, ``ops/auction.py``, its bidding loop one hand-written
kernel on the card, ``csrc/auction.cu``, N2), and the commensurate moments
field's alignment and cohesion (``k_align`` / ``k_coh``,
``ops/grid_moments.py``).  The separation kernels are hand-written CUDA C++
(``csrc/separation.cu``, ``csrc/window_separation.cu``,
``csrc/grid_separation.cu``, ``csrc/candidate_sweep.cu``), built with
``nvcc`` on first use.  Also ported: the PSO family (``PSO``,
``MemeticPSO``, the island model of ``parallel/islands.py``) with the fused
step kernels of ``csrc/pso_fused.cu`` for one swarm and for islands, and
the bat, grey wolf, salp and whale optimizers (``Bat``, ``GWO``, ``Salp``,
``WOA``) with their fused kernels (``csrc/bat_fused.cu``,
``csrc/gwo_fused.cu``, ``csrc/salp_fused.cu``, ``csrc/woa_fused.cu``), and
differential evolution, SHADE, the genetic algorithm and moth-flame
optimization (``DE``, ``SHADE``, ``GA``, ``MFO``) with theirs
(``csrc/de_fused.cu``, ``csrc/shade_fused.cu``, ``csrc/ga_fused.cu``,
``csrc/mfo_fused.cu``), and cuckoo search, Harris hawks, the artificial bee
colony and parallel tempering (``Cuckoo``, ``HarrisHawks``, ``ABC``,
``ParallelTempering``) with theirs (``csrc/cuckoo_fused.cu``,
``csrc/hho_fused.cu``, ``csrc/abc_fused.cu``,
``csrc/tempering_fused.cu``), and the firefly algorithm and ant-colony
TSP (``Firefly``, ``ACO``) with theirs (``csrc/firefly_fused.cu``,
``csrc/aco_fused.cu``).  And the four families the JAX package runs with
no kernel of its own: NSGA-II (``NSGA2``), whose non-dominated ranks run on
the card in one hand-written CUDA kernel (``csrc/nsga2_ranks.cu``, N1),
CMA-ES (``CMAES``), OpenAI-ES (``ES``) and MAP-Elites (``MAPElites``), in
plain PyTorch.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

from .state import (
    ELECTION_WAIT,
    FOLLOWER,
    LEADER,
    NO_CAP,
    NO_LEADER,
    NO_WINNER,
    TASK_ASSIGNED,
    TASK_LOCKED,
    TASK_OPEN,
    TASK_TENTATIVE,
    SwarmState,
    make_swarm,
    state_from_numpy,
    state_to_numpy,
    with_tasks,
)
from .utils.config import (
    DEFAULT_CONFIG,
    TELEMETRY_OFF,
    TELEMETRY_ON,
    SwarmConfig,
    TelemetryConfig,
)
from .utils.platform import resolve_device
from .models.swarm import VectorSwarm, swarm_rollout, swarm_tick
from .models.pso import PSO
from .models.memetic import MemeticPSO
from .models.bat import Bat
from .models.gwo import GWO
from .models.salp import Salp
from .models.woa import WOA
from .models.de import DE
from .models.shade import SHADE
from .models.ga import GA
from .models.mfo import MFO
from .models.cuckoo import Cuckoo
from .models.hho import HarrisHawks
from .models.abc_bees import ABC
from .models.tempering import ParallelTempering
from .models.firefly import Firefly
from .models.aco import ACO
from .models.nsga2 import NSGA2
from .models.es import ES
from .models.map_elites import MAPElites
from .models.cmaes import CMAES
from .ops.firefly import (
    FireflyState,
    firefly_init,
    firefly_run,
    firefly_state_from_numpy,
    firefly_state_to_numpy,
    firefly_step,
)
from .ops.aco import (
    ACOState,
    aco_init,
    aco_run,
    aco_state_from_numpy,
    aco_state_to_numpy,
    aco_step,
    construct_tours,
    coords_to_dist,
    deposit,
    tour_lengths,
)
from .ops.bat import (
    BatState,
    bat_init,
    bat_run,
    bat_state_from_numpy,
    bat_state_to_numpy,
    bat_step,
)
from .ops.gwo import (
    GWOState,
    gwo_init,
    gwo_run,
    gwo_state_from_numpy,
    gwo_state_to_numpy,
    gwo_step,
)
from .ops.salp import (
    SalpState,
    salp_init,
    salp_run,
    salp_state_from_numpy,
    salp_state_to_numpy,
    salp_step,
)
from .ops.woa import (
    WOAState,
    woa_init,
    woa_run,
    woa_state_from_numpy,
    woa_state_to_numpy,
    woa_step,
)
from .ops.de import (
    DEState,
    de_init,
    de_run,
    de_state_from_numpy,
    de_state_to_numpy,
    de_step,
)
from .ops.shade import (
    SHADEState,
    shade_init,
    shade_run,
    shade_state_from_numpy,
    shade_state_to_numpy,
    shade_step,
)
from .ops.ga import (
    GAState,
    ga_init,
    ga_run,
    ga_state_from_numpy,
    ga_state_to_numpy,
    ga_step,
)
from .ops.mfo import (
    MFOState,
    mfo_init,
    mfo_run,
    mfo_state_from_numpy,
    mfo_state_to_numpy,
    mfo_step,
)
from .ops.cuckoo import (
    CuckooState,
    cuckoo_init,
    cuckoo_run,
    cuckoo_state_from_numpy,
    cuckoo_state_to_numpy,
    cuckoo_step,
)
from .ops.hho import (
    HHOState,
    hho_init,
    hho_run,
    hho_state_from_numpy,
    hho_state_to_numpy,
    hho_step,
)
from .ops.abc import (
    ABCState,
    abc_init,
    abc_run,
    abc_state_from_numpy,
    abc_state_to_numpy,
    abc_step,
)
from .ops.tempering import (
    PTState,
    pt_init,
    pt_run,
    pt_state_from_numpy,
    pt_state_to_numpy,
    pt_step,
)
from .ops.nsga2 import (
    NSGA2State,
    nsga2_init,
    nsga2_run,
    nsga2_state_from_numpy,
    nsga2_state_to_numpy,
    nsga2_step,
)
from .ops.es import ESState, es_init, es_run, es_step
from .ops.map_elites import MapElitesState, me_init, me_run, me_step
from .ops.cmaes import (
    CMAESParams,
    CMAESState,
    cmaes_init,
    cmaes_params,
    cmaes_run,
    cmaes_step,
)
from .ops.cuda.bat_fused import fused_bat_run
from .ops.cuda.gwo_fused import fused_gwo_run
from .ops.cuda.salp_fused import fused_salp_run
from .ops.cuda.woa_fused import fused_woa_run
from .ops.cuda.de_fused import fused_de_run
from .ops.cuda.shade_fused import fused_shade_run
from .ops.cuda.ga_fused import fused_ga_run
from .ops.cuda.mfo_fused import fused_mfo_run
from .ops.cuda.cuckoo_fused import fused_cuckoo_run
from .ops.cuda.hho_fused import fused_hho_run
from .ops.cuda.abc_fused import fused_abc_run
from .ops.cuda.tempering_fused import fused_pt_run
from .ops.cuda.firefly_fused import fused_firefly_run
from .ops.cuda.aco_fused import fused_aco_run
from .ops import objectives
from .ops.cuda.pso_fused import fused_pso_run
from .ops.memetic import gd_refine, memetic_run, refine_pbest
from .ops.pso import (
    PSOState,
    pso_init,
    pso_run,
    pso_state_from_numpy,
    pso_state_to_numpy,
    pso_step,
)
from .ops.topology import neighbor_best, ring_best, von_neumann_best
from .ops.allocation import (
    allocation_step,
    arbitrate,
    task_status_view,
    utility_matrix,
)
from .ops.coordination import (
    coordination_step,
    current_leader,
    instant_election,
    kill,
    revive,
)
from .ops.hashgrid_plan import (
    HashgridPlan,
    build_hashgrid_plan,
    plan_from_numpy,
    plan_to_numpy,
    refresh_plan,
    refresh_plan_partial,
)
from .ops.physics import (
    apf_forces,
    build_tick_plan,
    formation_targets,
    physics_step,
    physics_step_plan,
)

__version__ = "0.1.0"

__all__ = [
    "SwarmConfig", "DEFAULT_CONFIG", "SwarmState", "make_swarm", "with_tasks",
    "state_from_numpy", "state_to_numpy", "resolve_device",
    "TelemetryConfig", "TELEMETRY_ON", "TELEMETRY_OFF",
    "VectorSwarm", "swarm_tick", "swarm_rollout",
    "coordination_step", "instant_election", "current_leader", "kill",
    "revive",
    "allocation_step", "arbitrate", "utility_matrix", "task_status_view",
    "physics_step", "physics_step_plan", "apf_forces", "formation_targets",
    "build_tick_plan", "HashgridPlan", "build_hashgrid_plan",
    "refresh_plan", "refresh_plan_partial", "plan_to_numpy",
    "plan_from_numpy",
    "PSO", "PSOState", "pso_init", "pso_step", "pso_run", "fused_pso_run",
    "pso_state_from_numpy", "pso_state_to_numpy",
    "MemeticPSO", "memetic_run", "refine_pbest", "gd_refine",
    "Bat", "BatState", "bat_init", "bat_step", "bat_run", "fused_bat_run",
    "bat_state_from_numpy", "bat_state_to_numpy",
    "GWO", "GWOState", "gwo_init", "gwo_step", "gwo_run", "fused_gwo_run",
    "gwo_state_from_numpy", "gwo_state_to_numpy",
    "Salp", "SalpState", "salp_init", "salp_step", "salp_run",
    "fused_salp_run", "salp_state_from_numpy", "salp_state_to_numpy",
    "WOA", "WOAState", "woa_init", "woa_step", "woa_run", "fused_woa_run",
    "woa_state_from_numpy", "woa_state_to_numpy",
    "DE", "DEState", "de_init", "de_step", "de_run", "fused_de_run",
    "de_state_from_numpy", "de_state_to_numpy",
    "SHADE", "SHADEState", "shade_init", "shade_step", "shade_run",
    "fused_shade_run", "shade_state_from_numpy", "shade_state_to_numpy",
    "GA", "GAState", "ga_init", "ga_step", "ga_run", "fused_ga_run",
    "ga_state_from_numpy", "ga_state_to_numpy",
    "MFO", "MFOState", "mfo_init", "mfo_step", "mfo_run", "fused_mfo_run",
    "mfo_state_from_numpy", "mfo_state_to_numpy",
    "Cuckoo", "CuckooState", "cuckoo_init", "cuckoo_step", "cuckoo_run",
    "fused_cuckoo_run", "cuckoo_state_from_numpy", "cuckoo_state_to_numpy",
    "HarrisHawks", "HHOState", "hho_init", "hho_step", "hho_run",
    "fused_hho_run", "hho_state_from_numpy", "hho_state_to_numpy",
    "ABC", "ABCState", "abc_init", "abc_step", "abc_run", "fused_abc_run",
    "abc_state_from_numpy", "abc_state_to_numpy",
    "ParallelTempering", "PTState", "pt_init", "pt_step", "pt_run",
    "fused_pt_run", "pt_state_from_numpy", "pt_state_to_numpy",
    "Firefly", "FireflyState", "firefly_init", "firefly_step", "firefly_run",
    "fused_firefly_run", "firefly_state_from_numpy", "firefly_state_to_numpy",
    "ACO", "ACOState", "aco_init", "aco_step", "aco_run", "fused_aco_run",
    "construct_tours", "deposit", "tour_lengths", "coords_to_dist",
    "aco_state_from_numpy", "aco_state_to_numpy",
    "NSGA2", "NSGA2State", "nsga2_init", "nsga2_step", "nsga2_run",
    "nsga2_state_from_numpy", "nsga2_state_to_numpy",
    "ES", "ESState", "es_init", "es_step", "es_run",
    "MAPElites", "MapElitesState", "me_init", "me_step", "me_run",
    "CMAES", "CMAESState", "CMAESParams", "cmaes_params", "cmaes_init",
    "cmaes_step", "cmaes_run",
    "neighbor_best", "ring_best", "von_neumann_best", "objectives",
    "FOLLOWER", "ELECTION_WAIT", "LEADER",
    "TASK_OPEN", "TASK_TENTATIVE", "TASK_ASSIGNED", "TASK_LOCKED",
    "NO_LEADER", "NO_CAP", "NO_WINNER",
]
