"""distributed_swarm_algorithm_tpu_torch — the swarm framework on PyTorch
and CUDA for an NVIDIA H100.

A port of ``distributed_swarm_algorithm_tpu`` (JAX on a TPU), which stays
beside it as the reference every part of the port is tested against.  The
module layout follows the reference's, so each module here has one
counterpart there.  This package imports PyTorch and numpy, never JAX.

Ported so far: the whole-swarm protocol tick (``swarm_tick``,
``swarm_rollout``, ``VectorSwarm``) with dense, kernel ("pallas") or no
separation and greedy allocation.  The kernel is hand-written CUDA C++
(``csrc/separation.cu``), built with ``nvcc`` on first use.

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
from .ops.physics import apf_forces, formation_targets, physics_step

__version__ = "0.1.0"

__all__ = [
    "SwarmConfig", "DEFAULT_CONFIG", "SwarmState", "make_swarm", "with_tasks",
    "state_from_numpy", "state_to_numpy", "resolve_device",
    "TelemetryConfig", "TELEMETRY_ON", "TELEMETRY_OFF",
    "VectorSwarm", "swarm_tick", "swarm_rollout",
    "coordination_step", "instant_election", "current_leader", "kill",
    "revive",
    "allocation_step", "arbitrate", "utility_matrix", "task_status_view",
    "physics_step", "apf_forces", "formation_targets",
    "FOLLOWER", "ELECTION_WAIT", "LEADER",
    "TASK_OPEN", "TASK_TENTATIVE", "TASK_ASSIGNED", "TASK_LOCKED",
    "NO_LEADER", "NO_CAP", "NO_WINNER",
]
