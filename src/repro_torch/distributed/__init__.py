"""Distributed runtime of the port (twin of ``repro.distributed``):
checkpointing and fault tolerance.  The sharding rules and elastic
re-meshing wait for ROADMAP.md queue 1 item 10."""
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                flatten_pytree,
                                                unflatten_pytree)
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     SupervisorReport,
                                                     TrainSupervisor)

__all__ = [
    "CheckpointManager", "flatten_pytree", "unflatten_pytree",
    "HeartbeatMonitor", "TrainSupervisor", "SupervisorReport",
]
