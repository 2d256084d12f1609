"""Distributed runtime of the port (twin of ``repro.distributed``): the
single-controller device mesh, checkpointing, fault tolerance and
elastic re-meshing.  The LM parameter, cache and batch sharding rules
and ``reshard_state`` come with LM sharding (ROADMAP item 23)."""
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                flatten_pytree,
                                                unflatten_pytree)
from repro_torch.distributed.elastic import (make_elastic_mesh,
                                             plan_mesh_shape)
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     SupervisorReport,
                                                     TrainSupervisor)
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              make_mesh_auto, replicated)

__all__ = [
    "replicated", "Mesh", "NamedSharding", "make_mesh_auto",
    "CheckpointManager", "flatten_pytree", "unflatten_pytree",
    "HeartbeatMonitor", "TrainSupervisor", "SupervisorReport",
    "make_elastic_mesh", "plan_mesh_shape",
]
