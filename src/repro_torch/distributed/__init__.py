"""Distributed runtime of the port (twin of ``repro.distributed``): the
single-controller device mesh and the LM sharding rules,
checkpointing, fault tolerance and elastic re-meshing."""
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                flatten_pytree,
                                                unflatten_pytree)
from repro_torch.distributed.elastic import (make_elastic_mesh,
                                             plan_mesh_shape, reshard_state)
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     SupervisorReport,
                                                     TrainSupervisor)
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec, ShardedTensor,
                                              batch_shardings,
                                              cache_shardings,
                                              make_mesh_auto,
                                              param_shardings, replicated)

__all__ = [
    "batch_shardings", "cache_shardings", "param_shardings", "replicated",
    "Mesh", "NamedSharding", "PartitionSpec", "ShardedTensor",
    "make_mesh_auto",
    "CheckpointManager", "flatten_pytree", "unflatten_pytree",
    "HeartbeatMonitor", "TrainSupervisor", "SupervisorReport",
    "make_elastic_mesh", "plan_mesh_shape", "reshard_state",
]
