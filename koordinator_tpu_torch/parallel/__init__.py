"""The multi-device path: the in-process mesh, the placement of the
snapshot on it, and the sharded greedy assignment.  Counterpart of
``koordinator_tpu/parallel/``."""

from koordinator_tpu_torch.parallel.mesh import (  # noqa: F401
    CLUSTER_AXIS,
    POD_AXIS,
    Mesh,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    cluster_mesh,
    make_mesh,
    node_sharding,
    pod_mesh,
    pow2_device_count,
    replicated_sharding,
    score_sharding,
    shard_cluster_snapshot,
    shard_map,
    shard_snapshot_for_assign,
    shard_snapshot_for_scoring,
    snapshot_partition_specs,
    snapshot_shardings,
    visible_devices,
)
from koordinator_tpu_torch.parallel.shard_assign import (  # noqa: F401
    greedy_assign_sharded,
    greedy_assign_waves,
)
