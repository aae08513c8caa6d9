from koordinator_tpu_torch.model.resources import (  # noqa: F401
    RESOURCE_AXIS,
    RESOURCE_INDEX,
    NUM_RESOURCES,
    parse_quantity,
    resource_vector,
    weights_vector,
)
from koordinator_tpu_torch.model.snapshot import (  # noqa: F401
    ClusterSnapshot,
    NodeBatch,
    PodBatch,
    GangTable,
    QuotaTable,
    PriorityClass,
    QoSClass,
    encode_snapshot,
    pad_bucket,
    snapshot_from_numpy,
)
