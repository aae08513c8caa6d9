"""Descheduler: the LowNodeLoad rebalance leg of koord-descheduler
(reference ``pkg/descheduler``).

Modules
-------
- ``anomaly``     — node anomaly circuit breaker
                    (reference ``utils/anomaly/basic_detector.go``).
- ``sorter``      — multi-key pod/node ranking (reference ``utils/sorter``).
- ``evictions``   — eviction rate limiting + the evictor seam
                    (reference ``evictions/evictions.go``, ``eviction_limiter.go``).
- ``lownodeload`` — the LowNodeLoad Balance plugin: utilization
                    classification + eviction planning (reference
                    ``framework/plugins/loadaware/low_node_load.go``).

The migration controller, the runtime, the k8s plugins and the server are
not ported yet (ROADMAP Queue A item 15).
"""

from koordinator_tpu_torch.descheduler.anomaly import BasicDetector, State  # noqa: F401
from koordinator_tpu_torch.descheduler.lownodeload import (  # noqa: F401
    LowNodeLoadArgs,
    NodePool,
    balance,
)
