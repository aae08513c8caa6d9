"""Descheduler analog of koord-descheduler (reference ``pkg/descheduler``).

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
- ``migration``   — PodMigrationJob controller state machine + arbitration
                    (reference ``controllers/migration``).
- ``k8s_plugins`` — the upstream deschedule plugins the runtime registers
                    (reference ``framework/plugins/kubernetes``).
- ``runtime``     — profiles, the plugin framework and the ticking loop
                    (reference ``framework/runtime``, ``descheduler.go``).
- ``server``      — the leader-elected koord-descheduler daemon
                    (reference ``cmd/koord-descheduler/app/server.go``).
"""

from koordinator_tpu_torch.descheduler.anomaly import BasicDetector, State  # noqa: F401
from koordinator_tpu_torch.descheduler.lownodeload import (  # noqa: F401
    LowNodeLoadArgs,
    NodePool,
    balance,
)
