"""Central control-plane analog of koord-manager (reference
``pkg/slo-controller``, ``pkg/webhook``, ``pkg/quota-controller``).

The port's own copy of ``koordinator_tpu/manager/__init__.py``.

Pure, host-side reconciliation math: the durable state lives in the cluster
store (plain dict objects), mirroring how the
reference keeps all controller state in apiserver CRs.

Modules
-------
- ``sloconfig``     — colocation/SLO strategy parse, merge, validate
                      (reference ``pkg/util/sloconfig``).
- ``noderesource``  — Batch/Mid overcommit calculator
                      (reference ``pkg/slo-controller/noderesource``).
- ``nodeslo``       — per-node NodeSLO spec rendering
                      (reference ``pkg/slo-controller/nodeslo``).
- ``nodemetric``    — NodeMetric CR lifecycle + collect policy
                      (reference ``pkg/slo-controller/nodemetric``).
- ``profile``       — ClusterColocationProfile pod mutation (the mutating
                      webhook, reference
                      ``pkg/webhook/pod/mutating/cluster_colocation_profile.go``).
- ``quota_profile`` — ElasticQuotaProfile -> quota-tree reconciler
                      (reference ``pkg/quota-controller/profile``).
"""

from koordinator_tpu_torch.manager.sloconfig import (  # noqa: F401
    ColocationStrategy,
    default_colocation_strategy,
    is_strategy_valid,
    merge_node_strategy,
)
from koordinator_tpu_torch.manager.noderesource import (  # noqa: F401
    BatchResourceResult,
    calculate_batch_resource,
    calculate_mid_resource,
    need_sync,
)
