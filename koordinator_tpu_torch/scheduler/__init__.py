"""Host-side scheduler layer.

Counterpart of ``koordinator_tpu/scheduler``: the plugin pipeline
(``framework.py``), the three extended plugins (``plugins.py``) and the
cpuset accumulator their Reserve runs (``cpu_accumulator.py``), the
topology hint manager (``topologymanager.py``), the reservation lifecycle
controller (``reservation_controller.py``) and the daemon (``server.py``).
"""

from koordinator_tpu_torch.scheduler.cpu_accumulator import (  # noqa: F401
    CPUAllocation,
    CPUBindPolicy,
    CPUExclusivePolicy,
    NUMAAllocateStrategy,
    take_cpus,
    take_preferred_cpus,
)
from koordinator_tpu_torch.scheduler.topologymanager import (  # noqa: F401
    NUMATopologyHint,
    NUMATopologyPolicy,
    merge_hints,
)
