"""Host-side scheduler layer.

Counterpart of ``koordinator_tpu/scheduler``: the plugin pipeline
(``framework.py``), the three extended plugins (``plugins.py``) and the
cpuset accumulator their Reserve runs (``cpu_accumulator.py``).  The
topology hint manager and the daemon are not ported yet (ROADMAP Queue A
item 15).
"""

from koordinator_tpu_torch.scheduler.cpu_accumulator import (  # noqa: F401
    CPUAllocation,
    CPUBindPolicy,
    CPUExclusivePolicy,
    NUMAAllocateStrategy,
    take_cpus,
    take_preferred_cpus,
)
