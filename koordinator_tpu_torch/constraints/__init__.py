from koordinator_tpu_torch.constraints.quota import (  # noqa: F401
    QuotaGroup,
    refresh_runtime,
    build_quota_table_inputs,
)
from koordinator_tpu_torch.constraints.gang import gang_satisfaction  # noqa: F401
from koordinator_tpu_torch.constraints.quota_manager import (  # noqa: F401
    DEFAULT_QUOTA,
    GroupQuotaManager,
    MultiTreeQuotaManager,
    QuotaNode,
    ROOT_QUOTA,
    SYSTEM_QUOTA,
    ScaleMinQuota,
)
from koordinator_tpu_torch.constraints.gang_manager import (  # noqa: F401
    GANG_MODE_NONSTRICT,
    GANG_MODE_STRICT,
    Gang,
    PERMIT_SUCCESS,
    PERMIT_WAIT,
    PodGroupController,
    PodGroupManager,
)
from koordinator_tpu_torch.constraints.quota_enforce import (  # noqa: F401
    NodeVictims,
    QuotaOverUsedGroupMonitor,
    QuotaOverUsedRevokeController,
    can_preempt,
    pick_preemption_node,
    select_victims_on_node,
)
