from koordinator_tpu_torch.constraints.quota import (  # noqa: F401
    QuotaGroup,
    refresh_runtime,
    build_quota_table_inputs,
)
from koordinator_tpu_torch.constraints.gang import gang_satisfaction  # noqa: F401
