from koordinator_tpu_torch.ops.scoring import (  # noqa: F401
    least_requested_score,
    most_requested_score,
    weighted_resource_score,
    least_allocated_scores,
    most_allocated_scores,
)
from koordinator_tpu_torch.ops.fit import fit_mask, nonzero_requests  # noqa: F401
from koordinator_tpu_torch.ops.loadaware import (  # noqa: F401
    loadaware_scores,
    loadaware_filter_mask,
    loadaware_node_masks,
    select_score_usage,
    usage_percent,
)
