"""Warm-path guards of the port (``retrace_guard.py``), exported as the
reference's ``koordinator_tpu.analysis`` exports them."""

from koordinator_tpu_torch.analysis.retrace_guard import (  # noqa: F401
    RetraceBudgetExceeded,
    retrace_guard,
)
