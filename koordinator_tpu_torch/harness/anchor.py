"""A fixed digest that ties the port's cycle to the reference's placements.

``ANCHOR_SHA256`` is the digest of the reference ``greedy_assign``'s
assignment and status on the quota_colocation recipe at ``ANCHOR_RECIPE``,
with the default cycle config.  ``chip_smoke.py`` checks the port's CUDA
cycle against it on the card, where the reference cannot run, and a CPU
test (``tests/test_torch_cycle.py``) recomputes it from the reference, so
the constant cannot drift.

The wave-batched cycle places pods exactly as the per-pod one, so its
digest at ``WAVE_ANCHOR_CFG`` is ``ANCHOR_SHA256`` too; ``WAVE_ANCHOR_ROUNDS``
is the reference wave kernel's round count there, recomputed by the same
test from the JAX kernel in interpret mode.
"""

from __future__ import annotations

import hashlib

import numpy as np

ANCHOR_RECIPE = {"seed": 0, "pods": 2000, "nodes": 400, "tenants": 16}
ANCHOR_SHA256 = "82d0f61872bb822febac6eb755ecff803608bbdb344cbc863c8a7a43327208ce"
WAVE_ANCHOR_CFG = {"wave": 32, "top_m": 4}
WAVE_ANCHOR_ROUNDS = 157


def cycle_digest(assignment, status) -> str:
    """sha256 over the little-endian int32 bytes of assignment, then status.
    Takes numpy arrays or CPU tensors."""
    h = hashlib.sha256()
    for a in (assignment, status):
        h.update(np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes())
    return h.hexdigest()
