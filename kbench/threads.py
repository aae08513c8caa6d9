"""The thread counts of the benchmark's processes, fixed before numpy and
torch load: one client loop and one servicer, each on few threads, so that
a run's host time does not hang on how the machine schedules a pool."""

from __future__ import annotations

import os

POOL_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
             "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")
THREADS = 1


def fix() -> None:
    """Set the numeric libraries' pools, before they are imported (the
    servicer's process inherits them)."""
    for name in POOL_VARS:
        os.environ[name] = str(THREADS)
    # the program's client must not pull JAX in through transformers
    os.environ.setdefault("USE_FLAX", "0")


def fix_torch() -> None:
    """torch's own intra-op and inter-op pools."""
    import torch

    torch.set_num_threads(THREADS)
    try:
        torch.set_num_interop_threads(THREADS)
    except RuntimeError:  # already fixed, or inter-op work already ran
        pass
