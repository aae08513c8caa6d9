"""Score program: device ms of ``solver.incremental.rescore_dirty`` a Score,
from the launch ledger with every launch timed (CUDA events around each
outermost launch; an upper bound where the launch holds host gaps).  A
Score that ran a full rescore instead adds 0."""

BOUNDARY = "solver.incremental.rescore_dirty"


def read(run):
    row = run["devprof"].get(BOUNDARY)
    scores = run["counts"]["scores"]
    if not row or not row["sampled"] or not scores:
        return None
    return row["device_us_total"] / 1e3 / scores
