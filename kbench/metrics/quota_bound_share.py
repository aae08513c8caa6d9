"""Assign path: the share of the pending pods that an Assign leaves
unschedulable because their ElasticQuota group is full, in %: the program's
counter rows ``server.assign.count.<name>`` (``bridge/server.py``), the
window's ``quota_bound`` over its pending pods (``placed`` +
``unschedulable`` + ``wait_gang``), every Assign counting its own.  A
control: a change that keeps the scheduler's semantics cannot move it.
None where the program has no such counters."""

BOUND = "server.assign.count.quota_bound"
PENDING = tuple(f"server.assign.count.{name}" for name in ("placed", "unschedulable", "wait_gang"))


def read(run):
    rows = [run["devprof"].get(name) for name in (BOUND,) + PENDING]
    if any(not row or not row["sampled"] for row in rows):
        return None
    # a counter row's device_us_total holds its summed counts
    pending = sum(row["device_us_total"] for row in rows[1:])
    if not pending:
        return None
    return 100.0 * rows[0]["device_us_total"] / pending
