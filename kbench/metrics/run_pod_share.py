"""Assign path: the share of the pending pods that the per-pod cycle
kernel placed on its run path, in %: a pod whose rows equal the previous
pod's, in a run of three or more, reuses that pod's scores and is placed
with no cluster barrier.  The program's counter rows
``server.assign.count.<name>`` (``bridge/server.py``), the window's
``run_pods`` over its pending pods (``placed`` + ``unschedulable`` +
``wait_gang``), every Assign counting its own.  None where the program has
no such counter."""

RUNS = "server.assign.count.run_pods"
PENDING = tuple(f"server.assign.count.{name}" for name in ("placed", "unschedulable", "wait_gang"))


def read(run):
    rows = [run["devprof"].get(name) for name in (RUNS,) + PENDING]
    if any(not row or not row["sampled"] for row in rows):
        return None
    # a counter row's device_us_total holds its summed counts
    pending = sum(row["device_us_total"] for row in rows[1:])
    if not pending:
        return None
    return 100.0 * rows[0]["device_us_total"] / pending
