"""Assign path: the gang post-pass, in ms an Assign: the program's stage
row ``server.assign.gang`` (``solver/greedy.py finish_cycle``: the
Coscheduling gate over the cycle's placements, inside
``server.assign.finish``), host time on the servicer's clock over the
window's Assigns.  None where the program has no such row."""

ROW = "server.assign.gang"


def read(run):
    row = run["devprof"].get(ROW)
    assigns = run["counts"]["assigns"]
    if not row or not row["sampled"] or not assigns:
        return None
    return row["device_us_total"] / 1e3 / assigns
