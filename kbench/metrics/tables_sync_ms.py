"""Sync path: the quota and gang tables of a Sync, in ms a step: the
program's stage row ``server.sync.tables`` (``bridge/state.py``: the
decode of the ElasticQuota table, the PodGroups and the pods' memberships
inside ``server.sync.stage``, and their device update inside
``server.sync.commit``, one occurrence a Sync), host time on the
servicer's clock, over the window's steps.  None where the program has no
such row."""

ROW = "server.sync.tables"


def read(run):
    row = run["devprof"].get(ROW)
    steps = run["counts"]["scores"]
    if not row or not row["sampled"] or not steps:
        return None
    return row["device_us_total"] / 1e3 / steps
