"""Assign path: the host time around the cycle kernel, in ms an Assign:
the stage rows ``server.assign.prepare`` (the kernel's inputs,
``solver/wide.py prepare_wide_inputs``), ``server.assign.finish`` (the
result from the kernel's outputs, ``finish_cycle``) and
``server.assign.reply_build`` (the reply's arrays), over the Assigns of
the window.  None of the three holds a launch boundary, so a traced run's
synchronise after each timed launch is not in them: the kernel's launch
and its wait are ``server.assign.kernel`` and ``kernel_wait``, which this
metric leaves out."""

ROWS = ("server.assign.prepare", "server.assign.finish", "server.assign.reply_build")


def read(run):
    rows = [run["devprof"].get(name) for name in ROWS]
    assigns = run["counts"]["assigns"]
    if not assigns or any(not row or not row["sampled"] for row in rows):
        return None
    return sum(row["device_us_total"] for row in rows) / 1e3 / assigns
