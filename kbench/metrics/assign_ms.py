"""Assign path: the mean client wall of a step's Assign call, in ms
(``run_cycle``: the term extras, the kernel, ``finish_cycle``, the reply)."""

from kbench.stats import mean


def read(run):
    return mean([s["assign_ms"] for s in run["steps"]
                 if s["error"] is None and s["assign_ms"] is not None])
