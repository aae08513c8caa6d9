"""Score program: the mean client wall of a step's Score call, in ms
(incremental or full rescore, the top-k, the reply's build and decode)."""

from kbench.stats import mean


def read(run):
    return mean([s["score_ms"] for s in run["steps"] if s["error"] is None])
