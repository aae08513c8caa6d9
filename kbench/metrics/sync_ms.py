"""Sync path: the mean client wall of a step's Sync call, in ms (the
benchmark's own timer around ``ScorerClient.sync``: delta encode, the
framing, ``ResidentState`` staging and commit, the reply)."""

from kbench.stats import mean


def read(run):
    return mean([s["sync_ms"] for s in run["steps"] if s["error"] is None])
