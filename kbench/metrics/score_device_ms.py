"""Score program: the card's span of a Score, in ms a Score: the stage row
``server.score.device``, a CUDA event pair from the start of the Score's
launch section to the end of its top-k, read after the Score's readback.
It holds the incremental rescore or the full one, whichever ran, and the
top-k, with the gaps between their kernels; ``rescore_device_ms`` holds
only the incremental rescore."""

ROW = "server.score.device"


def read(run):
    row = run["devprof"].get(ROW)
    scores = run["counts"]["scores"]
    if not row or not row["sampled"] or not scores:
        return None
    return row["device_us_total"] / 1e3 / scores
