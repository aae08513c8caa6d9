"""Device: the share of the profiler window, in %, in which no kernel,
memcpy or memset ran on the card.  The window opens after warm-up, inside
the measured window."""


def read(run):
    prof = run["profile"]
    if prof is None or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return (1 - prof["busy_s"] / prof["window_s"]) * 100
