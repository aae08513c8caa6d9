"""Transport: the servicer's framing a step, in ms: the program's stage
rows ``server.<rpc>.recv``, ``decode``, ``encode`` and ``send`` of the
Sync, the Score and the Assign (``bridge/udsserver.py``: the payload's
read after its header arrived, the request's decode, the reply's encode
and its send), summed and divided by the Scores of the window.  Host time
on the servicer's clock; none of these stages holds a launch."""

RPCS = ("sync", "score", "assign")
STAGES = ("recv", "decode", "encode", "send")


def read(run):
    rows = [run["devprof"].get(f"server.{rpc}.{stage}") for rpc in RPCS for stage in STAGES]
    scores = run["counts"]["scores"]
    if not scores or any(not row or not row["sampled"] for row in rows):
        return None
    return sum(row["device_us_total"] for row in rows) / 1e3 / scores
