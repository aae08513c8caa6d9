"""Score program: the program's time building a Score reply, in ms a
Score: the stage row ``server.score.reply_build`` (the reply's flat
arrays from the top-k readback, the time ``build_ms`` puts on the wire),
over the Scores of the window.  Host time; it holds no launch."""

ROW = "server.score.reply_build"


def read(run):
    row = run["devprof"].get(ROW)
    scores = run["counts"]["scores"]
    if not row or not row["sampled"] or not scores:
        return None
    return row["device_us_total"] / 1e3 / scores
