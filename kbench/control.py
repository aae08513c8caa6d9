"""The control of the comparison that decides ``correct``.

    python3 -m kbench.control --workload <cell> --seeds 11,12,13 [--device cuda]

The reference computed in a lower precision than the int64 the scheduler
states (every division ``floor(a / b)``) is put in the program's place: for
each seed it builds the cell's cluster, runs ``--warm`` cycles of the bind
loop on the exact reference's placements (the window's stationary state),
then ``--steps`` cycles whose Score and Assign come from the lower
precision, binds its placements as the loop binds the program's, and
compares its replies with the exact reference's by the run's own comparison
(``kbench/run.py compare``).  float32, the first step below, is exact on
these magnitudes and reads 0 (it is not a fault here); bfloat16, the next,
must be rejected on every seed.  The reference has no wave: one control
serves every cell of a configuration.  No run of the benchmark runs the
control.  It imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kbench import manifest
from kbench.run import compare


def control_readings(cell: manifest.Cell, seed: int, steps: int, warm: int, device: str,
                     precision: str) -> dict:
    """The comparison's numbers over ``steps`` cycles with the reference in
    ``precision`` in the program's place."""
    t = cell.traffic
    cycle, k = t["cycle"], int(t["top_k"])
    gen, reference = cell.generator, cell.reference
    model = gen.build(cell.config, seed)
    loop = gen.BindLoop(model, t["lifetime_steps"], seed)
    for _ in range(warm):
        model = loop.after_assign(model, *reference.assign_reply(model, cycle, device=device))
    totals = {"score": 0, "assign": 0}
    for _ in range(steps):
        score = reference.score_reply(model, cycle, k, precision=precision, device=device)
        assign = reference.assign_reply(model, cycle, precision=precision, device=device)
        for key, v in compare(score, assign, model, cell, device).items():
            totals[key] += v
        model = loop.after_assign(model, *assign)
    return {"seed": seed, "precision": precision, "steps_compared": steps,
            "score_mismatched_pods": totals["score"],
            "assign_mismatched_slots": totals["assign"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--steps", type=int, default=0,
                    help="cycles compared (default: the cell's check_steps)")
    ap.add_argument("--warm", type=int, default=3,
                    help="cycles of the exact reference first (3 reach the stationary state)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--precision", default="float32,bfloat16",
                    help="comma-separated control precisions")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    steps = args.steps or int(cell.traffic["check_steps"])
    for precision in args.precision.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            doc = control_readings(cell, seed, steps, args.warm, args.device, precision)
            doc["workload"], doc["seconds"] = cell.name, time.perf_counter() - t0
            print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
