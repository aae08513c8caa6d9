"""The program under test in a process of its own.

    python -m kbench.serve --sock <path> --cycle '<json>' --device cuda [--traced]

A ``ScorerServicer`` on the device behind ``bridge/udsserver.py
RawUdsServer`` on the unix socket ``--sock``, as the backend daemon serves
the Go plugin.  The harness (``kbench/run.py``) starts it, drives it over
the socket with the program's client, and steers it with one JSON object a
line on its standard input; each gets one JSON line back on the process's
original standard output (everything else this process prints goes to
standard error):

* ``{"op": "mark"}``: remember the launch ledger's totals (the window opens);
* ``{"op": "trace_start"}`` / ``{"op": "trace_stop"}``: the profiler window;
* ``{"op": "finish"}``: stop serving and answer the device's name, its
  memory peak, the launch ledger's deltas since the mark, and the profiler
  window's digest; then exit.

With ``--traced`` every launch is timed in the launch ledger and each RPC
the servicer handles is noted as a ``kbench.sync`` / ``kbench.score`` /
``kbench.assign`` span of the profiler window (``kbench/devtrace.py``).
"""

from __future__ import annotations

import os

from kbench import threads

threads.fix()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402


# the keys of a traffic file's ``cycle`` block that the program is given
CYCLE_KEYS = ("wave", "top_m", "terms", "packing_headroom")


def cycle_config(cycle: dict):
    """The program's ``CycleConfig`` for a traffic file's ``cycle`` block,
    every key of it, with the weights the reference's ``Semantics`` states:
    ``terms`` turns on the heterogeneity, sensitivity and packing terms at
    weight 1 (packing weights cpu 1 memory 1), ``packing_headroom`` (a
    resource's most utilisation, in %) their packing mask.  A key it cannot
    map raises, so that no key scores one thing in the reference and
    another in the program."""
    import dataclasses

    from koordinator_tpu_torch.config import (
        CycleConfig,
        HeterogeneityTermArgs,
        PackingTermArgs,
        SensitivityTermArgs,
    )

    unknown = sorted(set(cycle) - set(CYCLE_KEYS))
    if unknown:
        raise ValueError(f"the cycle block's {unknown} has no mapping to the program's "
                         f"CycleConfig; it maps {list(CYCLE_KEYS)}")
    terms = bool(cycle.get("terms", False))
    headroom = {name: int(v) for name, v in dict(cycle.get("packing_headroom", {})).items()}
    if headroom and not terms:
        raise ValueError("packing_headroom is the packing term's mask: it needs terms true")
    cfg = dataclasses.replace(CycleConfig(), wave=int(cycle.get("wave", 1)),
                              top_m=int(cycle.get("top_m", 4)))
    if terms:
        cfg = dataclasses.replace(
            cfg, heterogeneity=HeterogeneityTermArgs(weight=1),
            sensitivity=SensitivityTermArgs(weight=1),
            packing=PackingTermArgs(weight=1, resource_weights={"cpu": 1, "memory": 1},
                                    headroom=headroom))
    return cfg


def devprof_totals() -> dict:
    from koordinator_tpu_torch.obs import devprof

    return {name: {"launches": b["launches"], "sampled": b["sampled"],
                   "device_us_total": b["device_us_total"]}
            for name, b in devprof.summary()["boundaries"].items()}


def _delta(after: dict, before: dict) -> dict:
    zero = {"launches": 0, "sampled": 0, "device_us_total": 0.0}
    return {name: {k: v - before.get(name, zero)[k] for k, v in row.items()}
            for name, row in after.items()}


def _noted(fn, name, window):
    """``fn`` with each call noted as a host span of the profiler window."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        start = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            window.note(name, start, time.time_ns())
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kbench.serve")
    ap.add_argument("--sock", required=True)
    ap.add_argument("--cycle", required=True, help="the traffic file's cycle block, as JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traced", action="store_true")
    args = ap.parse_args(argv)
    # the protocol keeps the original standard output; stray prints go to stderr
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    # a cycle block the program cannot take ends the process before it serves
    cfg = cycle_config(json.loads(args.cycle))

    import torch

    threads.fix_torch()
    from kbench import devtrace
    from kbench.run import forbidden_modules
    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.udsserver import RawUdsServer

    on_card = args.device.startswith("cuda")
    servicer = ScorerServicer(cfg=cfg, device=args.device,
                              devprof_sample=1 if args.traced else None)
    trace_dir = tempfile.mkdtemp(prefix="kbs-")
    window = devtrace.Window(trace_dir, on_card) if args.traced else None
    if args.traced:
        for method in ("sync", "score", "assign"):
            setattr(servicer, method, _noted(getattr(servicer, method), f"kbench.{method}", window))
    server = RawUdsServer(args.sock, servicer=servicer).start()
    ledger_before: dict = {}
    opened = closed = False

    def answer(doc) -> None:
        proto.write(json.dumps(doc) + "\n")

    answer({"ready": True})
    try:
        for line in sys.stdin:
            op = json.loads(line)["op"]
            if op == "mark":
                ledger_before = devprof_totals() if args.traced else {}
                answer({})
            elif op == "trace_start":
                window.start()
                opened = True
                answer({})
            elif op == "trace_stop":
                window.stop()
                closed = True
                answer({})
            elif op == "finish":
                if opened and not closed:
                    window.stop()
                    closed = True
                server.stop()
                if on_card:
                    torch.cuda.synchronize()
                doc = {
                    "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                    "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0,
                    "devprof": _delta(devprof_totals(), ledger_before) if args.traced else {},
                    "profile": window.digest() if closed else None,
                    "forbidden": forbidden_modules(),
                }
                servicer.telemetry.close()
                answer(doc)
                return 0
            else:
                answer({"error": f"unknown op {op!r}"})
    finally:
        try:
            os.rmdir(trace_dir)
        except OSError:
            pass
    return 1


if __name__ == "__main__":
    sys.exit(main())
