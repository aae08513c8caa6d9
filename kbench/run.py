"""The benchmark of ``koordinator_tpu_torch``: one run of one cell.

    python3 -m kbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run drives the served path as the Go plugin does: ``bridge/client.py
ScorerClient`` over the raw unix-socket framing to a ``ScorerServicer`` on
the card, which ``kbench/serve.py`` runs in a process of its own behind
``bridge/udsserver.py RawUdsServer``.  One step is a ``sync`` of what
changed, ``score_flat(top_k)`` and ``assign``; the client waits for each
reply (one closed loop, as the scheduler).  After each Assign the harness
binds the placed pods and deletes the batch whose time is up (the
``BindLoop`` of the generator the configuration names, by default
``kbench/gen/cluster.py``); that work is timed apart and is not the
program's.  Set-up starts the servicer, makes the cluster from the seed,
ships the cold Sync and runs ``warmup_steps`` untimed steps; the window
then runs steps for ``--seconds``.  After it, a sample of the window's
replies (drawn from the seed, with the last step in it) is compared with
the plain reference the configuration names (``reference``), and the last line
of standard output is the result.  ``--trace 1`` adds a profiler window
inside the measured window and the launch ledger's device times, and
reports the cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import time

_IMPORTED_AT = time.time()

from kbench import threads  # noqa: E402

threads.fix()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from kbench import devtrace, manifest, roofline, stats  # noqa: E402

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "koordinator_tpu")
# the module that serves the program in its own process
SERVE_MODULE = "kbench.serve"
K2_KERNEL = "cycle_kernel<int>"
K3_KERNEL = "wave_cycle_kernel"
# a step slower than this failed: the reference's trace SLO (default_slo_specs)
STEP_LIMIT_MS = 2500.0
# an RPC that takes longer raises; a window with this many failed RPCs ends
RPC_TIMEOUT_MS = 60_000.0
MAX_ERRORS = 20
# the servicer's process: how long it may take to come up (the first run in
# a checkout builds nothing before its first Assign) and to finish
SERVER_READY_S = 300.0
SERVER_FINISH_S = 120.0
# the traced run's profiler window: it opens a quarter into the measured
# window and stays open this long
TRACE_AFTER_SHARE = 0.25
TRACE_WINDOW_S = 4.0


def process_started_at() -> float:
    """The wall-clock time this process started (``/proc``), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``koordinator_tpu_torch`` is not ``koordinator_tpu``)."""
    tops = {name.split(".", 1)[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def running_band(cell: manifest.Cell):
    """The running pods a stationary window holds at every cycle: the
    generator's ``running_band(config, traffic)`` where it has one; else the
    init pods and the pending queue times the mean lifetime (every pending
    pod binds), within the traffic file's ``running_band`` of that."""
    own = getattr(cell.generator, "running_band", None)
    if own is not None:
        return own(cell.config, cell.traffic)
    lo, hi = cell.traffic["lifetime_steps"]
    mean = int(cell.config["init_pods"]) + int(cell.config["pending_pods"]) * (lo + hi) / 2
    band = float(cell.traffic["running_band"])
    return math.ceil(mean * (1 - band)), math.floor(mean * (1 + band))


def card_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


@dataclasses.dataclass
class Step:
    sync_ms: float = 0.0
    score_ms: float = 0.0
    assign_ms: float = 0.0
    total_ms: float = 0.0
    harness_ms: float = 0.0
    error: Optional[str] = None
    degraded: bool = False


class Served:
    """The program under test: ``kbench/serve.py`` in its own process, and
    the client the window drives."""

    def __init__(self, cell: manifest.Cell, device: str, traced: bool, sock_dir: str):
        self.path = os.path.join(sock_dir, "scorer.sock")
        cmd = [sys.executable, "-m", SERVE_MODULE, "--sock", self.path,
               "--cycle", json.dumps(cell.traffic["cycle"]), "--device", device]
        if traced:
            cmd.append("--traced")
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True, cwd=str(manifest.ROOT))
        self.client = None

    def _read(self, timeout: float) -> dict:
        import selectors

        with selectors.DefaultSelector() as sel:
            sel.register(self.proc.stdout, selectors.EVENT_READ)
            if not sel.select(timeout):
                raise TimeoutError(f"the servicer's process did not answer in {timeout} s")
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the servicer's process ended (exit {self.proc.poll()})")
        return json.loads(line)

    def ready(self) -> "Served":
        """Wait for the servicer, then connect the client."""
        from koordinator_tpu_torch.bridge.client import RAW_SCHEME, ScorerClient

        self._read(SERVER_READY_S)
        self.client = ScorerClient(RAW_SCHEME + self.path, rpc_timeout_ms=RPC_TIMEOUT_MS)
        return self

    def op(self, name: str, timeout: float = 60.0) -> dict:
        self.proc.stdin.write(json.dumps({"op": name}) + "\n")
        self.proc.stdin.flush()
        return self._read(timeout)

    def finish(self) -> dict:
        """Stop serving; the device's name, memory peak, ledger and profile."""
        doc = self.op("finish", SERVER_FINISH_S)
        self.close()
        return doc

    def close(self) -> None:
        try:
            if self.client is not None:
                self.client.close()
        finally:
            if self.proc.poll() is None:
                try:
                    self.proc.stdin.close()
                    self.proc.wait(timeout=30)
                except (OSError, subprocess.TimeoutExpired):
                    self.proc.kill()
                    self.proc.wait()


class Sample:
    """The window steps whose replies are compared: the last step and
    ``want - 1`` others drawn uniformly from the seed as the window runs
    (reservoir sampling), so that a run keeps ``want`` replies, not all."""

    def __init__(self, want: int, seed: int):
        self.size = max(0, want - 1)
        self.rng = random.Random(f"kbench-sample-{seed}")
        self.kept: Dict[int, object] = {}
        self.last: Optional[tuple] = None
        self.seen = 0

    def offer(self, step: int, reply) -> None:
        if self.last is not None:
            self._keep(*self.last)
        self.last = (step, reply)

    def _keep(self, step: int, reply) -> None:
        if len(self.kept) < self.size:
            self.kept[step] = reply
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                del self.kept[sorted(self.kept)[j]]
                self.kept[step] = reply
        self.seen += 1

    def steps(self) -> Dict[int, object]:
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def compare(score, assign, model, cell: manifest.Cell,
            device: str = "cpu") -> Dict[str, int]:
    """Mismatches of one step's replies against the configuration's
    reference over the generator's model of that step."""
    reference = cell.reference
    cycle, k = cell.traffic["cycle"], int(cell.traffic["top_k"])
    want = reference.score_reply(model, cycle, k, device=device)
    got_pods, got_counts, got_nodes, got_scores = (np.asarray(a) for a in score)
    if not (np.array_equal(got_pods, want[0]) and np.array_equal(got_counts, want[1])):
        # the layout itself differs: every pod whose count differs, at least one
        bad_pods = max(1, int((got_counts != want[1]).sum()) if got_counts.shape == want[1].shape
                       else int(want[1].shape[0]))
    else:
        pod_of_entry = np.repeat(np.arange(want[1].shape[0]), want[1])
        same = (got_nodes == want[2]) & (got_scores == want[3])
        bad_pods = int(np.unique(pod_of_entry[~same]).shape[0])
    out = {"score": bad_pods}
    if assign is not None:
        got_a, got_s = np.asarray(assign[0]), np.asarray(assign[1])
        want_a, want_s = reference.assign_reply(model, cycle, device=device)
        if got_a.shape != want_a.shape or got_s.shape != want_s.shape:
            out["assign"] = int(want_a.shape[0])
        else:
            out["assign"] = int(((got_a != want_a) | (got_s != want_s)).sum())
    return out


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", started_at: Optional[float] = None) -> dict:
    """One run; returns the result object (``correct`` ... ``checks``) and
    writes its progress lines to standard error."""
    started_at = _IMPORTED_AT if started_at is None else started_at
    log = sys.stderr
    t = cell.traffic
    k = int(t["top_k"])

    sock_dir = tempfile.mkdtemp(prefix="kb-")
    served = Served(cell, device, traced, sock_dir)
    window_open = False
    profiled = [None, None]
    try:
        # the cluster is made while the servicer's process starts
        gen = cell.generator
        model = gen.build(cell.config, seed)
        loop = gen.BindLoop(model, t["lifetime_steps"], seed)
        pending_full = int(cell.config["pending_pods"])
        sem = cell.reference.Semantics(t["cycle"])
        client = served.ready().client

        def step_rpcs(kwargs, step: Step):
            t0 = time.perf_counter()
            score = assign = None
            try:
                client.sync(**kwargs)
                t1 = time.perf_counter()
                score = client.score_flat(top_k=k)
                t2 = time.perf_counter()
                step.sync_ms, step.score_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
                step.degraded = bool(client.last_degraded)
                assign = client.assign()[:2]
                step.assign_ms = (time.perf_counter() - t2) * 1e3
            except Exception as exc:  # a failed RPC is a failed step; the run goes on
                step.error = f"{type(exc).__name__}: {exc}"
            step.total_ms = (time.perf_counter() - t0) * 1e3
            return score, assign

        def advance(model, assign):
            """The next step's model and Sync, after this step's binds."""
            if assign is None:  # a failed step binds nothing
                return model, {}
            after = loop.after_assign(model, assign[0], assign[1])
            return after, gen.sync_kwargs(model, after)

        kwargs = gen.full_sync_kwargs(model)
        for _ in range(int(t["warmup_steps"])):
            warm = Step()
            _, assign = step_rpcs(kwargs, warm)
            if warm.error:
                raise RuntimeError(f"a warm-up step failed: {warm.error}")
            model, kwargs = advance(model, assign)
        pending_start, running_start = model.pending_pods(), model.running_pods()
        served.op("mark")
        gc.collect()
        gc.freeze()

        steps: List[Step] = []
        sample = Sample(int(t["check_steps"]), seed)
        states = []
        t_open = time.perf_counter()
        setup_s = time.time() - started_at
        deadline = t_open + seconds
        prof_at = t_open + seconds * TRACE_AFTER_SHARE
        n = errors = 0
        while time.perf_counter() < deadline:
            if traced and profiled[0] is None and time.perf_counter() >= prof_at:
                served.op("trace_start")
                window_open, profiled[0], prof_at = True, n, time.perf_counter()
            step = Step()
            score, assign = step_rpcs(kwargs, step)
            h0 = time.perf_counter()
            if step.error is None:
                sample.offer(n, (score, assign, model))
                if window_open:
                    states.append(roofline.cycle_state(model, sem))
            else:
                errors += 1
            model, kwargs = advance(model, assign)
            steps.append(step)
            n += 1
            if window_open and time.perf_counter() >= prof_at + TRACE_WINDOW_S:
                served.op("trace_stop")
                window_open, profiled[1] = False, n
            step.harness_ms = (time.perf_counter() - h0) * 1e3
            if errors >= MAX_ERRORS:
                print(f"kbench: {errors} failed RPCs, the window ends early", file=log)
                break
        t_close = time.perf_counter()
        gc.unfreeze()
        if window_open:
            served.op("trace_stop")
            window_open, profiled[1] = False, n
        pending_end, running_end = model.pending_pods(), model.running_pods()
        served_doc = served.finish()
        if served_doc["forbidden"]:
            raise RuntimeError(f"the servicer's process loaded {', '.join(served_doc['forbidden'])}")
    finally:
        served.close()
        shutil.rmtree(sock_dir, ignore_errors=True)

    # -- the window's numbers --
    window_s = t_close - t_open
    step_s = sum(s.total_ms for s in steps) / 1e3
    harness_s = sum(s.harness_ms for s in steps) / 1e3
    done = [s for s in steps if s.error is None]
    failed = sum(1 for s in steps if s.error is not None or s.degraded
                 or s.total_ms > STEP_LIMIT_MS)
    totals = [s.total_ms for s in steps]
    print(f"kbench: {cell.name} seed {seed}: {len(steps)} steps in {window_s:.3f} s, "
          f"{step_s:.3f} s of them in the program's calls and {harness_s:.3f} s in the "
          f"harness's binds and bookkeeping; {len(done)} completed, {failed} failed; "
          f"step_p95_ms over {len(totals)} samples", file=log)
    quarters = [[round(stats.mean([getattr(s, f) or 0.0 for s in part]) or 0.0, 3)
                 for f in ("sync_ms", "score_ms", "assign_ms", "harness_ms")]
                for part in np.array_split(np.asarray(steps, dtype=object), 4)]
    print(f"kbench: mean sync, score, assign, harness ms by quarter of the steps {quarters}; "
          f"p50 step {stats.percentile(totals, 0.5)} ms; {loop.bound} pods bound", file=log)
    print(f"kbench: pending pods {pending_start} at the window's start, {pending_end} at its "
          f"end; running pods {running_start} and {running_end}", file=log)
    for s in steps:
        if s.error:
            print(f"kbench: failed step: {s.error}", file=log)
            break

    # -- the reference at sampled steps, on the card the servicer left --
    compared = sample.steps()
    mismatch = {"score": 0, "assign": 0}
    t_ref = time.perf_counter()
    for i in sorted(compared):
        score, assign, at = compared[i]
        for key, v in compare(score, assign, at, cell, device).items():
            mismatch[key] += v
    print(f"kbench: reference over {len(compared)} steps in {time.perf_counter() - t_ref:.3f} s",
          file=log)

    run_doc = {
        "steps": [dataclasses.asdict(s) for s in steps],
        "window_s": window_s,
        "devprof": served_doc["devprof"],
        "counts": {"scores": len(done), "assigns": len(done)},
        "profile": served_doc["profile"],
        "profiled_states": states,
        "kernels": {"k2": K2_KERNEL, "k3": K3_KERNEL},
    }
    if traced:
        metrics = {}
        for name, read in manifest.readers(cell).items():
            value = read(run_doc)
            if value is not None:
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {
            "steps_per_s": {"value": stats.rate(len(done), step_s), "unit": "steps/s"},
            "step_p95_ms": {"value": stats.percentile(totals, 0.95), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}

    unanswered = sum(1 for s in steps if s.error is not None)
    lo, hi = running_band(cell)
    checks = {
        "score_mismatched_pods": {"value": mismatch["score"], "op": "<=", "limit": 0},
        "unanswered_steps": {"value": unanswered, "op": "<=", "limit": 0},
        "steps_compared": {"value": len(compared), "op": ">=",
                           "limit": min(int(t["check_steps"]), max(len(steps), 1))},
        "pending_pods_start": {"value": pending_start, "op": "in",
                               "limit": [pending_full, pending_full]},
        "pending_pods_end": {"value": pending_end, "op": "in",
                             "limit": [pending_full, pending_full]},
        "running_pods_start": {"value": running_start, "op": "in", "limit": [lo, hi]},
        "running_pods_end": {"value": running_end, "op": "in", "limit": [lo, hi]},
        "assign_mismatched_slots": {"value": mismatch["assign"], "op": "<=", "limit": 0},
    }
    correct = all(_holds(c) for c in checks.values())
    on_card = device.startswith("cuda")
    device_doc = {
        "platform": "gpu" if on_card else "cpu",
        "kind": served_doc["kind"],
        "count": 1,
        "memory_peak_bytes": served_doc["memory_peak_bytes"],
    }
    result = {"correct": correct, "attempted": len(steps), "failed": failed,
              "metrics": metrics, "device": device_doc}
    if traced and served_doc["profile"] is not None:
        device_doc["busy_s"] = served_doc["profile"]["busy_s"]
        device_doc["window_s"] = served_doc["profile"]["window_s"]
        result["breakdown"] = devtrace.breakdown(served_doc["profile"])
    result["checks"] = checks
    return result


def _holds(check: dict) -> bool:
    v, op, limit = check["value"], check["op"], check["limit"]
    if op == "<=":
        return v <= limit
    if op == ">=":
        return v >= limit
    return limit[0] <= v <= limit[1]


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']} {c['op']} {c['limit']}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started_at = process_started_at()

    cell = manifest.load_cell(args.workload)
    import torch

    # asks the driver only: this process makes no CUDA context while the
    # servicer's process holds the card
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    threads.fix_torch()
    root = str(manifest.ROOT)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, ".kbench_cache", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".kbench_cache", "triton")
    print(f"kbench: card {card_limit()}", file=sys.stderr)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", started_at)
    found = forbidden_modules()
    if found:
        print(f"kbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print_checks(result["checks"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
