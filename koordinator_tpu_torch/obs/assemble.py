"""Offline trace assembly: one request, one tree.

A copy of ``koordinator_tpu/obs/assemble.py`` (pure Python).

``obs/export.py`` leaves each process's completed spans as OTLP-shaped
JSON lines under an export directory.  This module merges those
per-process files back into whole-request trees:

* spans group by ``traceId``; within a trace, ``parentSpanId`` builds
  the tree (client op span -> attempt spans -> server RPC spans ->
  replica-apply / journal-replay spans — the parent ids cross process
  boundaries because the wire carries them);
* **fan-in links** resolve against the WHOLE assembly, not just the
  owning trace: the one launch span of a coalesced batch is parented
  under its leader's trace, and every other rider references it by
  ``(traceId, spanId)`` link;
* a span whose parent id names a span nobody exported is an ORPHAN;
  a link (or a client attempt's recorded ``server_span`` attribute)
  naming a missing span is an UNRESOLVED REF; a trace carrying either
  is INCOMPLETE.  A trace replay's export must assemble with no
  incomplete trace.

CLI::

    python -m koordinator_tpu_torch.obs.assemble <dir-or-file>... [--trace ID]
        [--check] [--waterfall N]

``--check`` exits non-zero on any orphan/incomplete trace (the CI
shape); ``--trace`` renders one trace's text waterfall.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

_REQUIRED_KEYS = ("traceId", "spanId", "name")


def iter_span_files(paths: Iterable[str]) -> List[str]:
    """Expand directories into their ``*.jsonl`` span files (sorted for
    deterministic assembly), pass files through, skip what is absent —
    an empty tier is a report, not a crash."""
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(
                os.path.join(path, name)
                for name in sorted(os.listdir(path))
                if name.endswith(".jsonl")
            )
        elif os.path.isfile(path):
            out.append(path)
    return out


def load_spans(paths: Iterable[str]) -> Tuple[List[dict], int]:
    """All span records from ``paths`` (files or directories), plus a
    count of malformed lines (torn writes from a killed process are
    expected on exactly the runs this tool exists for — counted,
    skipped, never fatal)."""
    spans: List[dict] = []
    malformed = 0
    for path in iter_span_files(paths):
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError:
            malformed += 1
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    malformed += 1
                    continue
                if not isinstance(doc, dict) or any(
                    not doc.get(k) for k in _REQUIRED_KEYS
                ):
                    malformed += 1
                    continue
                spans.append(doc)
    return spans, malformed


@dataclasses.dataclass
class AssembledTrace:
    """One trace's tree: spans by id, roots (no parent), and its
    completeness defects."""

    trace_id: str
    spans: Dict[str, dict]
    roots: List[dict]
    orphans: List[dict]          # parentSpanId set but parent missing
    unresolved: List[dict]       # links / server_span refs nobody exported

    @property
    def complete(self) -> bool:
        return not self.orphans and not self.unresolved

    def children(self, span_id: Optional[str]) -> List[dict]:
        kids = [
            s for s in self.spans.values()
            if s.get("parentSpanId") == span_id
        ]
        kids.sort(key=lambda s: s.get("startTimeUnixNano") or 0)
        return kids


@dataclasses.dataclass
class Assembly:
    """The merged view over every export file handed in."""

    traces: Dict[str, AssembledTrace]
    spans_by_id: Dict[str, dict]
    malformed_lines: int

    @property
    def orphan_spans(self) -> List[dict]:
        return [s for t in self.traces.values() for s in t.orphans]

    @property
    def client_orphans(self) -> List[dict]:
        """Client-kind spans that fail to assemble — the gate's 'zero
        orphan client spans' quantity: a client span with a missing
        parent, or a client attempt whose recorded server span nobody
        exported."""
        out = []
        for trace in self.traces.values():
            for s in trace.orphans:
                if s.get("kind") == "client":
                    out.append(s)
            for s in trace.unresolved:
                if s.get("kind") == "client":
                    out.append(s)
        return out

    @property
    def incomplete(self) -> List[AssembledTrace]:
        return [t for t in self.traces.values() if not t.complete]


def _span_refs(span: dict) -> List[Tuple[str, str]]:
    """Every cross-span reference this span claims must exist: its
    fan-in links, plus a client attempt's recorded ``server_span``
    attribute (the reply echo — if the client saw a reply, the server
    span was minted, so its absence from the assembly is a hole)."""
    refs: List[Tuple[str, str]] = []
    for link in span.get("links") or ():
        if isinstance(link, dict) and link.get("spanId"):
            refs.append((str(link.get("traceId") or ""),
                         str(link["spanId"])))
    attrs = span.get("attributes") or {}
    server_span = attrs.get("server_span")
    if server_span:
        refs.append((str(span.get("traceId") or ""), str(server_span)))
    return refs


def assemble(paths: Iterable[str]) -> Assembly:
    spans, malformed = load_spans(paths)
    spans_by_id: Dict[str, dict] = {}
    by_trace: Dict[str, List[dict]] = {}
    for span in spans:
        spans_by_id[str(span["spanId"])] = span
        by_trace.setdefault(str(span["traceId"]), []).append(span)
    traces: Dict[str, AssembledTrace] = {}
    for trace_id, members in by_trace.items():
        ids = {str(s["spanId"]): s for s in members}
        roots, orphans, unresolved = [], [], []
        for span in members:
            parent = span.get("parentSpanId")
            if not parent:
                roots.append(span)
            elif parent not in ids:
                # a parent in ANOTHER trace would be a codec bug, not a
                # tree: parents are intra-trace by construction
                orphans.append(span)
            for _tid, sid in _span_refs(span):
                # links are the cross-trace edges: resolve globally
                if sid not in spans_by_id:
                    unresolved.append(span)
                    break
        roots.sort(key=lambda s: s.get("startTimeUnixNano") or 0)
        traces[trace_id] = AssembledTrace(
            trace_id=trace_id, spans=ids, roots=roots,
            orphans=orphans, unresolved=unresolved,
        )
    return Assembly(
        traces=traces, spans_by_id=spans_by_id, malformed_lines=malformed,
    )


# ---- text waterfall ----

def render_waterfall(trace: AssembledTrace, assembly: Optional[Assembly]
                     = None, width: int = 64) -> str:
    """Plain-text waterfall of one trace: indentation is the tree, the
    bar is wall-clock placement relative to the trace's first span.
    Fan-in links render as ``~> <span-id>`` annotations (the linked
    span may live in another trace — the coalesced-batch shape).

    Device-time truth: spans carrying the launch ledger's
    attrs (``device_us``/``compiled``/``build_ms``, attached by the
    servicer from drained launch notes) split their bar — ``#`` is
    host wall, ``=`` is the sampled device share — and annotate
    ``dev=…us`` (plus ``build=…ms`` on a launch that built or loaded a
    kernel), so
    one rendering answers where a slow request's time actually went:
    Python, a kernel build, or the device work itself."""
    if not trace.spans:
        return f"trace {trace.trace_id}: no spans"
    starts = [
        s.get("startTimeUnixNano") or 0 for s in trace.spans.values()
    ]
    ends = [
        s.get("endTimeUnixNano") or 0 for s in trace.spans.values()
    ]
    t0, t1 = min(starts), max(ends)
    total_ns = max(1, t1 - t0)
    dev_spans = [
        s for s in trace.spans.values()
        if (s.get("attributes") or {}).get("device_us") is not None
    ]
    dev_note = ""
    if dev_spans:
        dev_total_us = sum(
            float(s["attributes"]["device_us"]) for s in dev_spans
        )
        dev_note = (
            f", device {dev_total_us / 1e3:.3f} ms sampled across "
            f"{len(dev_spans)} span(s)"
        )
    lines = [
        f"trace {trace.trace_id}"
        f"  ({len(trace.spans)} spans, {total_ns / 1e6:.3f} ms"
        f"{dev_note}"
        f"{', INCOMPLETE' if not trace.complete else ''})"
    ]

    def emit(span: dict, depth: int) -> None:
        start = (span.get("startTimeUnixNano") or 0) - t0
        dur_ms = float(span.get("durMs") or 0.0)
        dur_ns = int(dur_ms * 1e6)
        left = int(width * start / total_ns)
        bar_w = max(1, int(width * dur_ns / total_ns))
        attrs = span.get("attributes") or {}
        dev_us = attrs.get("device_us")
        body = "#" * bar_w
        dev = ""
        if dev_us is not None:
            dev_ms = float(dev_us) / 1e3
            if dur_ms > 0:
                # right-align the device share inside the span's own
                # bar: sampled device time is a total, not an interval,
                # so the split is proportional, not positional
                dev_w = min(
                    bar_w, max(1, round(bar_w * dev_ms / dur_ms))
                )
                body = "#" * (bar_w - dev_w) + "=" * dev_w
            dev = f" dev={float(dev_us):.1f}us"
        if attrs.get("compiled"):
            dev += f" build={float(attrs.get('build_ms') or 0.0):.2f}ms"
        bar = " " * left + body[: max(0, width - left)]
        status = span.get("status") or {}
        err = " !" if status.get("code") == "ERROR" else ""
        links = "".join(
            f" ~> {link.get('spanId')}"
            for link in span.get("links") or ()
        )
        label = f"{'  ' * depth}{span.get('name')} [{span.get('kind')}]"
        lines.append(
            f"  {bar:<{width}} {dur_ms:9.3f} ms  {label}{err}{dev}{links}"
        )
        for child in trace.children(str(span["spanId"])):
            emit(child, depth + 1)

    for root in trace.roots:
        emit(root, 0)
    for orphan in trace.orphans:
        lines.append(
            f"  ORPHAN: {orphan.get('name')} "
            f"span={orphan.get('spanId')} "
            f"parent={orphan.get('parentSpanId')} (parent never exported)"
        )
    for span in trace.unresolved:
        lines.append(
            f"  UNRESOLVED REF from {orphan_name(span)}: a linked/"
            "replied span was never exported"
        )
    return "\n".join(lines)


def orphan_name(span: dict) -> str:
    return f"{span.get('name')}[{span.get('spanId')}]"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.obs.assemble",
        description="merge per-process span exports into request trees",
    )
    ap.add_argument("paths", nargs="+",
                    help="export directories (or .jsonl files)")
    ap.add_argument("--trace", default=None,
                    help="render this trace id's waterfall")
    ap.add_argument("--waterfall", type=int, default=0, metavar="N",
                    help="render the N slowest traces' waterfalls")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any orphan span or incomplete trace")
    args = ap.parse_args(argv)

    assembly = assemble(args.paths)
    traces = assembly.traces
    n_spans = len(assembly.spans_by_id)
    n_orphans = len(assembly.orphan_spans)
    incomplete = assembly.incomplete
    print(
        f"{len(traces)} trace(s), {n_spans} span(s); "
        f"{n_orphans} orphan(s), {len(incomplete)} incomplete trace(s), "
        f"{assembly.malformed_lines} malformed line(s)"
    )
    for trace in incomplete:
        print(
            f"  incomplete: {trace.trace_id} "
            f"({len(trace.orphans)} orphan(s), "
            f"{len(trace.unresolved)} unresolved ref(s))"
        )
    if args.trace:
        trace = traces.get(args.trace)
        if trace is None:
            print(f"trace {args.trace} not found", file=sys.stderr)
            return 2
        print(render_waterfall(trace, assembly))
    elif args.waterfall:
        def span_ns(t: AssembledTrace) -> int:
            stamps = [
                s.get("endTimeUnixNano") or 0 for s in t.spans.values()
            ]
            starts = [
                s.get("startTimeUnixNano") or 0 for s in t.spans.values()
            ]
            return (max(stamps) - min(starts)) if t.spans else 0

        slowest = sorted(traces.values(), key=span_ns, reverse=True)
        for trace in slowest[: args.waterfall]:
            print(render_waterfall(trace, assembly))
    if args.check and (n_orphans or incomplete):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
