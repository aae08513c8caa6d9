"""A fixed digest that ties the port's cycle to the reference's placements.

``ANCHOR_SHA256`` is the digest of the reference ``greedy_assign``'s
assignment and status on the quota_colocation recipe at ``ANCHOR_RECIPE``,
with the default cycle config.  ``chip_smoke.py`` checks the port's CUDA
cycle against it on the card, where the reference cannot run, and a CPU
test (``tests/test_torch_cycle.py``) recomputes it from the reference, so
the constant cannot drift.

The wave-batched cycle places pods exactly as the per-pod one, so its
digest at ``WAVE_ANCHOR_CFG`` is ``ANCHOR_SHA256`` too; ``WAVE_ANCHOR_ROUNDS``
is the reference wave kernel's round count there, recomputed by the same
test from the JAX kernel in interpret mode.

The Score path has anchors at the same recipe: ``TOPK_ANCHOR_SHA256`` is
the digest of the reference's ``masked_top_k(k=TOPK_ANCHOR_K,
hi=score_upper_bound(cfg))`` of ``score_cycle`` under the default config,
``TERM_TOPK_ANCHOR_SHA256`` the same under the term config
(``default_term_config(packing_headroom=TERM_ANCHOR_HEADROOM)``, term data
of ``generators.with_term_tensors(snap, TERM_ANCHOR_SEED)``), and
``TERM_ANCHOR_SHA256`` the cycle digest of the reference's ``run_cycle``
under the term config.  ``tests/test_torch_score.py`` and
``tests/test_torch_terms.py`` recompute them from the JAX package.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

ANCHOR_RECIPE = {"seed": 0, "pods": 2000, "nodes": 400, "tenants": 16}
ANCHOR_SHA256 = "82d0f61872bb822febac6eb755ecff803608bbdb344cbc863c8a7a43327208ce"
WAVE_ANCHOR_CFG = {"wave": 32, "top_m": 4}
WAVE_ANCHOR_ROUNDS = 157
TOPK_ANCHOR_K = 32
TOPK_ANCHOR_SHA256 = "89d5dd3109c5215fb1d09ef5f33fcd37babe65bcfbec9b33150296538492d18a"
TERM_ANCHOR_SEED = 0
TERM_ANCHOR_HEADROOM = {"cpu": 98, "memory": 98}
TERM_TOPK_ANCHOR_SHA256 = "a0836829af862868d9423c0ddfe4a671738b67f91dc9215083f35894ad2d0467"
TERM_ANCHOR_SHA256 = "c027d556bf28ea9f7d6daba7874cb26910a46cc40af68ef712a0f90ebc13fa0f"


def cycle_digest(assignment, status) -> str:
    """sha256 over the little-endian int32 bytes of assignment, then status.
    Takes numpy arrays or CPU tensors."""
    h = hashlib.sha256()
    for a in (assignment, status):
        h.update(np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes())
    return h.hexdigest()


def result_digests(result, pods: int, nodes: int, quotas: int) -> dict:
    """sha256 of each of a ``CycleResult``'s five arrays, over the first
    ``pods``/``nodes``/``quotas`` rows (a snapshot's padding excluded), as
    little-endian int64 bytes.  Takes tensors on any device."""
    rows = {"assignment": pods, "status": pods, "node_requested": nodes,
            "node_estimated": nodes, "quota_used": quotas}
    out = {}
    for name, n in rows.items():
        value = getattr(result, name)
        host = np.asarray(value.cpu() if hasattr(value, "cpu") else value)[:n]
        out[name] = hashlib.sha256(
            np.ascontiguousarray(host, dtype="<i8").tobytes()).hexdigest()
    return out


def topk_digest(top_scores, top_idx) -> str:
    """sha256 over the little-endian int64 bytes of the top-k scores, then
    the int32 bytes of their indices.  Takes numpy arrays or CPU tensors."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(top_scores), dtype="<i8").tobytes())
    h.update(np.ascontiguousarray(np.asarray(top_idx), dtype="<i4").tobytes())
    return h.hexdigest()


# The trace replay's configurations on the card (``chip_smoke.py``'s
# ``trace`` line): the reference's accelerator trace and the trace at the
# headline cluster size.  Each digest is the reference
# ``harness/trace.py generate_trace(TraceConfig(**cfg)).digest()``;
# ``tests/test_torch_trace.py`` recomputes both from the JAX package.
TRACE_ANCHOR_CFG = {"seed": 0, "nodes": 512, "pod_slots": 2048, "tenants": 8,
                    "gangs": 12, "gang_min_member": 4, "events": 96}
TRACE_ANCHOR_SHA256 = "11d3a8e604bbece324610eb02184907f9f4d545ede6eae9a0c34b6ce2ee3ff5a"
TRACE_HEADLINE_CFG = {"seed": 0, "nodes": 2000, "pod_slots": 10000, "tenants": 8,
                      "gangs": 12, "gang_min_member": 4, "events": 24}
TRACE_HEADLINE_SHA256 = "6e0d1ff7915984935e02b76caff37cb8a04e7f8b070b65d11dd0876bd2584864"
# The ``trace`` line's term replays: the accelerator trace drawn with the
# fused-term events (``TraceConfig(mix=TERM_MIX, ...)``) over two
# accelerator types and three workload classes, as the reference's
# ``tests/test_terms.py TestTermTraceEvents`` draws its term trace
TRACE_TERMS_CFG = {**TRACE_ANCHOR_CFG, "accel_types": 2, "workload_classes": 3}
TRACE_TERMS_SHA256 = "2bde88b70572e92ad0cba9c7d8735e62f10a3a16a81f2277218c2f2641a59a10"

# The chaos x trace gate (``chip_smoke.py``'s ``chaos`` line): the
# reference's ``--config chaos-trace`` trace on an accelerator
# (``bench.py:1584-1607``) and, under ``"on_cpu"``, on the CPU; the fault
# schedule of both is fail at a quarter of the events, kill at two thirds.
# ``CHAOS_ANCHOR_SHA256`` is the reference's digest of the accelerator
# trace; ``tests/test_torch_chaos.py`` recomputes it from the JAX package.
# ``CHAOS_HEADLINE_CFG`` is the gate at the headline cluster size
# (``TRACE_HEADLINE_CFG``: fail at 6, kill at 16).
CHAOS_ANCHOR_CFG = {
    "accelerator": {"seed": 0, "nodes": 128, "pod_slots": 512, "tenants": 6,
                    "gangs": 6, "gang_min_member": 4, "events": 48},
    "on_cpu": {"seed": 0, "nodes": 32, "pod_slots": 96, "tenants": 4,
               "gangs": 6, "gang_min_member": 4, "events": 24},
}
CHAOS_ANCHOR_SHA256 = "dc5875ca729e5401f54a68cfc18abbf98db66f212ff17ea7f5e02bb3c2b26832"
CHAOS_HEADLINE_CFG = TRACE_HEADLINE_CFG


# The extended-plugin cycle (``chip_smoke.py``'s ``extras`` line) at
# ``ANCHOR_RECIPE``, the extras scenario at seed 0
# (``extras_scenario.extras_snapshot``): ``EXTRAS_TENSORS_SHA256`` is the
# digest of the reference's ``plugin_extra_tensors`` (mask, scores) and
# ``EXTRAS_ANCHOR_SHA256`` the cycle digest of its ``greedy_assign`` with
# them.  ``REBALANCE_ANCHOR_SHA256`` is the digest of the reference's
# ``balance`` plan (``harness/rebalance.py``) on the reference's
# placements of the anchor snapshot (``ANCHOR_SHA256``).
# ``tests/test_torch_extras.py`` and ``tests/test_torch_descheduler.py``
# recompute them from the JAX package.
EXTRAS_TENSORS_SHA256 = "b3123fec556087fa1a738fc1b94091a1452f1cce361dc9611d5b26e2b4f7edc0"
EXTRAS_ANCHOR_SHA256 = "1d5fbb3c41583acee8689263878a3558ce0452ea52d978df116ba20d66fd08b4"
REBALANCE_ANCHOR_SHA256 = "406100f80221231a9bcc0d188c71b97021f7f06a17e77489c7270b118ceb47ed"

# The PostFilter (``chip_smoke.py``'s ``preempt`` line) at ``ANCHOR_RECIPE``:
# the digest (``harness/preempt.py preempt_digest``) of the reference's
# ``FrameworkExtender.post_filter_preempt`` over every pod its extras cycle
# (the ``EXTRAS_ANCHOR_SHA256`` placements) left unplaced, on the
# inventory ``preemption_inventory`` builds from that cycle.
# ``tests/test_torch_extras.py`` recomputes it from the JAX package.
PREEMPT_ANCHOR_SHA256 = "4c48ca3f5ebf170aa868d7a5bc6c48b7a5f81139dfbeec15efa59fd06efb796f"


def extras_digest(mask, scores) -> str:
    """sha256 over the mask, one byte a cell, then the little-endian int64
    scores.  Takes numpy arrays or CPU tensors."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(mask), dtype=np.uint8).tobytes())
    h.update(np.ascontiguousarray(np.asarray(scores), dtype="<i8").tobytes())
    return h.hexdigest()


def plan_digest(planned) -> str:
    """sha256 of a Balance plan (a list of dicts) as canonical JSON."""
    text = json.dumps(list(planned), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


# The node agent (``chip_smoke.py``'s ``koordlet`` line):
# ``KOORDLET_ANCHOR_SHA256`` is the cycle digest of the reference's
# extended-plugin cycle at ``ANCHOR_RECIPE`` on the snapshot that
# ``harness/koordlet_fleet.py fleet_snapshot`` builds from the reference
# koordlet's reports (NodeTopoReporter, DeviceReporter, NodeMetricReporter
# of every node, their samples seeded by the recipe's seed), and
# ``KOORDLET_QOS_SHA256`` the reference daemon's ``run_qos_ticks`` digest
# over ``QosTree(root, KOORDLET_QOS_SEED)``.  ``tests/test_torch_koordlet.py``
# recomputes both from the JAX package.
KOORDLET_ANCHOR_SHA256 = "96d74f79315c589889c34b8d4ee7aac7cca1b541b7c23bc68ef903d7ad842986"
KOORDLET_QOS_SEED = 0
KOORDLET_QOS_SHA256 = "46dbec235dd5c52bd80e034979a84566f779ed493ad85aab87244a5b14595c61"
