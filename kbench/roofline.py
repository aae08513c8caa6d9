"""The least time the card could take for one Assign cycle's function.

A frozen copy of the port's ``chip_smoke.py cycle_bound_ms``, restated over
the benchmark's own model of the cluster instead of the kernel's prepared
inputs: the larger of the cycle's bytes over the memory rate and its
integer operations over the peak rate.  Operations count what the cycle's
outputs need: every pod scored once against every node, at two operations
a requested resource (Fit), six a Fit-weighted and seven a
LoadAware-weighted resource (score), two for the term extras and four for
the argmax and sums.  Bytes count each input read once and each output
written once, at the widths of the int32 kernels (K2, K3).  The bound
ignores the chain of one pod after another that a sequential greedy cycle
cannot shorten, so it is far below any per-pod kernel's time.
"""

from __future__ import annotations

from kbench.gen.cluster import R

# NVIDIA H100 SXM, published: HBM3 at 3.35 TB/s; 67 T operations/s on the
# CUDA cores (the float32 rate, taken for int32 as the port's bound does)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def cycle_state(model, sem) -> dict:
    """What the bound needs of one step's cluster (a ``ClusterModel``) under
    the reference's ``Semantics`` of the cell's cycle."""
    return {
        "pods": int(model.preq.shape[0]),
        "nodes": int(model.nalloc.shape[0]),
        "quotas": int(model.qrt.shape[0]),
        "requested": int((model.preq > 0).sum()),
        "extras": bool(sem.terms),
        "fit_weighted": int((sem.fit_weights != 0).sum()),
        "la_weighted": int((sem.la_weights != 0).sum()),
    }


def cycle_ops(state: dict) -> float:
    pods, nodes = state["pods"], state["nodes"]
    per_cell = (2 * state["requested"] / max(pods, 1) + 6 * state["fit_weighted"]
                + 7 * state["la_weighted"] + (2 if state["extras"] else 0) + 4)
    return pods * nodes * per_cell


def cycle_bytes(state: dict, rounds_word: bool = False) -> int:
    pods, nodes, quotas = state["pods"], state["nodes"], state["quotas"]
    pod_in = 3 * pods * R * 4 + pods * (4 + 1 + 1)          # requests, ids, flags
    node_in = 3 * R * nodes * 4 + nodes                      # alloc, requested, usage, flags
    quota_in = 2 * quotas * R * 4 + quotas * R               # runtime, used, limited
    extras = pods * nodes * 4 if state["extras"] else 0
    out = pods * 4 + 2 * R * nodes * 4 + quotas * R * 4 + (4 if rounds_word else 0)
    return pod_in + node_in + quota_in + 2 * R * 4 + extras + out


def cycle_bound_ms(state: dict, rounds_word: bool = False) -> float:
    return max(cycle_bytes(state, rounds_word) / HBM_BYTES_PER_S,
               cycle_ops(state) / PEAK_OPS_PER_S) * 1e3
