"""Executable spec of ``go/plugin/batchedtpuscorer.go``, on the port's codec.

Counterpart of ``koordinator_tpu/bridge/plugin_sim.py``: the Go plugin's
PreScore protocol — vector building, delta-vs-full sync decision,
generation-continuity check with full re-sync, mirror promotion and
invalidation, flat-score row extraction — step for step in Python, with
the port's wire codec (``bridge/wire.py``), driven against the port's
raw-UDS server by ``tests/test_torch_server.py`` and ``chip_smoke.py``.

Go references (line-level mirrors):
  * nodeInfoVectors       -> node_vectors
  * DeltaTensor           -> delta_tensor (go/scorerclient/delta.go)
  * buildSync             -> build_sync
  * Scorer.PreScore       -> GoPluginSim.pre_score (including the
    delta-failure full-retry and the epoch+generation continuity check)
  * parseSnapshotID       -> parse_snapshot_id
  * scorerclient.Generation -> generation
  * NodeMetricCache.SetQuantities (the NodeMetric informer parse)
                          -> usage_vector_from_node_metric
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.bridge import wire

NUM_AXES = 13
AXIS_CPU = 0
AXIS_MEMORY = 1
DEFAULT_MAX_DELTA_RATIO = 0.25

METHOD_SYNC = 1
METHOD_SCORE = 2
METHOD_ASSIGN = 3


def parse_snapshot_id(snapshot_id: str) -> Tuple[str, int]:
    """scorerclient.ParseSnapshotID: "s<epoch>-<generation>" -> (epoch,
    generation); legacy "s<generation>" -> ("", generation); malformed
    generations parse as -1 (never satisfies a continuity check).  The
    epoch is the sidecar's per-boot nonce: delta continuity requires the
    SAME epoch — after a restart the generation counter resets and bare
    ``gen == mirror.gen+1`` can coincidentally pass."""
    body = snapshot_id.removeprefix("s")
    epoch, sep, gen = body.rpartition("-")
    if not sep:
        epoch, gen = "", body
    try:
        return epoch, int(gen)
    except ValueError:
        return epoch, -1


def generation(snapshot_id: str) -> int:
    """scorerclient.Generation: the generation half of the snapshot id."""
    return parse_snapshot_id(snapshot_id)[1]


def usage_vector_from_node_metric(payload: Dict) -> Optional[List[int]]:
    """NodeMetricCache.SetQuantities' parse path, in Python: convert the
    koordlet NodeMetricReporter payload
    (``{"nodeMetric": {"nodeUsage": {"cpu": "1500m",
    "memory": "<bytes>"}}}``) into the dense usage vector the shim syncs
    (cpu milli at axis 0, memory MiB at axis 1).  None when the payload
    carries no node usage (the cache keeps its previous sample).
    Quantities go through the one parser (model/resources.parse_quantity)
    so every Kubernetes serialization form ("2Gi", "1500000000n") lands
    in the exact axis units."""
    from koordinator_tpu_torch.model import resources as res

    usage = ((payload or {}).get("nodeMetric") or {}).get("nodeUsage")
    if not usage:
        return None
    vec = [0] * NUM_AXES
    vec[AXIS_CPU] = int(res.parse_quantity(usage.get("cpu", 0), res.CPU))
    vec[AXIS_MEMORY] = int(
        res.parse_quantity(usage.get("memory", 0), res.MEMORY)
    )
    return vec


def delta_tensor(
    shape: Sequence[int],
    prev: Optional[Sequence[int]],
    next_: Sequence[int],
    max_ratio: float = DEFAULT_MAX_DELTA_RATIO,
) -> "wire.Tensor":
    """go/scorerclient/delta.go DeltaTensor, exactly: full data when prev
    is absent/mismatched or more than max(1, int(size*ratio)) cells
    changed; sparse flat (idx, val) otherwise (empty = unchanged)."""
    next_ = list(next_)
    t = wire.Tensor(shape=list(shape))
    if prev is None or len(prev) != len(next_):
        t.data = np.asarray(next_, "<i8").tobytes()
        return t
    max_changes = max(1, int(len(next_) * max_ratio))
    idx = [i for i, (a, b) in enumerate(zip(prev, next_)) if a != b]
    if len(idx) > max_changes:
        t.data = np.asarray(next_, "<i8").tobytes()
        return t
    t.delta_idx = np.asarray(idx, "<i8").tobytes()
    t.delta_val = np.asarray([next_[i] for i in idx], "<i8").tobytes()
    return t


def node_vectors(
    nodes: Sequence[Tuple[str, Sequence[int], Sequence[int]]],
    metrics: Optional[Dict[str, Sequence[int]]],
):
    """nodeInfoVectors: (names, alloc, requested, usage, fresh) with
    usage from the metrics provider when a fresh sample exists, else
    requested with fresh=False (Fit-only for that node)."""
    names: List[str] = []
    alloc: List[int] = []
    requested: List[int] = []
    usage: List[int] = []
    fresh: List[bool] = []
    for name, a, r in nodes:
        names.append(name)
        alloc.extend(a)
        requested.extend(r)
        vec = (metrics or {}).get(name)
        if vec is not None and len(vec) == NUM_AXES:
            usage.extend(vec)
            fresh.append(True)
        else:
            usage.extend(r)
            fresh.append(False)
    return names, alloc, requested, usage, fresh


def build_sync(
    mirror: "ResidentMirror",
    delta: bool,
    names: List[str],
    alloc: List[int],
    requested: List[int],
    usage: List[int],
    fresh: List[bool],
    pod_name: str,
    pod_vec: List[int],
    priority: int,
) -> bytes:
    """buildSync: node tensors delta-encoded against the acked baseline
    (names omitted) on warm cycles; the single-pod table always full."""
    n = len(names)
    shape = [n, NUM_AXES]
    prev_alloc = prev_req = prev_usage = None
    wire_names = names
    if delta:
        prev_alloc, prev_req, prev_usage = (
            mirror.alloc,
            mirror.requested,
            mirror.usage,
        )
        wire_names = []
    pod = np.asarray(pod_vec, "<i8").tobytes()
    req = wire.SyncRequest()
    req.nodes.names.extend(wire_names)
    req.nodes.allocatable.CopyFrom(delta_tensor(shape, prev_alloc, alloc))
    req.nodes.requested.CopyFrom(delta_tensor(shape, prev_req, requested))
    req.nodes.usage.CopyFrom(delta_tensor(shape, prev_usage, usage))
    req.nodes.metric_fresh.extend(fresh)
    req.pods.names.append(pod_name)
    req.pods.requests.CopyFrom(wire.Tensor(shape=[1, NUM_AXES], data=pod))
    req.pods.estimated.CopyFrom(wire.Tensor(shape=[1, NUM_AXES], data=pod))
    req.pods.priority.append(priority)
    req.pods.gang_id.append(-1)
    req.pods.quota_id.append(-1)
    return req.SerializeToString()


class ResidentMirror:
    """residentMirror: the last ACKED node table (delta baseline)."""

    def __init__(self):
        self.invalidate()

    def invalidate(self) -> None:
        self.names: List[str] = []
        self.alloc: List[int] = []
        self.requested: List[int] = []
        self.usage: List[int] = []
        self.gen = 0
        self.epoch = ""
        self.valid = False


class GoPluginSim:
    """Scorer (the plugin struct) over a raw-UDS connection."""

    def __init__(self, socket_path: str, timeout_s: Optional[float] = 120.0):
        """``timeout_s``: every socket operation's limit (None waits
        forever), so a stuck server fails the call instead of hanging it."""
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self.mirror = ResidentMirror()
        # NodeMetricsProvider: node -> usage vector (fresh by presence;
        # staleness windows are the cache's concern, not the plugin's)
        self.metrics: Dict[str, Sequence[int]] = {}
        self._conn: Optional[socket.socket] = None
        # wire observability for tests: (method, payload_len) per frame
        self.sent_frames: List[Tuple[int, int]] = []

    def update_node_metric(self, node: str, payload: Dict) -> None:
        """The NodeMetric informer callback (the Go plugin wires the CR
        informer's add/update handler to NodeMetricCache.Set the same
        way): parse the koordlet report and refresh the node's usage
        sample; a payload without node usage keeps the previous one."""
        vec = usage_vector_from_node_metric(payload)
        if vec is not None:
            self.metrics[node] = vec

    # ensureClient / dropClient
    def _client(self) -> socket.socket:
        if self._conn is None:
            self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._conn.settimeout(self.timeout_s)
            self._conn.connect(self.socket_path)
        return self._conn

    def _drop_client(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _call(self, method: int, payload: bytes) -> bytes:
        conn = self._client()
        self.sent_frames.append((method, len(payload)))
        conn.sendall(struct.pack(">BI", method, len(payload)) + payload)
        head = conn.recv(5, socket.MSG_WAITALL)
        status, length = struct.unpack(">BI", head)
        body = b""
        while len(body) < length:
            chunk = conn.recv(length - len(body))
            if not chunk:
                raise ConnectionError("connection closed mid-reply")
            body += chunk
        if status != 0:
            raise RuntimeError(f"scorer error: {body.decode()}")
        return body

    def pre_score(
        self,
        nodes: Sequence[Tuple[str, Sequence[int], Sequence[int]]],
        pod_name: str,
        pod_vec: Sequence[int],
        priority: int = 0,
    ) -> Dict[str, int]:
        """Scorer.PreScore: returns {node name: combined score} (the
        CycleState row); raises on any seam failure, with the mirror
        invalidated exactly where the Go code invalidates it."""
        names, alloc, requested, usage, fresh = node_vectors(
            nodes, self.metrics
        )
        pod_vec = list(pod_vec)
        delta = self.mirror.valid and self.mirror.names == names

        def sync_once(as_delta: bool) -> "wire.SyncReply":
            return wire.SyncReply.FromString(
                self._call(
                    METHOD_SYNC,
                    build_sync(
                        self.mirror, as_delta, names, alloc, requested,
                        usage, fresh, pod_name, pod_vec, priority,
                    ),
                )
            )

        resynced_full = False
        try:
            reply = sync_once(delta)
        except Exception:
            if not delta:
                self.mirror.invalidate()
                self._drop_client()
                raise
            # delta-Sync failure is recoverable within the same cycle: a
            # restarted sidecar lost its resident tensors (and possibly
            # the connection) — re-dial and ship full state once before
            # surfacing an error
            self._drop_client()
            try:
                reply = sync_once(False)
                resynced_full = True
            except Exception:
                self.mirror.invalidate()
                self._drop_client()
                raise
        epoch, gen = parse_snapshot_id(reply.snapshot_id)
        if delta and not resynced_full and (
            epoch != self.mirror.epoch or gen != self.mirror.gen + 1
        ):
            # resident state displaced (foreign sync bumped the
            # generation, or a restart reset it under a fresh epoch —
            # the epoch comparison catches the restart even when the new
            # generation coincidentally continues ours): full re-sync
            # before trusting scores
            try:
                reply = sync_once(False)
            except Exception:
                self.mirror.invalidate()
                self._drop_client()
                raise
            epoch, gen = parse_snapshot_id(reply.snapshot_id)
        self.mirror.names = names
        self.mirror.alloc = alloc
        self.mirror.requested = requested
        self.mirror.usage = usage
        self.mirror.gen = gen
        self.mirror.epoch = epoch
        self.mirror.valid = True
        try:
            score = wire.ScoreReply.FromString(
                self._call(
                    METHOD_SCORE,
                    wire.ScoreRequest(
                        snapshot_id=reply.snapshot_id, top_k=0, flat=True
                    ).SerializeToString(),
                )
            )
        except Exception:
            self.mirror.invalidate()
            self._drop_client()
            raise
        if not score.HasField("flat"):
            raise RuntimeError("scorer did not return the flat layout")
        flat = score.flat
        pod_index = np.frombuffer(flat.pod_index, "<i4")
        counts = np.frombuffer(flat.counts, "<i4")
        node_index = np.frombuffer(flat.node_index, "<i4")
        scores_arr = np.frombuffer(flat.score, "<i8")
        scores: Dict[str, int] = {}
        off = 0
        for g, p in enumerate(pod_index):
            c = int(counts[g])
            if p == 0:  # single-pod table: group 0 is our pod
                for i in range(off, off + c):
                    ni = int(node_index[i])
                    if ni < len(names):
                        scores[names[ni]] = int(scores_arr[i])
            off += c
        return scores
