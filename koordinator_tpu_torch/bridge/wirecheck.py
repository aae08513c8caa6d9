"""Independent wire-level codec for the BatchedScorer seam.

A second implementation of the wire contract, written directly against
the protobuf encoding spec (varints, tags, packed scalars) without the
protobuf runtime and apart from the port's codec (``bridge/wire.py``),
following ``go/scorerclient/wire.go``'s marshaling rules:

* fields appended in ascending field-number order,
* singular proto3 defaults (zero scalars, empty strings/bytes) skipped,
* repeated string ELEMENTS always emitted — even empty ones (dropping an
  empty element would shift every later element's index),
* repeated scalars packed.

It also decodes and encodes the replication frame
(``replication/codec.py``) with its own field walks, so the port's tests
hold the codec against an oracle that shares no code with it.  The port's
own copy of ``koordinator_tpu/bridge/wirecheck.py``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5


# ---- primitive layer ----

def read_varint(b: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if i >= len(b):
            raise ValueError("truncated varint")
        c = b[i]
        out |= (c & 0x7F) << shift
        i += 1
        if not c & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def append_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return


def append_tag(out: bytearray, field: int, wtype: int) -> None:
    append_varint(out, (field << 3) | wtype)


def append_bytes_field(out: bytearray, field: int, payload: bytes) -> None:
    """Length-delimited field; caller decides whether empty is emitted."""
    append_tag(out, field, BYTES)
    append_varint(out, len(payload))
    out.extend(payload)


def split_fields(b: bytes) -> List[Tuple[int, int, object]]:
    """Decode a message into [(field_num, wire_type, value)] in order.
    BYTES values are bytes; VARINT/FIXED* are ints (raw, unsigned)."""
    out: List[Tuple[int, int, object]] = []
    i = 0
    while i < len(b):
        key, i = read_varint(b, i)
        field, wtype = key >> 3, key & 7
        if wtype == VARINT:
            v, i = read_varint(b, i)
            out.append((field, wtype, v))
        elif wtype == FIXED64:
            if i + 8 > len(b):
                raise ValueError("truncated fixed64")
            out.append((field, wtype, struct.unpack_from("<Q", b, i)[0]))
            i += 8
        elif wtype == FIXED32:
            if i + 4 > len(b):
                raise ValueError("truncated fixed32")
            out.append((field, wtype, struct.unpack_from("<I", b, i)[0]))
            i += 4
        elif wtype == BYTES:
            n, i = read_varint(b, i)
            if i + n > len(b):
                raise ValueError("truncated length-delimited field")
            out.append((field, wtype, b[i : i + n]))
            i += n
        else:
            raise ValueError(f"unsupported wire type {wtype}")
    return out


def _signed(v: int) -> int:
    """proto int32/int64 varints are two's-complement 64-bit."""
    return v - (1 << 64) if v >= 1 << 63 else v


def unpack_varints(payload: bytes) -> List[int]:
    out = []
    i = 0
    while i < len(payload):
        v, i = read_varint(payload, i)
        out.append(_signed(v))
    return out


def pack_varints(vals) -> bytes:
    out = bytearray()
    for v in vals:
        append_varint(out, int(v))
    return bytes(out)


# ---- message layer: plain-dict decoders ----
# Dict shapes deliberately mirror the Go structs in wire.go.

def decode_tensor(b: bytes) -> Dict:
    t = {"shape": [], "data": b"", "delta_idx": b"", "delta_val": b""}
    for field, wtype, v in split_fields(b):
        if field == 1:
            t["shape"] = unpack_varints(v) if wtype == BYTES else t["shape"] + [_signed(v)]
        elif field == 2:
            t["data"] = v
        elif field == 3:
            t["delta_idx"] = v
        elif field == 4:
            t["delta_val"] = v
    return t


def _scalar_list(acc: List[int], wtype: int, v) -> List[int]:
    """Accumulate a repeated scalar field: packed payload or lone varint."""
    if wtype == BYTES:
        return acc + unpack_varints(v)
    return acc + [_signed(v)]


def decode_node_table(b: bytes) -> Dict:
    n = {
        "names": [],
        "allocatable": decode_tensor(b""),
        "requested": decode_tensor(b""),
        "usage": decode_tensor(b""),
        "metric_fresh": [],
        "agg_usage": decode_tensor(b""),
        "agg_fresh": decode_tensor(b""),
        "prod_usage": decode_tensor(b""),
        "accel_type": [],
    }
    keys = {2: "allocatable", 3: "requested", 4: "usage",
            6: "agg_usage", 7: "agg_fresh", 8: "prod_usage"}
    for field, wtype, v in split_fields(b):
        if field == 1:
            n["names"].append(v.decode("utf-8"))
        elif field in keys:
            n[keys[field]] = decode_tensor(v)
        elif field == 5:
            n["metric_fresh"] = [
                bool(x) for x in _scalar_list(
                    [int(x) for x in n["metric_fresh"]], wtype, v
                )
            ]
        elif field == 9:
            n["accel_type"] = _scalar_list(n["accel_type"], wtype, v)
    return n


def decode_pod_table(b: bytes) -> Dict:
    p = {
        "names": [],
        "requests": decode_tensor(b""),
        "estimated": decode_tensor(b""),
        "priority": [],
        "gang_id": [],
        "quota_id": [],
        "priority_class": [],
        "workload_class": [],
        "sensitivity": decode_tensor(b""),
    }
    scalars = {4: "priority", 5: "gang_id", 6: "quota_id",
               7: "priority_class", 8: "workload_class"}
    for field, wtype, v in split_fields(b):
        if field == 1:
            p["names"].append(v.decode("utf-8"))
        elif field == 2:
            p["requests"] = decode_tensor(v)
        elif field == 3:
            p["estimated"] = decode_tensor(v)
        elif field == 9:
            p["sensitivity"] = decode_tensor(v)
        elif field in scalars:
            p[scalars[field]] = _scalar_list(p[scalars[field]], wtype, v)
    return p


def decode_sync_request(b: bytes) -> Dict:
    r = {
        "nodes": decode_node_table(b""),
        "pods": decode_pod_table(b""),
        "gangs": {"min_member": []},
        "quotas": {
            "runtime": decode_tensor(b""),
            "used": decode_tensor(b""),
            "limited": decode_tensor(b""),
        },
        "node_bucket": 0,
        "pod_bucket": 0,
        "trace_id": "",
        "parent_span": "",
        "terms": {"throughput": decode_tensor(b"")},
    }
    for field, wtype, v in split_fields(b):
        if field == 1:
            r["nodes"] = decode_node_table(v)
        elif field == 2:
            r["pods"] = decode_pod_table(v)
        elif field == 3:
            for f2, w2, v2 in split_fields(v):
                if f2 == 1:
                    r["gangs"]["min_member"] = _scalar_list(
                        r["gangs"]["min_member"], w2, v2
                    )
        elif field == 4:
            qkeys = {1: "runtime", 2: "used", 3: "limited"}
            for f2, _w2, v2 in split_fields(v):
                if f2 in qkeys:
                    r["quotas"][qkeys[f2]] = decode_tensor(v2)
        elif field == 5:
            r["node_bucket"] = _signed(v)
        elif field == 6:
            r["pod_bucket"] = _signed(v)
        elif field == 7:
            r["trace_id"] = v.decode("utf-8")
        elif field == 8:
            r["parent_span"] = v.decode("utf-8")
        elif field == 9:
            for f2, _w2, v2 in split_fields(v):
                if f2 == 1:
                    r["terms"]["throughput"] = decode_tensor(v2)
    return r


def decode_sync_reply(b: bytes) -> Dict:
    r = {"snapshot_id": "", "nodes": 0, "pods": 0, "server_span": ""}
    for field, _wtype, v in split_fields(b):
        if field == 1:
            r["snapshot_id"] = v.decode("utf-8")
        elif field == 2:
            r["nodes"] = _signed(v)
        elif field == 3:
            r["pods"] = _signed(v)
        elif field == 4:
            r["server_span"] = v.decode("utf-8")
    return r


def decode_score_request(b: bytes) -> Dict:
    r = {"snapshot_id": "", "top_k": 0, "flat": False,
         "deadline_ms": 0, "band": "", "trace_id": "", "parent_span": ""}
    for field, _wtype, v in split_fields(b):
        if field == 1:
            r["snapshot_id"] = v.decode("utf-8")
        elif field == 2:
            r["top_k"] = _signed(v)
        elif field == 3:
            r["flat"] = bool(v)
        elif field == 4:
            r["deadline_ms"] = _signed(v)
        elif field == 5:
            r["band"] = v.decode("utf-8")
        elif field == 6:
            r["trace_id"] = v.decode("utf-8")
        elif field == 7:
            r["parent_span"] = v.decode("utf-8")
    return r


def decode_score_reply(b: bytes) -> Dict:
    r = {"pods": [], "flat": None, "build_ms": 0.0, "degraded": False,
         "server_span": ""}
    for field, _wtype, v in split_fields(b):
        if field == 1:
            entry = {"node_index": [], "score": []}
            for f2, w2, v2 in split_fields(v):
                if f2 == 1:
                    entry["node_index"] = _scalar_list(entry["node_index"], w2, v2)
                elif f2 == 2:
                    entry["score"] = _scalar_list(entry["score"], w2, v2)
            r["pods"].append(entry)
        elif field == 2:
            flat = {"pod_index": b"", "counts": b"", "node_index": b"", "score": b""}
            fkeys = {1: "pod_index", 2: "counts", 3: "node_index", 4: "score"}
            for f2, _w2, v2 in split_fields(v):
                if f2 in fkeys:
                    flat[fkeys[f2]] = v2
            r["flat"] = flat
        elif field == 3:
            r["build_ms"] = struct.unpack("<d", struct.pack("<Q", v))[0]
        elif field == 4:
            r["degraded"] = bool(v)
        elif field == 5:
            r["server_span"] = v.decode("utf-8")
    return r


def decode_assign_request(b: bytes) -> Dict:
    r = {"snapshot_id": "", "cycle_id": "", "deadline_ms": 0, "band": "",
         "trace_id": "", "parent_span": ""}
    for field, _wtype, v in split_fields(b):
        if field == 1:
            r["snapshot_id"] = v.decode("utf-8")
        elif field == 2:
            r["cycle_id"] = v.decode("utf-8")
        elif field == 3:
            r["deadline_ms"] = _signed(v)
        elif field == 4:
            r["band"] = v.decode("utf-8")
        elif field == 5:
            r["trace_id"] = v.decode("utf-8")
        elif field == 6:
            r["parent_span"] = v.decode("utf-8")
    return r


def decode_assign_reply(b: bytes) -> Dict:
    r = {
        "assignment": [], "status": [], "cycle_ms": 0.0, "path": "",
        "cycle_id": "", "server_span": "",
    }
    for field, wtype, v in split_fields(b):
        if field == 1:
            r["assignment"] = _scalar_list(r["assignment"], wtype, v)
        elif field == 2:
            r["status"] = _scalar_list(r["status"], wtype, v)
        elif field == 3:
            r["cycle_ms"] = struct.unpack("<d", struct.pack("<Q", v))[0]
        elif field == 4:
            r["path"] = v.decode("utf-8")
        elif field == 5:
            r["cycle_id"] = v.decode("utf-8")
        elif field == 6:
            r["server_span"] = v.decode("utf-8")
    return r


# ---- message layer: encoders (wire.go marshaling rules) ----

def encode_tensor(t: Dict) -> bytes:
    out = bytearray()
    if t.get("shape"):
        append_bytes_field(out, 1, pack_varints(t["shape"]))
    for field, key in ((2, "data"), (3, "delta_idx"), (4, "delta_val")):
        if t.get(key):
            append_bytes_field(out, field, bytes(t[key]))
    return bytes(out)


def _append_message(out: bytearray, field: int, body: bytes) -> None:
    """wire.go appendMessage: empty submessages are skipped entirely."""
    if body:
        append_bytes_field(out, field, body)


def _append_packed(out: bytearray, field: int, vals) -> None:
    if len(vals):
        append_bytes_field(out, field, pack_varints(vals))


def _append_repeated_strings(out: bytearray, field: int, vals) -> None:
    # repeated string elements are ALWAYS emitted, even when empty
    for s in vals:
        append_bytes_field(out, field, s.encode("utf-8"))


def encode_node_table(n: Dict) -> bytes:
    out = bytearray()
    _append_repeated_strings(out, 1, n.get("names", ()))
    _append_message(out, 2, encode_tensor(n.get("allocatable", {})))
    _append_message(out, 3, encode_tensor(n.get("requested", {})))
    _append_message(out, 4, encode_tensor(n.get("usage", {})))
    _append_packed(out, 5, [int(b) for b in n.get("metric_fresh", ())])
    _append_message(out, 6, encode_tensor(n.get("agg_usage", {})))
    _append_message(out, 7, encode_tensor(n.get("agg_fresh", {})))
    _append_message(out, 8, encode_tensor(n.get("prod_usage", {})))
    _append_packed(out, 9, n.get("accel_type", ()))
    return bytes(out)


def encode_pod_table(p: Dict) -> bytes:
    out = bytearray()
    _append_repeated_strings(out, 1, p.get("names", ()))
    _append_message(out, 2, encode_tensor(p.get("requests", {})))
    _append_message(out, 3, encode_tensor(p.get("estimated", {})))
    _append_packed(out, 4, p.get("priority", ()))
    _append_packed(out, 5, p.get("gang_id", ()))
    _append_packed(out, 6, p.get("quota_id", ()))
    _append_packed(out, 7, p.get("priority_class", ()))
    _append_packed(out, 8, p.get("workload_class", ()))
    _append_message(out, 9, encode_tensor(p.get("sensitivity", {})))
    return bytes(out)


def encode_sync_request(r: Dict) -> bytes:
    out = bytearray()
    _append_message(out, 1, encode_node_table(r.get("nodes", {})))
    _append_message(out, 2, encode_pod_table(r.get("pods", {})))
    gangs = bytearray()
    _append_packed(gangs, 1, r.get("gangs", {}).get("min_member", ()))
    _append_message(out, 3, bytes(gangs))
    quotas = bytearray()
    q = r.get("quotas", {})
    _append_message(quotas, 1, encode_tensor(q.get("runtime", {})))
    _append_message(quotas, 2, encode_tensor(q.get("used", {})))
    _append_message(quotas, 3, encode_tensor(q.get("limited", {})))
    _append_message(out, 4, bytes(quotas))
    if r.get("node_bucket"):
        append_tag(out, 5, VARINT)
        append_varint(out, r["node_bucket"])
    if r.get("pod_bucket"):
        append_tag(out, 6, VARINT)
        append_varint(out, r["pod_bucket"])
    if r.get("trace_id"):
        append_bytes_field(out, 7, r["trace_id"].encode("utf-8"))
    if r.get("parent_span"):
        append_bytes_field(out, 8, r["parent_span"].encode("utf-8"))
    terms = bytearray()
    _append_message(
        terms, 1, encode_tensor(r.get("terms", {}).get("throughput", {}))
    )
    _append_message(out, 9, bytes(terms))
    return bytes(out)


def encode_score_request(r: Dict) -> bytes:
    out = bytearray()
    if r.get("snapshot_id"):
        append_bytes_field(out, 1, r["snapshot_id"].encode("utf-8"))
    if r.get("top_k"):
        append_tag(out, 2, VARINT)
        append_varint(out, r["top_k"])
    if r.get("flat"):
        append_tag(out, 3, VARINT)
        append_varint(out, 1)
    if r.get("deadline_ms"):
        append_tag(out, 4, VARINT)
        append_varint(out, r["deadline_ms"])
    if r.get("band"):
        append_bytes_field(out, 5, r["band"].encode("utf-8"))
    if r.get("trace_id"):
        append_bytes_field(out, 6, r["trace_id"].encode("utf-8"))
    if r.get("parent_span"):
        append_bytes_field(out, 7, r["parent_span"].encode("utf-8"))
    return bytes(out)


def encode_assign_request(r: Dict) -> bytes:
    out = bytearray()
    if r.get("snapshot_id"):
        append_bytes_field(out, 1, r["snapshot_id"].encode("utf-8"))
    if r.get("cycle_id"):
        append_bytes_field(out, 2, r["cycle_id"].encode("utf-8"))
    if r.get("deadline_ms"):
        append_tag(out, 3, VARINT)
        append_varint(out, r["deadline_ms"])
    if r.get("band"):
        append_bytes_field(out, 4, r["band"].encode("utf-8"))
    if r.get("trace_id"):
        append_bytes_field(out, 5, r["trace_id"].encode("utf-8"))
    if r.get("parent_span"):
        append_bytes_field(out, 6, r["parent_span"].encode("utf-8"))
    return bytes(out)


# ---- replication stream framing ----
# Independent SECOND implementation of the leader->follower frame header
# (replication/codec.py is the first; the Go mirror is
# go/scorerclient/replica.go) — hand-rolled big-endian field walks over
# this table, no struct-format string shared with the codec, so the two
# cannot agree by accident.

REPLICA_MAGIC = 0x4B52504C  # "KRPL"
REPLICA_VERSION = 1
REPLICA_KIND_DELTA = 1
REPLICA_KIND_FULL = 2
REPLICA_KIND_HELLO = 3  # follower -> leader resume offer
REPLICA_KIND_FULL_Z = 4  # zlib-compressed full frame

REPLICA_FRAME_FIELDS = (
    ("magic", 4),
    ("version", 1),
    ("kind", 1),
    ("epoch", 8),
    ("generation", 8),
    ("stamp_us", 8),
    ("payload_len", 4),
)

_REPLICA_HEADER_LEN = sum(w for _, w in REPLICA_FRAME_FIELDS)
_REPLICA_MAX_PAYLOAD = 64 << 20  # the raw-UDS transport cap


def decode_replica_frame(b: bytes) -> Dict:
    """Decode one complete replication frame (header + payload) into a
    plain dict; raises ValueError on anything malformed — same
    rejection surface as replication/codec.py decode_frame, different
    implementation."""
    if len(b) < _REPLICA_HEADER_LEN:
        raise ValueError(
            f"truncated replica frame header ({len(b)} bytes)"
        )
    out: Dict = {}
    i = 0
    for name, width in REPLICA_FRAME_FIELDS:
        raw = b[i:i + width]
        i += width
        if name == "epoch":
            try:
                out[name] = raw.decode("ascii")
            except UnicodeDecodeError as exc:
                raise ValueError(f"non-ascii epoch {raw!r}") from exc
        else:
            out[name] = int.from_bytes(raw, "big")
    if out["magic"] != REPLICA_MAGIC:
        raise ValueError(f"bad replica frame magic {out['magic']:#x}")
    if out["version"] != REPLICA_VERSION:
        raise ValueError(f"bad replica frame version {out['version']}")
    if out["kind"] not in (
        REPLICA_KIND_DELTA, REPLICA_KIND_FULL, REPLICA_KIND_HELLO,
        REPLICA_KIND_FULL_Z,
    ):
        raise ValueError(f"bad replica frame kind {out['kind']}")
    if out["payload_len"] > _REPLICA_MAX_PAYLOAD:
        raise ValueError(
            f"replica frame payload {out['payload_len']} over cap"
        )
    payload = b[i:]
    if len(payload) != out["payload_len"]:
        raise ValueError(
            f"replica frame payload truncated: want "
            f"{out['payload_len']}, got {len(payload)}"
        )
    out["payload"] = payload
    return out


def encode_replica_frame(f: Dict) -> bytes:
    """Encode from the decode_replica_frame dict shape (payload_len is
    derived from ``payload``, never trusted from the dict)."""
    payload = bytes(f.get("payload", b""))
    values = {
        "magic": REPLICA_MAGIC,
        "version": REPLICA_VERSION,
        "kind": int(f["kind"]),
        "epoch": f["epoch"],
        "generation": int(f["generation"]),
        "stamp_us": int(f.get("stamp_us", 0)),
        "payload_len": len(payload),
    }
    if values["kind"] not in (
        REPLICA_KIND_DELTA, REPLICA_KIND_FULL, REPLICA_KIND_HELLO,
        REPLICA_KIND_FULL_Z,
    ):
        raise ValueError(f"bad replica frame kind {values['kind']}")
    out = bytearray()
    for name, width in REPLICA_FRAME_FIELDS:
        if name == "epoch":
            raw = str(values[name]).encode("ascii")
            if len(raw) != width:
                raise ValueError(
                    f"epoch must be exactly {width} ascii chars"
                )
            out.extend(raw)
        else:
            out.extend(int(values[name]).to_bytes(width, "big"))
    out.extend(payload)
    return bytes(out)
