"""Protobuf wire codec of the BatchedScorer seam, without the protobuf runtime.

Counterpart of ``koordinator_tpu/bridge/wirecheck.py``, extended to every
message of ``koordinator_tpu/bridge/scorer.proto``: the three requests and
the three replies.  Each message is a small class with the attribute names
the generated protobuf classes have (``req.nodes.allocatable.data``,
``reply.flat.pod_index``, ``reply.pods.add()``), so the servicer and the
resident state read and build them as the reference reads and builds
``scorer_pb2`` messages.  Every class has ``SerializeToString()`` and
``FromString()``.

The encoding follows the protowire spec and the protobuf runtime's rules:

* fields in ascending field-number order;
* singular proto3 scalars at their default (0, False, "", b"", 0.0) are
  skipped;
* a sub-message is written when it is present: set on the wire, or
  touched by a write (a field set, a repeated field extended, even by
  nothing, ``CopyFrom``, ``add``) — then also when it is empty;
* every element of a repeated string is written, the empty ones too (a
  dropped element would shift every later name);
* repeated scalars are packed; ``int32`` and ``int64`` values are
  two's-complement 64-bit varints, ``double`` is fixed64.

Packed varints are decoded and encoded with numpy, so a 10k-pod table costs
no Python loop per element.
"""

from __future__ import annotations

import math
import struct
from typing import List, Tuple

import numpy as np

# the gRPC service the messages travel on (``scorer.proto``'s package and
# service name)
SERVICE = "koordinator_tpu.bridge.BatchedScorer"


def method_path(name: str) -> str:
    """The gRPC path of the service's method ``name``."""
    return f"/{SERVICE}/{name}"


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
            return out & ((1 << 64) - 1), i
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
        if field == 0:
            # protobuf reserves field number 0: its runtime refuses it
            raise ValueError("invalid field number 0")
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
            out.append((field, wtype, bytes(b[i : i + n])))
            i += n
        else:
            raise ValueError(f"unsupported wire type {wtype}")
    return out


def _signed(v: int) -> int:
    """proto int32/int64 varints are two's-complement 64-bit."""
    return v - (1 << 64) if v >= 1 << 63 else v


def unpack_varints(payload: bytes) -> np.ndarray:
    """A packed varint payload as int64 values (two's complement)."""
    b = np.frombuffer(payload, np.uint8)
    if not len(b):
        return np.zeros(0, np.int64)
    if b[-1] & 0x80:
        raise ValueError("truncated varint")
    ends = np.flatnonzero(b < 0x80)
    starts = np.concatenate(([0], ends[:-1] + 1))
    lens = ends - starts + 1
    if int(lens.max()) > 10:
        raise ValueError("varint overflow")
    pos = np.arange(len(b)) - np.repeat(starts, lens)
    vals = (b & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    # the 7-bit groups do not overlap, so their sum is their union
    return np.add.reduceat(vals, starts).view(np.int64)


def pack_varints(vals) -> bytes:
    """int64 values (or anything numpy casts to them) as packed varints."""
    v = np.asarray(vals, np.int64).reshape(-1).view(np.uint64)
    if not len(v):
        return b""
    lens = np.ones(len(v), np.int64)
    for k in range(1, 10):
        lens += (v >> np.uint64(7 * k)) > 0
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    out = np.empty(int(lens.sum()), np.uint8)
    for k in range(10):
        m = lens > k
        if not m.any():
            break
        group = (v[m] >> np.uint64(7 * k)) & np.uint64(0x7F)
        more = np.where(lens[m] > k + 1, 0x80, 0).astype(np.uint64)
        out[offs[m] + k] = (group | more).astype(np.uint8)
    return out.tobytes()


# ---- message layer ----

_SCALAR_DEFAULTS = {"string": "", "bytes": b"", "int64": 0, "int32": 0,
                    "bool": False, "double": 0.0}


def _coerce(kind: str, value):
    if kind == "string":
        if not isinstance(value, str):
            raise TypeError(f"string field takes str, not {type(value).__name__}")
        return value
    if kind == "bytes":
        return bytes(value)
    if kind in ("int64", "int32"):
        v = int(value)
        bits = 64 if kind == "int64" else 32
        if not -(1 << (bits - 1)) <= v < 1 << (bits - 1):
            raise ValueError(f"value {v} out of range for {kind}")
        return v
    if kind == "bool":
        return bool(value)
    return float(value)


class _Repeated(list):
    """A repeated field: a list whose writes mark the owning message
    present, as the protobuf runtime's do."""

    __slots__ = ("_owner", "_kind", "_cls")

    def __init__(self, owner, kind, cls=None):
        super().__init__()
        self._owner = owner
        self._kind = kind
        self._cls = cls

    def _conv(self, value):
        return value if self._cls is not None else _coerce(self._kind, value)

    def append(self, value):
        self._owner._mark()
        super().append(self._conv(value))

    def extend(self, values):
        self._owner._mark()
        if isinstance(values, np.ndarray) and self._kind in ("int64", "int32"):
            bits = 64 if self._kind == "int64" else 32
            vals = values.astype(np.int64).reshape(-1)
            if len(vals) and not (-(1 << (bits - 1)) <= int(vals.min())
                                  and int(vals.max()) < 1 << (bits - 1)):
                raise ValueError(f"values out of range for {self._kind}")
            super().extend(vals.tolist())
            return
        super().extend(self._conv(v) for v in values)

    def add(self, **kwargs):
        """Append a new element of a repeated message field."""
        self._owner._mark()
        msg = self._cls(**kwargs)
        object.__setattr__(msg, "_present", True)
        super().append(msg)
        return msg

    def __setitem__(self, i, value):
        self._owner._mark()
        super().__setitem__(i, self._conv(value))


class Message:
    """Base of the seam's messages.  ``FIELDS``: (number, name, kind,
    message class or None), kind one of ``string``/``bytes``/``int64``/
    ``int32``/``bool``/``double``/``message`` or ``repeated <kind>``."""

    FIELDS: Tuple = ()

    def __init__(self, **kwargs):
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_present", False)
        for _, name, kind, cls in self.FIELDS:
            if kind.startswith("repeated"):
                object.__setattr__(self, name, _Repeated(
                    self, kind.split()[1], cls if kind == "repeated message" else None))
            elif kind != "message":
                object.__setattr__(self, name, _SCALAR_DEFAULTS[kind])
        for name, value in kwargs.items():
            spec = self._spec(name)
            if spec[2] == "message":
                getattr(self, name).CopyFrom(value)
            elif spec[2].startswith("repeated"):
                getattr(self, name).extend(value)
            else:
                setattr(self, name, value)

    @classmethod
    def _spec(cls, name):
        for spec in cls.FIELDS:
            if spec[1] == name:
                return spec
        raise AttributeError(f"{cls.__name__} has no field {name!r}")

    def __getattr__(self, name):
        # reached only for a sub-message not yet created: create it
        # unmarked, so that reading never makes it present
        spec = type(self)._spec(name)
        if spec[2] != "message":
            raise AttributeError(name)
        child = spec[3]()
        object.__setattr__(child, "_parent", self)
        object.__setattr__(self, name, child)
        return child

    def __setattr__(self, name, value):
        spec = type(self)._spec(name)
        if spec[2] == "message" or spec[2].startswith("repeated"):
            raise AttributeError(
                f"assignment not allowed to composite field {name!r}")
        object.__setattr__(self, name, _coerce(spec[2], value))
        self._mark()

    def _mark(self) -> None:
        msg = self
        while msg is not None and not msg._present:
            object.__setattr__(msg, "_present", True)
            msg = msg._parent

    def HasField(self, name: str) -> bool:
        spec = type(self)._spec(name)
        if spec[2] == "message":
            child = self.__dict__.get(name)
            return child is not None and child._present
        return getattr(self, name) != _SCALAR_DEFAULTS[spec[2]]

    def SetInParent(self) -> None:
        self._mark()

    def ClearField(self, name: str) -> None:
        """Reset field ``name`` to its default: a sub-message absent, a
        repeated field empty, a scalar its zero value."""
        spec = type(self)._spec(name)
        kind = spec[2]
        if kind == "message":
            self.__dict__.pop(name, None)
        elif kind.startswith("repeated"):
            object.__setattr__(self, name, _Repeated(
                self, kind.split()[1], spec[3] if kind == "repeated message" else None))
        else:
            object.__setattr__(self, name, _SCALAR_DEFAULTS[kind])

    def Clear(self) -> None:
        parent, present = self._parent, self._present
        self.__init__()
        object.__setattr__(self, "_parent", parent)
        object.__setattr__(self, "_present", present)

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom takes a {type(self).__name__}")
        if other is self:
            self._mark()
            return
        self.Clear()
        # present empty sub-messages are on the wire, so the copy keeps them
        self._merge(other.SerializeToString())
        self._mark()

    def __eq__(self, other):
        return type(other) is type(self) and (
            self.SerializeToString() == other.SerializeToString())

    __hash__ = None

    def __repr__(self):
        parts = []
        for _, name, kind, _ in self.FIELDS:
            if kind == "message":
                if self.HasField(name):
                    parts.append(f"{name}={getattr(self, name)!r}")
            elif kind.startswith("repeated"):
                if getattr(self, name):
                    parts.append(f"{name}={list(getattr(self, name))!r}")
            elif self.HasField(name):
                parts.append(f"{name}={getattr(self, name)!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encoding --
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for num, name, kind, _ in self.FIELDS:
            value = self.__dict__.get(name)
            if kind == "message":
                if value is not None and value._present:
                    append_bytes_field(out, num, value.SerializeToString())
            elif kind == "repeated message":
                for msg in value:
                    append_bytes_field(out, num, msg.SerializeToString())
            elif kind == "repeated string":
                for s in value:
                    append_bytes_field(out, num, s.encode("utf-8"))
            elif kind.startswith("repeated"):
                if value:
                    append_bytes_field(out, num, pack_varints(value))
            elif value == _SCALAR_DEFAULTS[kind] and not (
                    kind == "double" and math.copysign(1.0, value) < 0):
                continue  # the default; -0.0 has bits set and is written
            elif kind == "string":
                append_bytes_field(out, num, value.encode("utf-8"))
            elif kind == "bytes":
                append_bytes_field(out, num, value)
            elif kind == "double":
                append_tag(out, num, FIXED64)
                out.extend(struct.pack("<d", value))
            else:
                append_tag(out, num, VARINT)
                append_varint(out, int(value))
        return bytes(out)

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    # -- decoding --
    @classmethod
    def FromString(cls, b: bytes) -> "Message":
        msg = cls()
        msg._merge(b)
        object.__setattr__(msg, "_present", True)
        return msg

    def _merge(self, b: bytes) -> None:
        by_num = {spec[0]: spec for spec in self.FIELDS}
        for num, wtype, v in split_fields(b):
            spec = by_num.get(num)
            if spec is None:
                continue  # unknown field: skipped
            _, name, kind, _ = spec
            if kind in ("message", "repeated message", "string", "bytes",
                        "repeated string"):
                if wtype != BYTES:
                    raise ValueError(f"field {name}: wire type {wtype}, want {BYTES}")
                if kind == "message":
                    child = getattr(self, name)
                    child._merge(v)
                    child._mark()
                elif kind == "repeated message":
                    list.append(getattr(self, name), spec[3].FromString(v))
                elif kind == "bytes":
                    object.__setattr__(self, name, v)
                else:
                    s = v.decode("utf-8")
                    if kind == "string":
                        object.__setattr__(self, name, s)
                    else:
                        list.append(getattr(self, name), s)
                self._mark()
            elif kind.startswith("repeated"):
                if wtype == BYTES:
                    vals = unpack_varints(v)
                elif wtype == VARINT:
                    vals = np.asarray([v], np.uint64).view(np.int64)
                else:
                    raise ValueError(f"field {name}: wire type {wtype}")
                elem = kind.split()[1]
                if elem == "int32":
                    vals = vals.astype(np.int32)
                vals = vals.tolist() if elem != "bool" else [bool(x) for x in vals]
                list.extend(getattr(self, name), vals)
                self._mark()
            elif kind == "double":
                if wtype != FIXED64:
                    raise ValueError(f"field {name}: wire type {wtype}, want {FIXED64}")
                object.__setattr__(self, name, struct.unpack("<d", struct.pack("<Q", v))[0])
                self._mark()
            else:
                if wtype != VARINT:
                    raise ValueError(f"field {name}: wire type {wtype}, want {VARINT}")
                if kind == "bool":
                    val = bool(v)
                elif kind == "int32":
                    val = int(np.int64(_signed(v)).astype(np.int32))
                else:
                    val = _signed(v)
                object.__setattr__(self, name, val)
                self._mark()


# ---- the messages of scorer.proto ----

class Tensor(Message):
    FIELDS = (
        (1, "shape", "repeated int64", None),
        (2, "data", "bytes", None),
        (3, "delta_idx", "bytes", None),
        (4, "delta_val", "bytes", None),
    )


class NodeTable(Message):
    FIELDS = (
        (1, "names", "repeated string", None),
        (2, "allocatable", "message", Tensor),
        (3, "requested", "message", Tensor),
        (4, "usage", "message", Tensor),
        (5, "metric_fresh", "repeated bool", None),
        (6, "agg_usage", "message", Tensor),
        (7, "agg_fresh", "message", Tensor),
        (8, "prod_usage", "message", Tensor),
        (9, "accel_type", "repeated int32", None),
    )


class PodTable(Message):
    FIELDS = (
        (1, "names", "repeated string", None),
        (2, "requests", "message", Tensor),
        (3, "estimated", "message", Tensor),
        (4, "priority", "repeated int64", None),
        (5, "gang_id", "repeated int32", None),
        (6, "quota_id", "repeated int32", None),
        (7, "priority_class", "repeated int32", None),
        (8, "workload_class", "repeated int32", None),
        (9, "sensitivity", "message", Tensor),
    )


class GangTable(Message):
    FIELDS = ((1, "min_member", "repeated int32", None),)


class TermTable(Message):
    FIELDS = ((1, "throughput", "message", Tensor),)


class QuotaTable(Message):
    FIELDS = (
        (1, "runtime", "message", Tensor),
        (2, "used", "message", Tensor),
        (3, "limited", "message", Tensor),
    )


class SyncRequest(Message):
    FIELDS = (
        (1, "nodes", "message", NodeTable),
        (2, "pods", "message", PodTable),
        (3, "gangs", "message", GangTable),
        (4, "quotas", "message", QuotaTable),
        (5, "node_bucket", "int64", None),
        (6, "pod_bucket", "int64", None),
        (7, "trace_id", "string", None),
        (8, "parent_span", "string", None),
        (9, "terms", "message", TermTable),
    )


class SyncReply(Message):
    FIELDS = (
        (1, "snapshot_id", "string", None),
        (2, "nodes", "int64", None),
        (3, "pods", "int64", None),
        (4, "server_span", "string", None),
    )


class ScoreRequest(Message):
    FIELDS = (
        (1, "snapshot_id", "string", None),
        (2, "top_k", "int64", None),
        (3, "flat", "bool", None),
        (4, "deadline_ms", "int64", None),
        (5, "band", "string", None),
        (6, "trace_id", "string", None),
        (7, "parent_span", "string", None),
    )


class NodeScoreList(Message):
    FIELDS = (
        (1, "node_index", "repeated int32", None),
        (2, "score", "repeated int64", None),
    )


class FlatScores(Message):
    FIELDS = (
        (1, "pod_index", "bytes", None),
        (2, "counts", "bytes", None),
        (3, "node_index", "bytes", None),
        (4, "score", "bytes", None),
    )


class ScoreReply(Message):
    FIELDS = (
        (1, "pods", "repeated message", NodeScoreList),
        (2, "flat", "message", FlatScores),
        (3, "build_ms", "double", None),
        (4, "degraded", "bool", None),
        (5, "server_span", "string", None),
    )


class AssignRequest(Message):
    FIELDS = (
        (1, "snapshot_id", "string", None),
        (2, "cycle_id", "string", None),
        (3, "deadline_ms", "int64", None),
        (4, "band", "string", None),
        (5, "trace_id", "string", None),
        (6, "parent_span", "string", None),
    )


class AssignReply(Message):
    FIELDS = (
        (1, "assignment", "repeated int32", None),
        (2, "status", "repeated int32", None),
        (3, "cycle_ms", "double", None),
        (4, "path", "string", None),
        (5, "cycle_id", "string", None),
        (6, "server_span", "string", None),
    )


# the six messages the seam's three RPCs carry
MESSAGES = (SyncRequest, SyncReply, ScoreRequest, ScoreReply, AssignRequest,
            AssignReply)
