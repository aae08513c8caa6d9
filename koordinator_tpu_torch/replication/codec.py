"""Replication stream frame codec.

The leader daemon streams every committed Sync to its followers as the
**already-encoded** ``SyncRequest`` wire bytes (the delta economics of
``go/scorerclient/delta.go`` ride along for free: a warm frame is the
same few-hundred-byte sparse delta the client shipped).  This module
owns the frame layout — the one place the header fields, their emit
order and their widths are stated in Python; ``bridge/wirecheck.py``
carries an independent second implementation and
``go/scorerclient/replica.go`` the Go-side mirror.  The port's own copy
of ``koordinator_tpu/replication/codec.py``: the frames are byte-identical,
so a port follower applies a reference leader's stream and back.

Frame (all integers big-endian, matching the raw-UDS scorer framing)::

    magic        u32   0x4B52504C ("KRPL")
    version      u8    1
    kind         u8    1 = delta (payload applies onto gen-1),
                       2 = full  (payload replaces all resident state),
                       3 = hello (follower->leader resume offer: the
                           follower's chain position; the payload is a
                           capability string — empty for legacy
                           subscribers, ``z`` = "I accept zlib full
                           frames"),
                       4 = full_z (a kind=full frame whose payload is
                           level-1 zlib; only ever sent to a
                           subscriber that advertised ``z`` in its
                           hello — the wire stays byte-compatible with
                           pre-compression peers)
    epoch        8s    the leader's per-boot epoch (8 hex chars — the
                       <epoch> of "s<epoch>-<gen>" snapshot ids)
    generation   u64   generation AFTER applying the payload
    stamp_us     u64   leader commit wall clock, microseconds since the
                       unix epoch (feeds koord_scorer_replica_lag_ms)
    payload_len  u32   length of the SyncRequest bytes that follow
                       (0 is legal for a kind=full frame: "reset to the
                       empty pre-first-Sync state at this generation")

The ``s<epoch>-<gen>`` snapshot id doubles as the fencing token: a
follower applies a delta frame ONLY when it extends the exact chain it
is on (same epoch, generation + 1).  Anything else — a gap from a
dropped frame, a duplicate from a reordering transport, a fresh epoch
from a leader restart — is a detected discontinuity, and the follower's
documented response is the one-shot full resync (reconnect; the leader
opens every subscription with a kind=full frame).  A follower never
serves a torn snapshot: frames stage-then-commit through the same
atomic ``bridge/state.py`` seam client Syncs use.
"""

from __future__ import annotations

import dataclasses
import struct

# Header constants.  replica.go (Go) and wirecheck.py (independent
# Python mirror) restate these.
MAGIC = 0x4B52504C  # "KRPL"
VERSION = 1
KIND_DELTA = 1
KIND_FULL = 2
# subscription resume offer: sent FOLLOWER -> LEADER as the
# first frame of a new subscription — epoch/generation carry the
# follower's current chain position, payload is empty.  A leader whose
# journal covers that position answers with just the missing delta
# frames (no full-state resync); any other leader (or no hello at all,
# the pre-journal subscriber) gets the opening kind=full frame.
KIND_HELLO = 3
# compressed full frame: the same reset semantics as
# KIND_FULL, payload zlib-compressed at level 1 on the wire ONLY — the
# journal keeps raw KIND_FULL bytes, and a subscriber only ever sees
# kind 4 after offering the CAP_COMPRESS capability in its hello.
# Sparse-scale full resyncs are hundreds of MB of mostly-sentinel int64
# tensors; level-1 zlib trades a few ms of CPU for a ~10x smaller storm.
KIND_FULL_Z = 4

_KINDS = (KIND_DELTA, KIND_FULL, KIND_HELLO, KIND_FULL_Z)

# hello capability bytes (the hello payload is a flat ascii capability
# string; unknown bytes are ignored by both sides, so capabilities are
# forward- and backward-compatible: a legacy leader drains the payload
# unread, a legacy follower sends none)
CAP_COMPRESS = b"z"

# zlib level for KIND_FULL_Z payloads: level 1 is the latency-friendly
# point — the full frame rides the subscription-open path, where encode
# time is paid under the publisher lock
COMPRESS_LEVEL = 1


def compress_payload(payload: bytes) -> bytes:
    """The KIND_FULL_Z wire payload for a raw full-state payload."""
    import zlib

    return zlib.compress(payload, COMPRESS_LEVEL)


def decompress_payload(payload: bytes, max_bytes: int = 0) -> bytes:
    """Inverse of :func:`compress_payload`; raises :class:`FrameError`
    on corrupt input or a decompressed size past ``max_bytes`` (default
    :data:`MAX_PAYLOAD`) — a hostile tiny frame must not balloon into
    an unbounded allocation."""
    import zlib

    cap = max_bytes or MAX_PAYLOAD
    try:
        d = zlib.decompressobj()
        out = d.decompress(payload, cap)
        if d.unconsumed_tail:
            raise FrameError(
                f"compressed full frame inflates past the {cap}-byte cap"
            )
        out += d.flush()
        if len(out) > cap:
            raise FrameError(
                f"compressed full frame inflates past the {cap}-byte cap"
            )
        return out
    except zlib.error as exc:
        raise FrameError(f"corrupt compressed full frame: {exc}") from exc

# the one statement of the header layout: (field, byte width) in emit
# order — the wire-contract rule parses this table by AST and diffs it
# against replica.go's replicaFrameFields and wirecheck.py's
# REPLICA_FRAME_FIELDS, so the three codecs cannot drift apart silently
FRAME_FIELDS = (
    ("magic", 4),
    ("version", 1),
    ("kind", 1),
    ("epoch", 8),
    ("generation", 8),
    ("stamp_us", 8),
    ("payload_len", 4),
)

_HEADER = ">IBB8sQQI"
HEADER_LEN = struct.calcsize(_HEADER)
assert HEADER_LEN == sum(w for _, w in FRAME_FIELDS)

# mirrors the raw-UDS transport's frame cap (bridge/udsserver.py
# _MAX_FRAME): a full 10k x 2k SyncRequest is a few MB; anything past
# 64 MiB is a malformed or hostile frame, not a snapshot
MAX_PAYLOAD = 64 << 20


class FrameError(ValueError):
    """A malformed replication frame (bad magic/version/kind, oversized
    or truncated).  The follower's response is always the same: count
    it, drop the stream, full-resync — never apply a suspect frame."""


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: int
    epoch: str
    generation: int
    stamp_us: int
    payload: bytes

    @property
    def snapshot_id(self) -> str:
        return f"s{self.epoch}-{self.generation}"


def encode_frame(
    kind: int, epoch: str, generation: int, stamp_us: int, payload: bytes
) -> bytes:
    """Serialize one frame.  ``epoch`` must be the 8-char per-boot hex
    nonce every servicer mints (bridge/server.py) — a fixed-width field
    keeps the header seekable without a second length prefix."""
    if kind not in _KINDS:
        raise FrameError(f"unknown frame kind {kind}")
    raw_epoch = epoch.encode("ascii")
    if len(raw_epoch) != 8:
        raise FrameError(
            f"epoch must be exactly 8 ascii chars, got {epoch!r}"
        )
    if generation < 0:
        raise FrameError(f"negative generation {generation}")
    if len(payload) > MAX_PAYLOAD:
        raise FrameError(
            f"payload of {len(payload)} bytes exceeds the "
            f"{MAX_PAYLOAD}-byte frame cap"
        )
    return struct.pack(
        _HEADER, MAGIC, VERSION, kind, raw_epoch,
        generation, stamp_us, len(payload),
    ) + payload


def decode_header(header: bytes):
    """Decode the fixed 34-byte header; returns ``(frame, payload_len)``
    where ``frame`` carries an empty payload the stream reader replaces
    after reading ``payload_len`` more bytes — see :func:`decode_frame`
    for whole-buffer decoding.  Raises :class:`FrameError` on any
    malformed field."""
    if len(header) != HEADER_LEN:
        raise FrameError(
            f"frame header is {len(header)} bytes, want {HEADER_LEN}"
        )
    magic, version, kind, raw_epoch, gen, stamp_us, plen = struct.unpack(
        _HEADER, header
    )
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic:#x} (want {MAGIC:#x})")
    if version != VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if kind not in _KINDS:
        raise FrameError(f"unknown frame kind {kind}")
    if plen > MAX_PAYLOAD:
        raise FrameError(
            f"frame payload of {plen} bytes exceeds the "
            f"{MAX_PAYLOAD}-byte cap"
        )
    try:
        epoch = raw_epoch.decode("ascii")
    except UnicodeDecodeError as exc:
        raise FrameError(f"non-ascii epoch field {raw_epoch!r}") from exc
    return Frame(kind=kind, epoch=epoch, generation=gen,
                 stamp_us=stamp_us, payload=b""), plen


def decode_frame(buf: bytes) -> Frame:
    """Decode one complete frame from ``buf`` (header + payload, exact
    length).  Raises :class:`FrameError` when truncated, oversized or
    malformed — a reordering/lossy transport can hand a follower any
    prefix, and every such prefix must be a detected discontinuity."""
    if len(buf) < HEADER_LEN:
        raise FrameError(
            f"truncated frame: {len(buf)} bytes is shorter than the "
            f"{HEADER_LEN}-byte header"
        )
    frame, plen = decode_header(buf[:HEADER_LEN])
    payload = buf[HEADER_LEN:]
    if len(payload) != plen:
        raise FrameError(
            f"frame payload truncated: header promises {plen} bytes, "
            f"got {len(payload)}"
        )
    return dataclasses.replace(frame, payload=payload)
