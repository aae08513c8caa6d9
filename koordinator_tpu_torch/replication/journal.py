"""Durable frame journal: crash tolerance for the serving tier.

Counterpart of ``koordinator_tpu/replication/journal.py``, with the same
file format: a journal either package writes, the other recovers.

The replication stream already reduces every committed Sync to its
already-encoded wire bytes (replication/codec.py frames — a warm delta
is a few hundred bytes).  Those frames are the perfect durability unit,
so crash tolerance is an append, a replay and a truncate:

* the leader APPENDS every committed frame's encoded bytes to a
  length-prefixed, CRC'd journal file under ``--state-dir`` (the same
  bytes ``ReplicationPublisher`` fans out — encoded once, shared);
* every ``compact_every`` delta frames the journal COMPACTS: the full
  state (``export_sync_request``) is written as one ``kind=full``
  frame into a fresh file that atomically replaces the old one, so the
  journal's size tracks the cluster, not its history;
* on restart the daemon REPLAYS the journal through the existing
  stage/commit seam (``apply_replica_frame`` — the very path follower
  frames take) and resumes the SAME ``s<epoch>-<gen>`` chain, so
  reconnecting clients pass their delta-continuity check and
  reconnecting followers resume from their position (leader.py's hello
  handshake reads :meth:`FrameJournal.frames_since`) — no resync storm;
* a torn or corrupt tail (the crash landed mid-append, a disk flipped
  a bit) TRUNCATES to the last valid record and recovery proceeds from
  there — the daemon never serves a torn snapshot, because every frame
  it replays went through the same stage-then-commit atomicity a live
  frame does.

Record layout (all integers big-endian, like every framing here)::

    length   u32   byte length of the frame that follows
    crc32    u32   zlib.crc32 of the frame bytes
    frame    ...   one replication/codec.py frame (header + payload)

Validation on open walks records until the first invalid one (short
read, absurd length, CRC mismatch, frame decode failure) and truncates
there.
"""

from __future__ import annotations

import logging
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.obs.lockwitness import witness_lock
from koordinator_tpu_torch.replication import codec

logger = logging.getLogger(__name__)

_REC_HEADER = ">II"
_REC_HEADER_LEN = struct.calcsize(_REC_HEADER)
_MAX_RECORD = codec.HEADER_LEN + codec.MAX_PAYLOAD

DEFAULT_COMPACT_EVERY = 256


class JournalError(Exception):
    """The journal file cannot be used at all (unreadable directory,
    truncation failed).  A corrupt TAIL is not an error — it is the
    documented truncate-and-recover path."""


class FrameJournal:
    """Append/replay/compact over one journal file.

    Thread contract: ``append``/``compact`` run on the leader's Sync
    path (the servicer calls the hook under its ``_sync_lock``, so
    appends are strictly generation-ordered); ``frames_since`` runs on
    the publisher's subscription path concurrently — everything shared
    sits under one small lock, and resume reads use their own file
    handle so a subscription can never move the append offset.

    ``fsync=True`` makes every append durable against power loss, at a
    per-commit fsync cost; the default ``False`` flushes to the OS
    (durable against process crash — the SIGKILL the chaos harness
    throws — which is the failure mode this tier replicates against;
    machine-loss durability is what the follower tier itself is for).
    """

    def __init__(
        self,
        path: str,
        compact_every: int = DEFAULT_COMPACT_EVERY,
        fsync: bool = False,
        clock=time.time,
    ):
        self.path = path
        self.compact_every = max(1, int(compact_every))
        self.fsync = bool(fsync)
        self._clock = clock
        self._lock = witness_lock("replication.journal.FrameJournal._lock")
        self._fh = None
        self._metrics = None
        self._exporter = None
        # the contiguous resumable chain: the LAST full frame's
        # (epoch, generation) plus every delta extending it, mapped
        # gen -> (offset, record length) for leader.py's delta resume
        self._epoch: Optional[str] = None
        self._base_gen: Optional[int] = None
        self._last_gen: Optional[int] = None
        self._chain: Dict[int, Tuple[int, int]] = {}
        self._end = 0  # append offset == validated-prefix end
        self._deltas_since_compact = 0
        # lifetime stats (healthz + bench feed)
        self.appends = 0
        self.compactions = 0
        self.truncations = 0
        self.replayed_frames = 0
        self.replay_ms: Optional[float] = None
        self.last_append_us: Optional[float] = None
        self.last_compaction_us: Optional[int] = None
        self.last_truncate_reason: Optional[str] = None

    # -- wiring --
    def attach(self, servicer) -> "FrameJournal":
        """Hook the servicer's Sync commit path (`journal_hook`, called
        BEFORE the replication publisher's hook: durability first, then
        fan-out) and adopt its metrics/export seams."""
        servicer.journal_hook = self.on_sync_committed
        self._exporter = servicer.export_replication_snapshot
        telemetry = getattr(servicer, "telemetry", None)
        self._metrics = getattr(telemetry, "metrics", None)
        self._publish_gauges()
        return self

    def detach(self, servicer) -> None:
        if getattr(servicer, "journal_hook", None) is self.on_sync_committed:
            servicer.journal_hook = None

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- the servicer hook (leader _sync_lock held) --
    def on_sync_committed(self, req, snapshot_id: str, wire_bytes=None) -> None:
        from koordinator_tpu_torch.bridge.client import parse_snapshot_id

        epoch, gen = parse_snapshot_id(snapshot_id)
        payload = (
            wire_bytes if wire_bytes is not None else req.SerializeToString()
        )
        frame = codec.encode_frame(
            codec.KIND_DELTA, epoch, gen, int(self._clock() * 1e6), payload
        )
        self.append_frame(frame, codec.KIND_DELTA, epoch, gen)
        if self._deltas_since_compact >= self.compact_every:
            self._compact_from_exporter()

    # -- appends --
    def append_frame(self, frame: bytes, kind: int, epoch: str,
                     gen: int) -> None:
        t0 = time.perf_counter()
        rec = struct.pack(_REC_HEADER, len(frame), zlib.crc32(frame)) + frame
        with self._lock:
            fh = self._open_locked()
            fh.write(rec)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
            off = self._end
            self._end += len(rec)
            self._track_locked(kind, epoch, gen, off, len(rec))
            if kind == codec.KIND_DELTA:
                self._deltas_since_compact += 1
            self.appends += 1
            self.last_append_us = (time.perf_counter() - t0) * 1e6
        m = self._metrics
        if m is not None:
            m.count_journal("append")
            m.observe_journal_append_us(self.last_append_us)
        self._publish_gauges()

    def write_base(self, epoch: str, gen: int, payload: bytes,
                   stamp_us: Optional[int] = None) -> None:
        """Reset the journal to ONE full-state frame at (epoch, gen) —
        the compaction primitive, also used to seed a fresh journal and
        to open a promoted follower's own journal.  Atomic: the new
        file is written beside the old and ``os.replace``d over it, so
        a crash mid-compaction leaves the previous journal intact."""
        stamp = int(self._clock() * 1e6) if stamp_us is None else stamp_us
        frame = codec.encode_frame(
            codec.KIND_FULL, epoch, gen, stamp, payload
        )
        rec = struct.pack(_REC_HEADER, len(frame), zlib.crc32(frame)) + frame
        tmp = self.path + ".compact"
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            with open(tmp, "wb") as fh:
                fh.write(rec)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            self._epoch = epoch
            self._base_gen = self._last_gen = gen
            self._chain = {}
            self._end = len(rec)
            self._deltas_since_compact = 0
            self.compactions += 1
            self.last_compaction_us = stamp
        m = self._metrics
        if m is not None:
            m.count_journal("compact")
            m.set_journal_compaction_stamp(stamp)
        self._publish_gauges()

    def _compact_from_exporter(self) -> None:
        if self._exporter is None:
            return
        try:
            epoch, gen, payload = self._exporter()
            self.write_base(epoch, gen, payload)
        except Exception:  # compaction is an optimization of journal SIZE; a failed compaction must cost disk, never the acked write it rides behind
            logger.exception("journal compaction failed; appends continue")

    def _track_locked(self, kind: int, epoch: str, gen: int, off: int,
                      rec_len: int) -> None:
        if kind == codec.KIND_FULL:
            self._epoch = epoch
            self._base_gen = self._last_gen = gen
            self._chain = {}
        elif (
            epoch == self._epoch
            and self._last_gen is not None
            and gen == self._last_gen + 1
        ):
            self._chain[gen] = (off, rec_len)
            self._last_gen = gen
        # anything else (paranoia: an out-of-chain append) stays in the
        # file but outside the resumable chain — replay still handles it

    def _open_locked(self):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab")
        return self._fh

    # -- introspection --
    def position(self) -> Tuple[Optional[str], Optional[int]]:
        with self._lock:
            return self._epoch, self._last_gen

    def size_bytes(self) -> int:
        with self._lock:
            return self._end

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "epoch": self._epoch,
                "generation": self._last_gen,
                "bytes": self._end,
                "appends": self.appends,
                "compactions": self.compactions,
                "truncations": self.truncations,
                "replayed_frames": self.replayed_frames,
                "replay_ms": self.replay_ms,
                "last_append_us": self.last_append_us,
                "last_compaction_us": self.last_compaction_us,
                "last_truncate_reason": self.last_truncate_reason,
                "deltas_since_compact": self._deltas_since_compact,
                "compact_every": self.compact_every,
            }

    def _publish_gauges(self) -> None:
        m = self._metrics
        if m is None:
            return
        with self._lock:
            gen, size = self._last_gen, self._end
        if gen is not None:
            m.set_journal_position(gen)
        m.set_journal_bytes(size)

    # -- scan / recover / resume --
    def _scan(self) -> Tuple[List[Tuple[int, int, "codec.Frame"]], int,
                             Optional[str]]:
        """Validate the file front to back.  Returns
        ``(records, valid_end, bad_reason)`` where ``records`` is
        ``[(offset, record_len, frame), ...]`` for the valid prefix and
        ``bad_reason`` names the first invalid record (None = clean)."""
        records: List[Tuple[int, int, "codec.Frame"]] = []
        try:
            with open(self.path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return records, 0, None
        off = 0
        while off < len(data):
            if off + _REC_HEADER_LEN > len(data):
                return records, off, "torn-header"
            length, crc = struct.unpack_from(_REC_HEADER, data, off)
            if length < codec.HEADER_LEN or length > _MAX_RECORD:
                return records, off, "bad-length"
            body_start = off + _REC_HEADER_LEN
            if body_start + length > len(data):
                return records, off, "torn-frame"
            frame_bytes = data[body_start:body_start + length]
            if zlib.crc32(frame_bytes) != crc:
                return records, off, "crc"
            try:
                frame = codec.decode_frame(frame_bytes)
            except codec.FrameError:
                return records, off, "decode"
            rec_len = _REC_HEADER_LEN + length
            records.append((off, rec_len, frame))
            off += rec_len
        return records, off, None

    def _truncate_locked(self, end: int, reason: str) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        try:
            with open(self.path, "r+b") as fh:
                fh.truncate(end)
        except FileNotFoundError:
            pass
        except OSError as exc:
            raise JournalError(
                f"cannot truncate journal {self.path} to its valid "
                f"{end}-byte prefix: {exc}"
            ) from exc
        self._end = end
        self.truncations += 1
        self.last_truncate_reason = reason
        logger.warning(
            "journal %s truncated to %d bytes (%s): recovery resumes "
            "from the last valid frame",
            self.path, end, reason,
        )
        if self._metrics is not None:
            self._metrics.count_journal("truncate")

    def recover(self, servicer) -> dict:
        """Replay the journal into ``servicer`` through the stage/commit
        seam and leave the journal open for appends at the end of the
        applied prefix.

        Continuity during replay mirrors the follower applier: a full
        frame resets and (re)bases the chain, a delta extending the
        chain applies, a delta at-or-behind the chain position is a
        STALE no-op kept in place (the compaction-snapshot-newer-than-
        tail shape), and a gap/epoch-jump/apply-failure ends the usable
        prefix — everything from that frame on is truncated away.  A
        missing or empty journal seeds itself with the servicer's
        current full state, so the file ALWAYS begins with a full
        frame."""
        t0 = time.perf_counter()
        records, valid_end, bad = self._scan()
        applied = stale = 0
        resumed_id = None
        stop_reason: Optional[str] = None
        stop_off: Optional[int] = None
        pos: Optional[Tuple[str, int]] = None
        kept: List[Tuple[int, int, int, str, int]] = []
        for off, rec_len, frame in records:
            if frame.kind == codec.KIND_FULL:
                try:
                    servicer.apply_replica_frame(
                        frame, origin="journal_replay"
                    )
                except Exception:  # a frame that fails validation ends the usable prefix — the documented truncate-and-recover path; state is untouched by stage-then-commit
                    logger.exception(
                        "journal full frame %s failed to apply; "
                        "truncating", frame.snapshot_id,
                    )
                    stop_reason, stop_off = "apply", off
                    break
                pos = (frame.epoch, frame.generation)
                applied += 1
            else:
                if pos is None:
                    # a delta with no full base in front of it: the
                    # chain it extends is not in this file
                    stop_reason, stop_off = "no-base", off
                    break
                epoch, gen = pos
                if frame.epoch != epoch or frame.generation > gen + 1:
                    stop_reason, stop_off = "gap", off
                    break
                if frame.generation <= gen:
                    stale += 1  # kept in place, not re-applied
                    kept.append(
                        (off, rec_len, frame.kind, frame.epoch,
                         frame.generation)
                    )
                    continue
                try:
                    # origin names the span a traced frame opens
                    #: a replay-on-boot joins the SAME trace
                    # as the leader commit it re-applies
                    servicer.apply_replica_frame(
                        frame, origin="journal_replay"
                    )
                except Exception:  # same truncate-and-recover contract as the full-frame apply above
                    logger.exception(
                        "journal delta frame %s failed to apply; "
                        "truncating", frame.snapshot_id,
                    )
                    stop_reason, stop_off = "apply", off
                    break
                pos = (frame.epoch, frame.generation)
                applied += 1
            kept.append(
                (off, rec_len, frame.kind, frame.epoch, frame.generation)
            )
        with self._lock:
            if stop_off is not None:
                self._truncate_locked(stop_off, stop_reason)
            elif bad is not None:
                self._truncate_locked(valid_end, bad)
            else:
                self._end = valid_end
            # rebuild the resumable chain from the kept prefix
            self._epoch = self._base_gen = self._last_gen = None
            self._chain = {}
            self._deltas_since_compact = 0
            for off, rec_len, kind, epoch, gen in kept:
                self._track_locked(kind, epoch, gen, off, rec_len)
                if kind == codec.KIND_DELTA:
                    self._deltas_since_compact += 1
        truncated = stop_reason if stop_reason is not None else bad
        self.replayed_frames = applied
        self.replay_ms = (time.perf_counter() - t0) * 1000.0
        if pos is None:
            # nothing usable (fresh journal, or unusable from byte 0):
            # seed with the servicer's CURRENT state so the file starts
            # with a full frame and the chain is live immediately
            epoch, gen, payload = servicer.export_replication_snapshot()
            self.write_base(epoch, gen, payload)
        elif truncated is not None:
            # the truncated tail frames may already have been PUBLISHED
            # before the crash: resuming the identical chain would
            # re-mint those generation numbers with different content —
            # a fork the epoch fence cannot see.  Rebase onto a fresh
            # epoch (clients/followers take the ordinary fenced
            # one-shot full resync) and compact the journal to match.
            rebase = getattr(servicer, "rebase_epoch", None)
            if rebase is not None:
                rebase()
            epoch, gen, payload = servicer.export_replication_snapshot()
            self.write_base(epoch, gen, payload)
        if applied:
            resumed_id = servicer.snapshot_id()
        m = self._metrics
        if m is not None and applied:
            m.count_journal("replay", applied)
        self._publish_gauges()
        return {
            "replayed_frames": applied,
            "stale_frames": stale,
            "replay_ms": self.replay_ms,
            "resumed_id": resumed_id,
            "truncated": truncated,
        }

    def frames_since(self, epoch: str, generation: int,
                     limit_bytes: int = 256 << 20) -> Optional[List[bytes]]:
        """The delta frames extending ``(epoch, generation)`` up to the
        journal's position, as encoded frame bytes — the leader's
        resume answer to a follower hello.  ``None`` means the journal
        cannot bridge that position (different epoch, position before
        the last compaction base, or ahead of the chain) and the caller
        must fall back to the full-frame subscription open."""
        with self._lock:
            if (
                self._epoch != epoch
                or self._base_gen is None
                or generation < self._base_gen
                or generation > (self._last_gen or -1)
            ):
                return None
            wanted = [
                self._chain[g]
                for g in range(generation + 1, self._last_gen + 1)
                if g in self._chain
            ]
            if len(wanted) != (self._last_gen - generation):
                return None  # chain hole (should not happen)
        out: List[bytes] = []
        total = 0
        want_gen = generation + 1
        try:
            with open(self.path, "rb") as fh:
                for off, rec_len in wanted:
                    fh.seek(off + _REC_HEADER_LEN)
                    frame = fh.read(rec_len - _REC_HEADER_LEN)
                    if len(frame) != rec_len - _REC_HEADER_LEN:
                        return None
                    # re-validate AFTER the read: a concurrent
                    # compaction os.replace()s the file, so an offset
                    # computed against the old file can resolve into
                    # the new one's bytes — a frame that does not
                    # decode to exactly the chain entry the index
                    # promised must never reach a subscriber
                    try:
                        decoded = codec.decode_frame(frame)
                    except codec.FrameError:
                        return None
                    if (
                        decoded.kind != codec.KIND_DELTA
                        or decoded.epoch != epoch
                        or decoded.generation != want_gen
                    ):
                        return None
                    want_gen += 1
                    total += len(frame)
                    if total > limit_bytes:
                        return None
                    out.append(frame)
        except OSError:
            return None
        return out


class RelayFrameCache:
    """In-memory ``frames_since`` for a relay.

    A relay re-publishes its parent's delta stream on its own ``.repl``
    socket, and its DESCENDANTS resume through the same hello handshake
    a leader serves from its :class:`FrameJournal`.  A relay has no
    journal (durability lives at the root; a relay is a fan-out
    amplifier), so this cache keeps the recent raw delta frame bytes —
    the exact bytes forwarded, still byte-identical to the root's — in
    a bounded in-memory window and answers :meth:`frames_since` with
    :class:`FrameJournal`-identical semantics: ``None`` whenever the
    window cannot bridge the offered position (the caller falls back to
    the full-frame subscription open, served from the relay's own
    state).

    ``note_full(epoch, gen)`` rebases the window on every full frame
    the relay APPLIES (a full resets the chain exactly as a compaction
    base does); ``add_delta`` extends it and evicts from the front once
    ``max_bytes`` is exceeded — an evicted position simply resumes via
    the full-frame open.  Thread contract: the relay's one subscriber
    pump thread writes, the relay publisher's subscription threads read
    ``frames_since`` concurrently — one small lock covers both."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = max(1, int(max_bytes))
        self._lock = witness_lock(
            "replication.journal.RelayFrameCache._lock")
        self._epoch: Optional[str] = None
        self._base_gen: Optional[int] = None
        self._last_gen: Optional[int] = None
        self._frames: Dict[int, bytes] = {}
        self._bytes = 0
        self.evictions = 0

    def note_full(self, epoch: str, generation: int) -> None:
        """A full frame applied at (epoch, generation): everything
        cached belongs to a superseded prefix — rebase the window."""
        with self._lock:
            self._epoch = epoch
            self._base_gen = self._last_gen = int(generation)
            self._frames = {}
            self._bytes = 0

    def add_delta(self, epoch: str, generation: int,
                  raw_frame: bytes) -> None:
        """One APPLIED delta's exact wire bytes.  A frame that does not
        extend the cached chain rebases the window onto it (the relay's
        own applier already continuity-checked it — the cache only
        mirrors positions the relay actually holds)."""
        gen = int(generation)
        with self._lock:
            if (
                epoch != self._epoch
                or self._last_gen is None
                or gen != self._last_gen + 1
            ):
                self._epoch = epoch
                self._base_gen = gen - 1
                self._frames = {}
                self._bytes = 0
            self._frames[gen] = raw_frame
            self._bytes += len(raw_frame)
            self._last_gen = gen
            while self._bytes > self.max_bytes and self._frames:
                first = min(self._frames)
                self._bytes -= len(self._frames.pop(first))
                self._base_gen = first
                self.evictions += 1

    def position(self) -> Tuple[Optional[str], Optional[int]]:
        with self._lock:
            return self._epoch, self._last_gen

    def frames_since(self, epoch: str, generation: int,
                     limit_bytes: int = 256 << 20) -> Optional[List[bytes]]:
        """:meth:`FrameJournal.frames_since` over the in-memory window;
        the signature matches so leader.py's hello/resume path takes
        either interchangeably."""
        with self._lock:
            if (
                self._epoch != epoch
                or self._base_gen is None
                or generation < self._base_gen
                or generation > (self._last_gen or -1)
            ):
                return None
            out: List[bytes] = []
            total = 0
            for g in range(generation + 1, self._last_gen + 1):
                frame = self._frames.get(g)
                if frame is None:
                    return None  # window hole (should not happen)
                total += len(frame)
                if total > limit_bytes:
                    return None
                out.append(frame)
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "base_generation": self._base_gen,
                "generation": self._last_gen,
                "frames": len(self._frames),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "evictions": self.evictions,
            }
