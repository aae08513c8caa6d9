"""Lease-based leader election for the central components.

The port's own copy of ``koordinator_tpu/leaderelection.py``.

The reference's scheduler, manager and descheduler are all
leader-elected singletons via client-go resource locks (reference
``cmd/koord-scheduler/app/server.go:225``,
``cmd/koord-manager/main.go:116-127``,
``cmd/koord-descheduler/app/server.go:182-200``).  Without an apiserver,
the shared lock here is a LEASE FILE on a filesystem all replicas see
(the deployment's PVC/configdir), with client-go's Lease semantics:

* ``lease_duration`` — how long a lease is valid after its last renewal;
  followers may claim it only after expiry (default 15s upstream).
* ``renew_deadline`` — a leader that cannot renew within this gives up
  leadership (default 10s).
* ``retry_period`` — acquire/renew polling interval (default 2s).

Writes are atomic (tempfile + rename) and guarded by a same-host flock,
and every renew re-reads the file and verifies the holder: a leader that
lost its lease (clock pause, file takeover) steps down instead of
split-braining — the same fencing the client-go leaderelector does via
resourceVersion-checked updates.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 2.0


@dataclasses.dataclass
class LeaseRecord:
    """client-go LeaderElectionRecord analog."""

    holder: str
    acquire_time: float
    renew_time: float
    lease_duration: float
    leader_transitions: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "LeaseRecord":
        return cls(**json.loads(text))


class LeaderElector:
    def __init__(
        self,
        lease_path: str,
        identity: str,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_deadline: float = DEFAULT_RENEW_DEADLINE,
        retry_period: float = DEFAULT_RETRY_PERIOD,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        on_new_leader: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.lease_path = lease_path
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.on_new_leader = on_new_leader
        self.clock = clock
        self.is_leader = False
        self._observed_leader: Optional[str] = None
        self._stop = threading.Event()
        os.makedirs(os.path.dirname(lease_path) or ".", exist_ok=True)

    # -- lease file primitives (atomic read/modify/write under flock) --
    def _read(self) -> Optional[LeaseRecord]:
        try:
            with open(self.lease_path) as fh:
                return LeaseRecord.from_json(fh.read())
        except (OSError, ValueError, TypeError):
            return None

    def _write(self, record: LeaseRecord) -> None:
        d = os.path.dirname(self.lease_path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".lease-")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(record.to_json())
            os.replace(tmp, self.lease_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _with_lock(self, fn):
        lock_path = self.lease_path + ".lock"
        with open(lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    # -- election steps --
    def try_acquire_or_renew(self, now: Optional[float] = None) -> bool:
        """One election step (client-go tryAcquireOrRenew): returns whether
        this identity holds the lease afterwards."""
        now = self.clock() if now is None else now

        def step() -> bool:
            record = self._read()
            if record is not None and record.holder != self.identity:
                expired = now >= record.renew_time + record.lease_duration
                if not expired:
                    self._observe(record.holder)
                    return False
                transitions = record.leader_transitions + 1
            else:
                transitions = record.leader_transitions if record else 0
            acquire = (
                record.acquire_time
                if record and record.holder == self.identity
                else now
            )
            self._write(
                LeaseRecord(
                    holder=self.identity,
                    acquire_time=acquire,
                    renew_time=now,
                    lease_duration=self.lease_duration,
                    leader_transitions=transitions,
                )
            )
            self._observe(self.identity)
            return True

        return self._with_lock(step)

    def _observe(self, leader: str):
        if leader != self._observed_leader:
            self._observed_leader = leader
            if self.on_new_leader:
                self.on_new_leader(leader)

    def release(self):
        """Voluntary step-down: zero the lease so followers claim it
        immediately (client-go releaseOnCancel)."""

        def step():
            record = self._read()
            if record and record.holder == self.identity:
                record.renew_time = 0.0
                record.lease_duration = 0.0
                self._write(record)

        self._with_lock(step)
        if self.is_leader:
            self.is_leader = False
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def stop(self):
        self._stop.set()

    def run(self, max_iterations: Optional[int] = None, sleep=None):
        """Blocking election loop (client-go LeaderElector.Run): acquire,
        then renew every retry_period; step down when the renew deadline
        passes or another holder takes the lease."""
        sleep = sleep or (lambda s: self._stop.wait(s))
        iterations = 0
        last_renew = None
        while not self._stop.is_set():
            if max_iterations is not None and iterations >= max_iterations:
                break
            iterations += 1
            now = self.clock()
            try:
                got = self.try_acquire_or_renew(now)
                renew_error = False
            except OSError:
                # lease storage briefly unwritable: NOT a lost election,
                # but not a renewal either — the deadline below decides
                got = False
                renew_error = True
            if got:
                last_renew = now
                if not self.is_leader:
                    self.is_leader = True
                    if self.on_started_leading:
                        self.on_started_leading()
            elif self.is_leader:
                observed_other = not renew_error
                past_deadline = (
                    last_renew is not None
                    and now - last_renew >= self.renew_deadline
                )
                if observed_other or past_deadline:
                    # fencing: the lease is observably held by another
                    # identity, or we failed to renew past renew_deadline
                    # ("a leader that cannot renew gives up leadership") —
                    # step down so a split brain cannot form
                    self.is_leader = False
                    if self.on_stopped_leading:
                        self.on_stopped_leading()
            sleep(self.retry_period)
        # releaseOnCancel: relinquish on shutdown; a bounded run (test/tool
        # driving discrete steps) keeps the lease for the next call
        if self._stop.is_set() and self.is_leader:
            self.release()
