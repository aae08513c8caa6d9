"""Reservation lifecycle controller: phase machine, expiry, GC.

Reference: ``pkg/scheduler/plugins/reservation/controller/``:

* ``controller.go:171 sync`` — terminal phases are left alone; active
  reservations expire on TTL / ``expires`` / missing node; bound ones get
  their status (current owners + allocated) recomputed from the node's
  pods.
* ``garbage_collection.go:38 gcReservations`` — expired/succeeded
  reservations are deleted after ``defaultGCDuration`` (24h), immediately
  when their node is gone.
* phase setters mirror ``pkg/util/reservation/reservation.go:242-332``
  (SetReservationExpired / Succeeded / Available condition handling).

The controller owns reservation *dict* objects in the same shape
``model.reservation.encode_reservations`` consumes, so an expired
reservation drops out of the next cycle's ReservationTable (its restored
resources free up) with no extra plumbing: ``active_reservations()`` is
the encode input.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.model.resources import format_quantity, parse_quantity

# ReservationPhase (reference apis/scheduling/v1alpha1/reservation_types.go)
PENDING = "Pending"
AVAILABLE = "Available"
SUCCEEDED = "Succeeded"
FAILED = "Failed"

# condition reasons (reservation_types.go)
REASON_SCHEDULED = "Scheduled"
REASON_AVAILABLE = "Available"
REASON_EXPIRED = "Expired"
REASON_SUCCEEDED = "Succeeded"

DEFAULT_GC_CHECK_INTERVAL = 60.0  # garbage_collection.go:34
DEFAULT_GC_DURATION = 24 * 3600.0  # garbage_collection.go:35


@dataclasses.dataclass
class Condition:
    type: str
    status: bool
    reason: str
    last_transition: float
    last_probe: float


@dataclasses.dataclass
class Reservation:
    """One Reservation CR (spec + status), dict-spec compatible with
    model.reservation.encode_reservations."""

    name: str
    requests: Mapping = dataclasses.field(default_factory=dict)
    owners: Sequence[Mapping] = ()
    ttl_seconds: Optional[float] = 24 * 3600.0  # spec.TTL default 24h
    expires_at: Optional[float] = None  # spec.Expires wins over TTL
    allocate_once: bool = False
    allocate_policy: str = "Default"
    # reserve-pod priority (NewReservePod propagates it so reservations
    # compete/preempt at their own priority, util/reservation.go:165)
    priority: int = 0
    creation_time: float = 0.0

    phase: str = PENDING
    node: Optional[str] = None
    allocatable: Mapping = dataclasses.field(default_factory=dict)
    allocated: Mapping = dataclasses.field(default_factory=dict)
    current_owners: List[str] = dataclasses.field(default_factory=list)
    conditions: List[Condition] = dataclasses.field(default_factory=list)

    def is_terminal(self) -> bool:
        return self.phase in (SUCCEEDED, FAILED)

    def is_expired(self) -> bool:
        return self.phase == FAILED and any(
            c.reason == REASON_EXPIRED for c in self.conditions
        )

    def as_dict(self) -> Dict:
        """encode_reservations input row.  ``allocated`` holds axis-unit
        integers (computed by _sync_status); render them as quantities so
        encode_reservations' parse round-trips exactly (resources.py
        format_quantity contract)."""
        return {
            "name": self.name,
            "node": self.node,
            "allocatable": self.allocatable or self.requests,
            "allocated": {
                k: format_quantity(v, k) for k, v in self.allocated.items()
            },
            "owners": list(self.owners),
            "allocate_policy": self.allocate_policy,
            "allocate_once": self.allocate_once,
            "assigned_pods": len(self.current_owners),
        }


def _set_condition(r: Reservation, reason: str, status: bool, now: float):
    """SetReservationExpired/Succeeded condition handling
    (util/reservation.go:242-300): update the Ready condition in place,
    bump only the probe time when already not-ready."""
    for c in r.conditions:
        if c.type == "Ready":
            if c.status:  # was ready -> full transition
                c.status = status
                c.reason = reason
                c.last_transition = now
            else:  # already not ready: refresh reason/probe only
                c.reason = reason
            c.last_probe = now
            return
    r.conditions.append(
        Condition("Ready", status, reason, last_transition=now, last_probe=now)
    )


class ReservationController:
    """Phase machine + GC over a reservation store (controller.go:103)."""

    def __init__(
        self,
        node_exists: Optional[Callable[[str], bool]] = None,
        pods_on_node: Optional[Callable[[str], List[Mapping]]] = None,
        gc_duration: float = DEFAULT_GC_DURATION,
        clock: Callable[[], float] = time.time,
    ):
        self.reservations: Dict[str, Reservation] = {}
        self.node_exists = node_exists or (lambda n: True)
        self.pods_on_node = pods_on_node or (lambda n: [])
        self.gc_duration = gc_duration
        self.clock = clock

    # -- lifecycle events ---------------------------------------------------
    def create(self, r: Reservation) -> Reservation:
        if not r.creation_time:
            r.creation_time = self.clock()
        self.reservations[r.name] = r
        return r

    def mark_available(self, name: str, node: str, now: Optional[float] = None):
        """The scheduler bound the reservation (SetReservationAvailable,
        util/reservation.go:301): records node + allocatable, initializes
        conditions."""
        r = self.reservations[name]
        now = self.clock() if now is None else now
        r.node = node
        r.allocatable = dict(r.requests)
        r.phase = AVAILABLE
        r.conditions = [
            Condition("Scheduled", True, REASON_SCHEDULED, now, now),
            Condition("Ready", True, REASON_AVAILABLE, now, now),
        ]

    def mark_succeeded(self, name: str, now: Optional[float] = None):
        """AllocateOnce reservation fully consumed
        (SetReservationSucceeded, util/reservation.go:277)."""
        r = self.reservations[name]
        now = self.clock() if now is None else now
        r.phase = SUCCEEDED
        _set_condition(r, REASON_SUCCEEDED, False, now)

    # -- sync (controller.go:171) ------------------------------------------
    def _needs_expiration(self, r: Reservation, now: float) -> bool:
        if r.expires_at is not None:
            return now >= r.expires_at
        if r.ttl_seconds:
            return now - r.creation_time >= r.ttl_seconds
        return False

    def expire(self, r: Reservation, now: float):
        r.phase = FAILED
        _set_condition(r, REASON_EXPIRED, False, now)

    def sync(self, name: str, now: Optional[float] = None):
        r = self.reservations.get(name)
        if r is None or r.is_terminal():
            return
        now = self.clock() if now is None else now
        if self._needs_expiration(r, now):
            self.expire(r, now)
            return
        if r.node and not self.node_exists(r.node):
            self.expire(r, now)
            return
        self._sync_status(r, now)

    def _sync_status(self, r: Reservation, now: Optional[float] = None):
        """Recompute current owners + allocated from the node's pods
        (controller.go:208 syncStatus; pods carry a
        ``reservation_allocated`` annotation naming their reservation)."""
        if not r.node:
            return
        owners: List[str] = []
        allocated: Dict[str, int] = {}
        for pod in self.pods_on_node(r.node):
            if pod.get("reservation_allocated") != r.name:
                continue
            owners.append(pod.get("name", ""))
            for k, v in (pod.get("requests") or {}).items():
                allocated[k] = allocated.get(k, 0) + parse_quantity(v, k)
        r.current_owners = sorted(owners)
        r.allocated = allocated
        if r.allocate_once and owners and r.phase == AVAILABLE:
            self.mark_succeeded(r.name, now)

    def sync_all(self, now: Optional[float] = None):
        for name in list(self.reservations):
            self.sync(name, now)

    # -- GC (garbage_collection.go:38) --------------------------------------
    def gc(self, now: Optional[float] = None) -> List[str]:
        """Delete expired/succeeded reservations past the GC duration, or
        whose node no longer exists.  Returns the deleted names."""
        now = self.clock() if now is None else now
        deleted = []
        for name, r in list(self.reservations.items()):
            if not (r.is_expired() or r.phase == SUCCEEDED):
                continue
            stale = any(
                c.reason in (REASON_EXPIRED, REASON_SUCCEEDED)
                and now - c.last_transition > self.gc_duration
                for c in r.conditions
            )
            gone = bool(r.node) and not self.node_exists(r.node)
            if stale or gone:
                del self.reservations[name]
                deleted.append(name)
        return deleted

    # -- reservation-as-pod scheduling (eventhandlers) ----------------------
    def pending_reserve_pods(self) -> List[Dict]:
        """Pending reservations as reserve-pod dicts for the scheduling
        cycle (reference ``eventhandlers/reservation_handler.go:188``
        enqueues Reservations as pods built by ``NewReservePod``,
        ``util/reservation.go:53``): the pod carries the reservation's
        requests/priority plus the reserve-pod annotations."""
        out = []
        now = self.clock()
        for r in self.reservations.values():
            if r.phase != PENDING:
                continue
            if self._needs_expiration(r, now):
                # expiry is lazily applied: a dead reservation must not be
                # enqueued even if no sync pass ran yet
                self.expire(r, now)
                continue
            out.append(
                {
                    "name": f"reserve-pod-{r.name}",
                    "requests": dict(r.requests),
                    "priority": r.priority,
                    "annotations": {
                        "scheduling.koordinator.sh/reserve-pod": "true",
                        "scheduling.koordinator.sh/reservation-name": r.name,
                    },
                }
            )
        return out

    def on_reserve_pod_assigned(
        self, reservation_name: str, node: str, now: Optional[float] = None
    ) -> None:
        """The cycle placed a reserve pod: the reservation becomes
        Available on that node (SetReservationAvailable via the scheduler's
        reservation error-handler/bind flow).  Only a still-Pending
        reservation binds — a late callback must not resurrect an expired
        or already-bound one."""
        r = self.reservations.get(reservation_name)
        if r is None or r.phase != PENDING:
            return
        check_now = self.clock() if now is None else now
        if self._needs_expiration(r, check_now):
            self.expire(r, check_now)  # late bind of a dead reservation
            return
        self.mark_available(reservation_name, node, now)

    # -- snapshot feed ------------------------------------------------------
    def active_reservations(self) -> List[Dict]:
        """Rows for model.reservation.encode_reservations: only phases the
        transformer restores (Available; terminal phases release their
        resources to the next cycle)."""
        return [
            r.as_dict()
            for r in self.reservations.values()
            if r.phase == AVAILABLE
        ]
