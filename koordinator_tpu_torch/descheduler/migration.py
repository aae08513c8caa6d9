"""PodMigrationJob controller: arbitration + migration state machine.

The port's own copy of ``koordinator_tpu/descheduler/migration.py``.

Reference: ``pkg/descheduler/controllers/migration`` — ``controller.go:218
Reconcile`` / ``:241 doMigrate`` drive each job Pending -> (arbitration) ->
Running -> [reserve -> wait-bound ->] evict -> Succeeded/Failed, with TTL
abort; the arbitrator (``arbitrator/filter.go``) gates how many concurrent
migrations a node / namespace / workload may carry and sorts candidates;
``controller.go:661 evictPod`` performs the eviction.

Everything here is a host-side state machine over plain-dict jobs; the
eviction and reservation seams are callbacks so the scheduler's reservation
plugin and the evictor plug in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"
ABORTED = "Aborted"

REASON_TIMEOUT = "Timeout"
REASON_FAILED_CREATE_RESERVATION = "FailedCreateReservation"
REASON_WAIT_RESERVATION = "WaitForReservationBound"
REASON_FAILED_EVICT = "FailedEvict"
REASON_EVICTING = "Evicting"


@dataclasses.dataclass
class MigrationControllerArgs:
    """reference config.MigrationControllerArgs (subset with defaults)."""

    max_concurrent_reclaims_per_node: Optional[int] = 1
    max_concurrent_reclaims_per_namespace: Optional[int] = None
    max_concurrent_reclaims_per_workload: Optional[int] = None
    max_unavailable_per_workload_fraction: float = 0.0  # extra guard, 0=off
    default_job_ttl_seconds: float = 300.0
    default_job_mode: str = "ReservationFirst"  # or EvictDirectly


@dataclasses.dataclass
class MigrationJob:
    name: str
    pod: Mapping  # pod dict: name, namespace, node, workload (owner key)
    phase: str = PENDING
    reason: str = ""
    mode: str = ""
    creation_time: float = 0.0
    reservation_name: Optional[str] = None
    reservation_bound: bool = False
    passed_arbitration: bool = False


class Arbitrator:
    """Filter + sort of pending jobs (reference ``arbitrator/``)."""

    def __init__(self, args: MigrationControllerArgs):
        self.args = args

    def arbitrate(
        self,
        pending: Sequence[MigrationJob],
        active: Sequence[MigrationJob],
    ) -> List[MigrationJob]:
        """Return the pending jobs allowed to start, ordered.  Concurrency
        caps count jobs already Running plus ones admitted this round
        (reference ``filterMaxMigratingPerNode`` :218,
        ``filterMaxMigratingPerNamespace`` :260,
        ``filterMaxMigratingOrUnavailablePerWorkload`` :291)."""
        per_node = _count_by(active, lambda j: j.pod.get("node"))
        per_ns = _count_by(active, lambda j: j.pod.get("namespace", "default"))
        per_workload = _count_by(active, lambda j: j.pod.get("workload"))
        admitted: List[MigrationJob] = []
        # oldest jobs first (stable by creation time then name)
        for job in sorted(pending, key=lambda j: (j.creation_time, j.name)):
            node = job.pod.get("node")
            ns = job.pod.get("namespace", "default")
            workload = job.pod.get("workload")
            a = self.args
            if (
                a.max_concurrent_reclaims_per_node is not None
                and node is not None
                and per_node.get(node, 0) >= a.max_concurrent_reclaims_per_node
            ):
                continue
            if (
                a.max_concurrent_reclaims_per_namespace is not None
                and per_ns.get(ns, 0) >= a.max_concurrent_reclaims_per_namespace
            ):
                continue
            if (
                a.max_concurrent_reclaims_per_workload is not None
                and workload is not None
                and per_workload.get(workload, 0) >= a.max_concurrent_reclaims_per_workload
            ):
                continue
            job.passed_arbitration = True
            admitted.append(job)
            if node is not None:
                per_node[node] = per_node.get(node, 0) + 1
            per_ns[ns] = per_ns.get(ns, 0) + 1
            if workload is not None:
                per_workload[workload] = per_workload.get(workload, 0) + 1
        return admitted


class MigrationController:
    """Reconciles jobs one tick at a time (reference ``Reconcile`` :218)."""

    def __init__(
        self,
        args: Optional[MigrationControllerArgs] = None,
        create_reservation: Optional[Callable[[MigrationJob], Optional[str]]] = None,
        reservation_bound: Optional[Callable[[str], bool]] = None,
        evict: Optional[Callable[[Mapping], bool]] = None,
    ):
        self.args = args or MigrationControllerArgs()
        self.arbitrator = Arbitrator(self.args)
        self.create_reservation = create_reservation
        self.reservation_bound = reservation_bound
        self.evict = evict or (lambda pod: True)
        self.jobs: Dict[str, MigrationJob] = {}

    def submit(self, job: MigrationJob) -> MigrationJob:
        """Idempotent: a live job with the same name wins — replanning the
        same pod next tick must not clobber an in-flight job's reservation
        state or restart its TTL."""
        existing = self.jobs.get(job.name)
        if existing is not None and existing.phase in (PENDING, RUNNING):
            return existing
        job.mode = job.mode or self.args.default_job_mode
        self.jobs[job.name] = job
        return job

    def reconcile(self, now: float = 0.0) -> None:
        """One pass: TTL-abort stale jobs, arbitrate pending, advance
        running jobs through reservation -> eviction."""
        for job in self.jobs.values():
            if job.phase in (PENDING, RUNNING) and now - job.creation_time > self.args.default_job_ttl_seconds:
                job.phase, job.reason = FAILED, REASON_TIMEOUT

        pending = [j for j in self.jobs.values() if j.phase == PENDING and not j.passed_arbitration]
        running = [j for j in self.jobs.values() if j.phase == RUNNING or (j.phase == PENDING and j.passed_arbitration)]
        for job in self.arbitrator.arbitrate(pending, running):
            job.phase = RUNNING

        for job in [j for j in self.jobs.values() if j.phase == RUNNING]:
            self._advance(job)

    def _advance(self, job: MigrationJob) -> None:
        if job.mode == "ReservationFirst":
            if job.reservation_name is None:
                if self.create_reservation is None:
                    job.phase, job.reason = FAILED, REASON_FAILED_CREATE_RESERVATION
                    return
                name = self.create_reservation(job)
                if name is None:
                    job.phase, job.reason = FAILED, REASON_FAILED_CREATE_RESERVATION
                    return
                job.reservation_name = name
            if not job.reservation_bound:
                bound = self.reservation_bound(job.reservation_name) if self.reservation_bound else True
                if not bound:
                    job.reason = REASON_WAIT_RESERVATION
                    return  # try again next tick
                job.reservation_bound = True
        if self.evict(job.pod):
            job.phase, job.reason = SUCCEEDED, ""
        else:
            job.phase, job.reason = FAILED, REASON_FAILED_EVICT

    def scavenge(self, now: float, ttl_after_done: float = 600.0) -> int:
        """Drop finished jobs older than the TTL (reference job GC)."""
        done = [
            name
            for name, j in self.jobs.items()
            if j.phase in (SUCCEEDED, FAILED, ABORTED) and now - j.creation_time > ttl_after_done
        ]
        for name in done:
            del self.jobs[name]
        return len(done)


def _count_by(jobs: Sequence[MigrationJob], key) -> Dict:
    out: Dict = {}
    for j in jobs:
        k = key(j)
        if k is None:
            continue
        out[k] = out.get(k, 0) + 1
    return out
