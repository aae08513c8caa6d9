"""Coscheduling control flow: gang cache, Permit wait/timeout, gang-group
reject, and the PodGroup lifecycle controller.

Round 1 had only the within-cycle all-or-nothing reduction
(constraints/gang.py); this module adds the CROSS-cycle state machine the
reference runs around it (citations into the upstream Koordinator source):

* gang cache + schedule-cycle bookkeeping
  (``pkg/scheduler/plugins/coscheduling/core/gang.go``: ScheduleCycle
  :71-78, isGangValidForPermit :485, addAssumedPod/addBoundPod);
* PreFilter gating (``core/core.go PreFilter``: init check, minNum check,
  strict-mode schedule-cycle checks);
* Permit: the whole gang GROUP must have enough assumed members or the
  pod Waits with the gang's wait timeout (``core/core.go:307 Permit``);
* Unreserve / PostFilter rejection: a strict gang's failure rejects every
  waiting pod of the whole gang group and invalidates their schedule
  cycles (``core/core.go:359 rejectGangGroupById``);
* wait timeout: waiting pods past their deadline trigger the same group
  rejection (the reference delegates the timer to the framework's
  WaitingPod; here ``check_timeouts`` is the explicit clock tick);
* PodGroup phase controller (``coscheduling/controller/podgroup.go:200
  syncHandler``): Pending -> PreScheduling -> Scheduling -> Scheduled ->
  Running -> Finished/Failed.

Pods are referenced by name; timestamps are plain floats injected by the
caller (tests tick them explicitly).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

# gang modes (apis/extension/constants.go)
GANG_MODE_STRICT = "Strict"
GANG_MODE_NONSTRICT = "NonStrict"
# match policies (gang.go:493-499)
MATCH_ONLY_WAITING = "only-waiting"
MATCH_WAITING_AND_RUNNING = "waiting-and-running"
MATCH_ONCE_SATISFIED = "once-satisfied"

# PodGroup phases (scheduler-plugins v1alpha1)
PHASE_PENDING = "Pending"
PHASE_PRESCHEDULING = "PreScheduling"
PHASE_SCHEDULING = "Scheduling"
PHASE_SCHEDULED = "Scheduled"
PHASE_RUNNING = "Running"
PHASE_FAILED = "Failed"
PHASE_FINISHED = "Finished"

# Permit statuses (core/core.go Status)
PERMIT_NOT_SPECIFIED = "PodGroupNotSpecified"
PERMIT_NOT_FOUND = "PodGroupNotFound"
PERMIT_WAIT = "Wait"
PERMIT_SUCCESS = "Success"

DEFAULT_WAIT_TIME = 600.0  # args defaultTimeout analog (seconds)


@dataclasses.dataclass
class Gang:
    """core/gang.go:40 Gang."""

    name: str
    min_member: int = 0
    total_num: int = 0
    mode: str = GANG_MODE_STRICT
    match_policy: str = MATCH_ONCE_SATISFIED
    wait_time: float = DEFAULT_WAIT_TIME
    gang_group: List[str] = dataclasses.field(default_factory=list)
    has_init: bool = False
    # members
    children: Set[str] = dataclasses.field(default_factory=set)
    waiting_for_bind: Set[str] = dataclasses.field(default_factory=set)
    bound: Set[str] = dataclasses.field(default_factory=set)
    waiting_since: Dict[str, float] = dataclasses.field(default_factory=dict)
    once_resource_satisfied: bool = False
    # schedule-cycle machinery (gang.go:71-78)
    schedule_cycle: int = 1
    schedule_cycle_valid: bool = True
    child_schedule_cycle: Dict[str, int] = dataclasses.field(default_factory=dict)

    def group(self) -> List[str]:
        return self.gang_group or [self.name]

    # -- membership --------------------------------------------------------
    def add_assumed_pod(self, pod: str, now: float) -> None:
        self.waiting_for_bind.add(pod)
        self.waiting_since[pod] = now
        self._refresh_once_satisfied()

    def del_assumed_pod(self, pod: str) -> None:
        self.waiting_for_bind.discard(pod)
        self.waiting_since.pop(pod, None)

    def add_bound_pod(self, pod: str) -> None:
        self.del_assumed_pod(pod)
        self.bound.add(pod)
        self._refresh_once_satisfied()

    def _refresh_once_satisfied(self) -> None:
        if len(self.waiting_for_bind) + len(self.bound) >= self.min_member:
            self.once_resource_satisfied = True

    # -- permit ------------------------------------------------------------
    def is_valid_for_permit(self) -> bool:
        """gang.go:485 isGangValidForPermit."""
        if not self.has_init:
            return False
        if self.match_policy == MATCH_ONLY_WAITING:
            return len(self.waiting_for_bind) >= self.min_member
        if self.match_policy == MATCH_WAITING_AND_RUNNING:
            return len(self.waiting_for_bind) + len(self.bound) >= self.min_member
        return (
            len(self.waiting_for_bind) >= self.min_member
            or self.once_resource_satisfied
        )

    # -- schedule cycle ----------------------------------------------------
    def try_set_schedule_cycle_valid(self) -> None:
        """gang.go trySetScheduleCycleValid: when every child has reached
        the current cycle, open the next one."""
        if all(
            self.child_schedule_cycle.get(c, 0) >= self.schedule_cycle
            for c in self.children
        ) and self.children:
            self.schedule_cycle += 1
            self.schedule_cycle_valid = True


class PodGroupManager:
    """core/core.go:84 PodGroupManager (host-side)."""

    def __init__(self, default_wait_time: float = DEFAULT_WAIT_TIME):
        self.default_wait_time = default_wait_time
        self.gangs: Dict[str, Gang] = {}
        self.rejected_messages: Dict[str, str] = {}

    # -- cache maintenance (gang_cache.go / PodGroup events) ---------------
    def on_pod_group_add(self, pg: Mapping) -> Gang:
        name = pg["name"]
        gang = self.gangs.get(name) or Gang(name=name)
        gang.min_member = int(pg.get("min_member", 0))
        gang.total_num = max(int(pg.get("total_num", 0)), gang.min_member)
        gang.mode = pg.get("mode", GANG_MODE_STRICT)
        gang.match_policy = pg.get("match_policy", MATCH_ONCE_SATISFIED)
        gang.wait_time = float(pg.get("wait_time", self.default_wait_time))
        gang.gang_group = list(pg.get("gang_group", []))
        gang.has_init = True
        self.gangs[name] = gang
        return gang

    def on_pod_add(self, gang_name: str, pod: str) -> Gang:
        gang = self.gangs.get(gang_name)
        if gang is None:
            gang = Gang(name=gang_name)
            self.gangs[gang_name] = gang
        gang.children.add(pod)
        return gang

    def on_pod_delete(self, gang_name: str, pod: str) -> None:
        gang = self.gangs.get(gang_name)
        if gang is None:
            return
        gang.children.discard(pod)
        gang.del_assumed_pod(pod)
        gang.bound.discard(pod)
        gang.child_schedule_cycle.pop(pod, None)

    # -- scheduling phases -------------------------------------------------
    def pre_filter(self, gang_name: Optional[str], pod: str) -> Optional[str]:
        """core/core.go PreFilter; returns a rejection message or None."""
        if not gang_name:
            return None
        gang = self.gangs.get(gang_name)
        if gang is None:
            return f"can't find gang {gang_name}"
        if not gang.has_init:
            return f"gang {gang_name} has not init"
        if (
            gang.match_policy == MATCH_ONCE_SATISFIED
            and gang.once_resource_satisfied
        ):
            return None
        if len(gang.children) < gang.min_member:
            return (
                f"gang {gang_name} child pod not collect enough "
                f"({len(gang.children)}/{gang.min_member})"
            )
        gang.try_set_schedule_cycle_valid()
        cycle = gang.schedule_cycle
        try:
            if gang.mode == GANG_MODE_STRICT:
                if not gang.schedule_cycle_valid:
                    return f"gang {gang_name} scheduleCycle not valid"
                if gang.child_schedule_cycle.get(pod, 0) >= cycle:
                    return f"pod {pod} schedule cycle too large"
            return None
        finally:
            gang.child_schedule_cycle[pod] = cycle

    def permit(
        self, gang_name: Optional[str], pod: str, now: float
    ) -> Tuple[float, str]:
        """core/core.go:307 Permit: (wait_timeout_seconds, status)."""
        if not gang_name:
            return 0.0, PERMIT_NOT_SPECIFIED
        gang = self.gangs.get(gang_name)
        if gang is None:
            return 0.0, PERMIT_NOT_FOUND
        gang.add_assumed_pod(pod, now)
        for member in gang.group():
            g = self.gangs.get(member)
            if g is None or not g.is_valid_for_permit():
                return gang.wait_time, PERMIT_WAIT
        return 0.0, PERMIT_SUCCESS

    def unreserve(self, gang_name: Optional[str], pod: str) -> List[str]:
        """core/core.go:341 Unreserve: release the pod; in strict mode the
        whole gang group is rejected.  Returns released pod names."""
        if not gang_name:
            return []
        gang = self.gangs.get(gang_name)
        if gang is None:
            return []
        gang.del_assumed_pod(pod)
        if not (
            gang.match_policy == MATCH_ONCE_SATISFIED
            and gang.once_resource_satisfied
        ) and gang.mode == GANG_MODE_STRICT:
            return self.reject_gang_group(
                gang.name, f"gang {gang.name} rejected: pod {pod} unreserved"
            )
        return []

    def post_filter_reject(self, gang_name: str, pod: str) -> List[str]:
        """core/core.go PostFilter: a strict gang member that came out of
        the cycle unschedulable rejects the whole group."""
        gang = self.gangs.get(gang_name)
        if gang is None:
            return []
        if (
            gang.match_policy == MATCH_ONCE_SATISFIED
            and gang.once_resource_satisfied
        ):
            return []
        if gang.mode != GANG_MODE_STRICT:
            return []
        return self.reject_gang_group(
            gang_name, f"gang {gang_name} rejected: pod {pod} unschedulable"
        )

    def reject_gang_group(self, gang_name: str, message: str) -> List[str]:
        """core/core.go:359 rejectGangGroupById: reject every waiting pod
        of every gang in the group, invalidate their schedule cycles.
        Returns the released (previously waiting) pod names."""
        gang = self.gangs.get(gang_name)
        if gang is None:
            return []
        released: List[str] = []
        for member in gang.group():
            g = self.gangs.get(member)
            if g is None:
                continue
            released.extend(sorted(g.waiting_for_bind))
            g.waiting_for_bind.clear()
            g.waiting_since.clear()
            g.schedule_cycle_valid = False
            self.rejected_messages[member] = message
        return released

    def check_timeouts(self, now: float) -> List[str]:
        """Reject gang groups whose waiting pods exceeded the gang's wait
        timeout (the framework's WaitingPod timer in the reference; Permit
        returns the timeout at core.go:332).  Returns released pods."""
        released: List[str] = []
        for gang in list(self.gangs.values()):
            expired = [
                p
                for p, since in gang.waiting_since.items()
                if now - since > gang.wait_time
            ]
            if expired:
                released.extend(
                    self.reject_gang_group(
                        gang.name,
                        f"gang {gang.name} rejected: Permit wait timeout",
                    )
                )
        return released

    def post_bind(self, gang_name: str, pod: str) -> None:
        gang = self.gangs.get(gang_name)
        if gang is not None:
            gang.add_bound_pod(pod)

    # -- cycle integration -------------------------------------------------
    def apply_cycle_result(
        self,
        pod_gangs: Sequence[Optional[str]],
        pod_names: Sequence[str],
        assignment: Sequence[int],
        status: Sequence[int],
        now: float,
    ) -> Dict[str, List[str]]:
        """Feed one batched cycle's outcome through Permit/PostFilter:
        WAIT_GANG pods become assumed+waiting, ASSIGNED gang pods bind,
        and strict gangs with unschedulable members reject their group.
        Returns {"bound": [...], "waiting": [...], "released": [...]}.
        """
        from koordinator_tpu_torch.solver.greedy import (
            STATUS_ASSIGNED,
            STATUS_UNSCHEDULABLE,
            STATUS_WAIT_GANG,
        )

        bound: List[str] = []
        waiting: List[str] = []
        released: List[str] = []

        def bind_whole_group(gname: str) -> None:
            # the whole gang group goes binding (core.go:306 "let the
            # whole gangGroup go binding"): every waiting pod across the
            # group is allowed through together
            nonlocal waiting
            for member in self.gangs[gname].group():
                g = self.gangs.get(member)
                if g is None:
                    continue
                for waiter in sorted(g.waiting_for_bind):
                    self.post_bind(member, waiter)
                    bound.append(waiter)
            waiting = [w for w in waiting if w not in bound]

        # Permit pass first (assumed adds), then rejections
        for name, gname, a, s in zip(pod_names, pod_gangs, assignment, status):
            if not gname:
                if a >= 0:
                    bound.append(name)
                continue
            if s == STATUS_WAIT_GANG or (s == STATUS_ASSIGNED and a >= 0):
                _, st = self.permit(gname, name, now)
                if st == PERMIT_SUCCESS:
                    bind_whole_group(gname)
                else:
                    waiting.append(name)
        for name, gname, a, s in zip(pod_names, pod_gangs, assignment, status):
            if gname and s == STATUS_UNSCHEDULABLE:
                released.extend(self.post_filter_reject(gname, name))
        # a pod the rejection released is no longer waiting (or bound)
        waiting = [w for w in waiting if w not in released]
        bound = [b for b in bound if b not in released]
        return {"bound": bound, "waiting": waiting, "released": released}


class PodGroupController:
    """controller/podgroup.go:200 syncHandler — PodGroup phase machine.

    ``pod_phases``: {pod_name: "Pending"|"Running"|"Succeeded"|"Failed"}.
    """

    def __init__(self, manager: PodGroupManager):
        self.manager = manager
        self.phases: Dict[str, str] = {}

    def sync(self, gang_name: str, pod_phases: Mapping[str, str]) -> str:
        gang = self.manager.gangs.get(gang_name)
        if gang is None:
            self.phases.pop(gang_name, None)
            return ""
        phase = self.phases.get(gang_name, "")
        pods = sorted(gang.children)
        scheduled = len(gang.bound)

        if phase == "":
            phase = PHASE_PENDING
        if phase == PHASE_PENDING:
            if len(pods) >= gang.min_member > 0:
                phase = PHASE_PRESCHEDULING
        if phase not in ("", PHASE_PENDING):
            running = sum(1 for p in pods if pod_phases.get(p) == "Running")
            succeeded = sum(1 for p in pods if pod_phases.get(p) == "Succeeded")
            failed = sum(1 for p in pods if pod_phases.get(p) == "Failed")
            if not pods:
                phase = PHASE_PENDING
            else:
                if phase == PHASE_PRESCHEDULING and scheduled > 0:
                    phase = PHASE_SCHEDULING
                if scheduled >= gang.min_member and phase in (
                    PHASE_PRESCHEDULING,
                    PHASE_SCHEDULING,
                ):
                    phase = PHASE_SCHEDULED
                if succeeded + running >= gang.min_member and phase == PHASE_SCHEDULED:
                    phase = PHASE_RUNNING
                if failed and failed + running + succeeded >= gang.min_member:
                    phase = PHASE_FAILED
                if succeeded >= gang.min_member:
                    phase = PHASE_FINISHED
        self.phases[gang_name] = phase
        return phase
