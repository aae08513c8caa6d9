"""PLEG: pod lifecycle events from cgroup directory changes.

Reference: ``pkg/koordlet/pleg`` — inotify watches on the kubepods cgroup
trees (``watcher_linux.go:30``) emit PodAdded/PodDeleted/ContainerAdded…
events to subscribed handlers (``pleg.go:75,81``).  This rebuild scans the
same directory layout; ``poll_once`` diffs against the previous scan (tests
and non-inotify platforms), which is semantically the event stream the
reference derives from inotify.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Set

from koordinator_tpu_torch.koordlet.sysfs import SysFS

POD_ADDED = "PodAdded"
POD_DELETED = "PodDeleted"
CONTAINER_ADDED = "ContainerAdded"
CONTAINER_DELETED = "ContainerDeleted"

_POD_DIR = re.compile(r"^pod([0-9a-f-]+)$")


@dataclasses.dataclass(frozen=True)
class PlegEvent:
    kind: str
    pod_uid: str
    container_id: str = ""


class Pleg:
    """Directory-diff PLEG over the kubepods trees."""

    QOS_DIRS = ("kubepods", "kubepods/besteffort", "kubepods/burstable")

    def __init__(self, fs: SysFS):
        self.fs = fs
        self._handlers: List[Callable[[PlegEvent], None]] = []
        self._known: Dict[str, Set[str]] = {}  # pod uid -> container ids

    def subscribe(self, handler: Callable[[PlegEvent], None]) -> None:
        self._handlers.append(handler)

    def _emit(self, event: PlegEvent) -> None:
        for h in self._handlers:
            h(event)

    def _scan(self) -> Dict[str, Set[str]]:
        base = os.path.join(self.fs.root, self.fs.cgroup_mount)
        pods: Dict[str, Set[str]] = {}
        for qos_dir in self.QOS_DIRS:
            d = os.path.join(base, qos_dir)
            try:
                entries = os.listdir(d)
            except OSError:
                continue
            for entry in entries:
                m = _POD_DIR.match(entry)
                if not m:
                    continue
                uid = m.group(1)
                pod_path = os.path.join(d, entry)
                containers = {
                    c
                    for c in os.listdir(pod_path)
                    if os.path.isdir(os.path.join(pod_path, c))
                }
                pods[uid] = containers
        return pods

    def poll_once(self) -> List[PlegEvent]:
        """Diff the cgroup trees against the last poll; emit + return
        events in a stable order (pods added, containers added, containers
        deleted, pods deleted)."""
        current = self._scan()
        events: List[PlegEvent] = []
        for uid in sorted(current.keys() - self._known.keys()):
            events.append(PlegEvent(POD_ADDED, uid))
            for c in sorted(current[uid]):
                events.append(PlegEvent(CONTAINER_ADDED, uid, c))
        for uid in sorted(current.keys() & self._known.keys()):
            for c in sorted(current[uid] - self._known[uid]):
                events.append(PlegEvent(CONTAINER_ADDED, uid, c))
            for c in sorted(self._known[uid] - current[uid]):
                events.append(PlegEvent(CONTAINER_DELETED, uid, c))
        for uid in sorted(self._known.keys() - current.keys()):
            for c in sorted(self._known[uid]):
                events.append(PlegEvent(CONTAINER_DELETED, uid, c))
            events.append(PlegEvent(POD_DELETED, uid))
        self._known = current
        for e in events:
            self._emit(e)
        return events
