"""Resource update executor: cache-diffed, leveled cgroup writes.

Reference: ``pkg/koordlet/resourceexecutor`` — ``executor.go:32
ResourceUpdateExecutor`` skips writes whose value already matches the
cache (``UpdateBatch`` with cacheable updaters), and **leveled** updaters
order parent/child cgroup updates so limits never transiently violate the
hierarchy (``updater.go`` merge semantics: when shrinking a parent cgroup,
children update first; when growing, parent first).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.koordlet.sysfs import SysFS


@dataclasses.dataclass
class ResourceUpdate:
    """One desired cgroup write."""

    resource: str  # CGROUP_FILES key
    cgroup_dir: str
    value: str


@dataclasses.dataclass
class _CacheEntry:
    value: str
    ts: float


class ResourceUpdateExecutor:
    """Cache-diffed executor (executor.go:59 NewResourceUpdateExecutor)."""

    def __init__(self, fs: SysFS, *, cache_expire_seconds: float = 1800.0, audit=None):
        self.fs = fs
        self.cache_expire_seconds = cache_expire_seconds
        self._cache: Dict[Tuple[str, str], _CacheEntry] = {}
        self.audit = audit  # optional koordlet.audit.Auditor

    def _cached_same(self, key: Tuple[str, str], value: str, now: float) -> bool:
        e = self._cache.get(key)
        return (
            e is not None
            and e.value == value
            and now - e.ts < self.cache_expire_seconds
        )

    def update(self, update: ResourceUpdate, now: Optional[float] = None) -> bool:
        """Write one value unless the cache already holds it.  Returns
        whether a write happened."""
        now = time.time() if now is None else now
        key = (update.resource, update.cgroup_dir)
        if self._cached_same(key, update.value, now):
            return False
        ok = self.fs.write_cgroup(update.resource, update.cgroup_dir, update.value)
        if ok:
            self._cache[key] = _CacheEntry(update.value, now)
            if self.audit is not None:
                self.audit.log(
                    "cgroup_write",
                    resource=update.resource,
                    cgroup=update.cgroup_dir,
                    value=update.value,
                )
        return ok

    def update_batch(
        self, updates: Sequence[ResourceUpdate], now: Optional[float] = None
    ) -> int:
        return sum(1 for u in updates if self.update(u, now))

    def leveled_update_batch(
        self, levels: Sequence[Sequence[ResourceUpdate]], now: Optional[float] = None
    ) -> int:
        """Apply level-ordered updates (updater.go LeveledUpdateBatch):
        callers pass levels root-first; growth applies root-first and
        shrink leaf-first per level pair, which the caller encodes by
        ordering — this executor just honors the level sequence."""
        done = 0
        for level in levels:
            done += self.update_batch(level, now)
        return done


class CgroupReader:
    """Typed read face (resourceexecutor/reader.go CgroupReader)."""

    def __init__(self, fs: SysFS):
        self.fs = fs

    def read_int(self, resource: str, cgroup_dir: str = "") -> Optional[int]:
        v = self.fs.read_cgroup(resource, cgroup_dir)
        if v is None:
            return None
        try:
            return int(v.split()[0])
        except (ValueError, IndexError):
            return None

    def read_cpuset(self, cgroup_dir: str = "") -> Optional[List[int]]:
        v = self.fs.read_cgroup("cpuset.cpus", cgroup_dir)
        if v is None or not v.strip():
            return None
        out: List[int] = []
        for part in v.strip().split(","):
            if "-" in part:
                a, b = part.split("-")
                out.extend(range(int(a), int(b) + 1))
            else:
                out.append(int(part))
        return out


def format_cpuset(cpus: Sequence[int]) -> str:
    """Canonical ranges string ('0-3,8,10-11'), the kernel's cpuset format
    (reference pkg/util/cpuset)."""
    cpus = sorted(set(cpus))
    if not cpus:
        return ""
    runs = []
    start = prev = cpus[0]
    for c in cpus[1:]:
        if c == prev + 1:
            prev = c
            continue
        runs.append((start, prev))
        start = prev = c
    runs.append((start, prev))
    return ",".join(f"{a}-{b}" if a != b else str(a) for a, b in runs)
