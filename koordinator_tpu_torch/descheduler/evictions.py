"""Pod eviction seam: rate limiting + bookkeeping.

A host-only copy of ``koordinator_tpu/descheduler/evictions.py`` (reference
``pkg/descheduler/evictions``): ``PodEvictor`` counts evictions per node and
namespace and enforces ``MaxNoOfPodsToEvictPerNode`` /
``MaxNoOfPodsToEvictPerNamespace`` (``evictions.go:65``); a token bucket
throttles the global eviction rate (``eviction_limiter.go``).  The eviction
itself is a callback, so tests and the dry-run mode plug in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional


class TokenBucket:
    """qps/burst limiter (the reference wraps client-go's flowcontrol)."""

    def __init__(self, qps: float, burst: int, clock: Callable[[], float] = time.monotonic):
        self.qps = qps
        self.burst = max(1, burst)
        self._tokens = float(self.burst)
        self._clock = clock
        self._last = clock()

    def try_accept(self) -> bool:
        now = self._clock()
        if self.qps > 0:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class EvictionRecord:
    pod: str
    namespace: str
    node: str
    reason: str


class PodEvictor:
    """Counts and limits evictions; ``evict`` returns False when a limit or
    the rate limiter blocks the eviction (reference ``evictions.go:165``)."""

    def __init__(
        self,
        max_pods_per_node: Optional[int] = None,
        max_pods_per_namespace: Optional[int] = None,
        qps: float = 0.0,
        burst: int = 0,
        dry_run: bool = False,
        evict_fn: Optional[Callable[[Mapping, str], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_pods_per_node = max_pods_per_node
        self.max_pods_per_namespace = max_pods_per_namespace
        self.limiter = TokenBucket(qps, burst, clock) if qps > 0 else None
        self.dry_run = dry_run
        self.evict_fn = evict_fn
        self.node_counts: Dict[str, int] = {}
        self.namespace_counts: Dict[str, int] = {}
        self.evicted: List[EvictionRecord] = []

    def total_evicted(self) -> int:
        return len(self.evicted)

    def reset(self) -> None:
        """Per-tick counter reset (descheduler.go:269 evictionLimiter.Reset
        before running the profiles); the eviction audit trail persists."""
        self.node_counts.clear()
        self.namespace_counts.clear()

    def evict(self, pod: Mapping, node: str, reason: str = "") -> bool:
        ns = pod.get("namespace", "default")
        if self.max_pods_per_node is not None and self.node_counts.get(node, 0) >= self.max_pods_per_node:
            return False
        if (
            self.max_pods_per_namespace is not None
            and self.namespace_counts.get(ns, 0) >= self.max_pods_per_namespace
        ):
            return False
        if self.limiter is not None and not self.limiter.try_accept():
            return False
        if not self.dry_run and self.evict_fn is not None:
            if not self.evict_fn(pod, reason):
                return False
        self.node_counts[node] = self.node_counts.get(node, 0) + 1
        self.namespace_counts[ns] = self.namespace_counts.get(ns, 0) + 1
        self.evicted.append(EvictionRecord(pod.get("name", ""), ns, node, reason))
        return True
