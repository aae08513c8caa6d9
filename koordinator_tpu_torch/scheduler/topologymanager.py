"""NUMA topology-hint merging (kubelet-style, inside the scheduler).

Behavior parity with reference ``pkg/scheduler/frameworkext/topologymanager``:
hints from providers (CPU, devices, NUMA memory) are cross-permuted, each
permutation bitwise-ANDed, and the narrowest preferred merged hint wins
(``policy.go:124 mergeFilteredHints``).  Policies none / best-effort /
restricted / single-numa-node gate admission (``policy_*.go``).

Affinity masks are plain Python ints used as bitmasks (bit i = NUMA node i),
replacing the reference's ``pkg/util/bitmask``.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


class NUMATopologyPolicy(str, enum.Enum):
    """reference apis/extension/numa_aware.go NUMATopologyPolicy."""

    NONE = ""
    BEST_EFFORT = "BestEffort"
    RESTRICTED = "Restricted"
    SINGLE_NUMA_NODE = "SingleNUMANode"


@dataclasses.dataclass(frozen=True)
class NUMATopologyHint:
    """reference topologymanager/policy.go:34 NUMATopologyHint.

    ``affinity`` is a bitmask int, or None for "any NUMA node".
    """

    affinity: Optional[int]
    preferred: bool

    def count(self) -> int:
        return bin(self.affinity).count("1") if self.affinity is not None else 0

    def is_narrower_than(self, other: "NUMATopologyHint") -> bool:
        """bitmask.IsNarrowerThan: fewer bits set; ties broken by the
        smaller (lower) mask value."""
        a, b = self.count(), other.count()
        if a != b:
            return a < b
        return (self.affinity or 0) < (other.affinity or 0)


def _mask(nodes: Sequence[int]) -> int:
    m = 0
    for n in nodes:
        m |= 1 << n
    return m


def _filter_providers_hints(
    providers_hints: Sequence[Mapping[str, Optional[Sequence[NUMATopologyHint]]]],
) -> List[List[NUMATopologyHint]]:
    """policy.go:91 filterProvidersHints: no-preference providers/resources
    become a single preferred any-numa hint; impossible resources become a
    single non-preferred any-numa hint."""
    out: List[List[NUMATopologyHint]] = []
    for hints in providers_hints:
        if not hints:
            out.append([NUMATopologyHint(None, True)])
            continue
        for resource in hints:
            rh = hints[resource]
            if rh is None:
                out.append([NUMATopologyHint(None, True)])
            elif len(rh) == 0:
                out.append([NUMATopologyHint(None, False)])
            else:
                out.append(list(rh))
    return out


def _merge_permutation(
    default_affinity: int, permutation: Sequence[NUMATopologyHint]
) -> NUMATopologyHint:
    """policy.go:65 mergePermutation: AND of affinities; preferred iff all
    hints in the permutation are preferred."""
    preferred = all(h.preferred for h in permutation)
    merged = default_affinity
    for h in permutation:
        merged &= default_affinity if h.affinity is None else h.affinity
    return NUMATopologyHint(merged, preferred)


def _merge_filtered_hints(
    numa_nodes: Sequence[int], filtered: Sequence[Sequence[NUMATopologyHint]]
) -> NUMATopologyHint:
    """policy.go:124 mergeFilteredHints."""
    default_affinity = _mask(numa_nodes)
    best = NUMATopologyHint(default_affinity, False)
    for permutation in itertools.product(*filtered):
        merged = _merge_permutation(default_affinity, permutation)
        if merged.count() == 0:
            continue
        if merged.preferred and not best.preferred:
            best = merged
            continue
        if not merged.preferred and best.preferred:
            continue
        if not merged.is_narrower_than(best):
            continue
        best = merged
    return best


def _filter_single_numa_hints(
    filtered: Sequence[Sequence[NUMATopologyHint]],
) -> List[List[NUMATopologyHint]]:
    """policy_single_numa_node.go filterSingleNumaHints: keep preferred
    don't-cares and preferred single-node hints."""
    out: List[List[NUMATopologyHint]] = []
    for one in filtered:
        out.append(
            [
                h
                for h in one
                if h.preferred and (h.affinity is None or h.count() == 1)
            ]
        )
    return out


def merge_hints(
    policy: NUMATopologyPolicy,
    numa_nodes: Sequence[int],
    providers_hints: Sequence[Mapping[str, Optional[Sequence[NUMATopologyHint]]]],
) -> Tuple[NUMATopologyHint, bool]:
    """Merge providers' hints under ``policy``; returns (hint, admit).

    reference topologymanager/policy_none.go (always admit, empty hint),
    policy_best_effort.go (admit always), policy_restricted.go (admit iff
    preferred), policy_single_numa_node.go (single-node filter + admit iff
    preferred).
    """
    if policy == NUMATopologyPolicy.NONE:
        return NUMATopologyHint(None, True), True

    filtered = _filter_providers_hints(providers_hints)
    if policy == NUMATopologyPolicy.SINGLE_NUMA_NODE:
        filtered = _filter_single_numa_hints(filtered)
        best = _merge_filtered_hints(numa_nodes, filtered)
        # a full-machine affinity collapses to "no affinity"
        if best.affinity == _mask(numa_nodes):
            best = NUMATopologyHint(None, best.preferred)
        return best, best.preferred

    best = _merge_filtered_hints(numa_nodes, filtered)
    if policy == NUMATopologyPolicy.RESTRICTED:
        return best, best.preferred
    return best, True  # BestEffort


def generate_cpu_hints(
    cpus_by_node: Mapping[int, int], num_needed: int
) -> Dict[str, List[NUMATopologyHint]]:
    """Generate CPU hints per NUMA-node subset (reference
    ``plugins/nodenumaresource/plugin.go GetPodTopologyHints`` semantics):
    every subset of NUMA nodes whose free CPUs cover the request is a hint;
    minimal-width subsets are preferred.
    """
    nodes = sorted(cpus_by_node)
    hints: List[NUMATopologyHint] = []
    min_width = None
    for width in range(1, len(nodes) + 1):
        for combo in itertools.combinations(nodes, width):
            if sum(cpus_by_node[n] for n in combo) >= num_needed:
                if min_width is None:
                    min_width = width
                hints.append(NUMATopologyHint(_mask(combo), width == min_width))
    return {"cpu": hints}
