"""Runtime hooks: mutate container resources at runtime events.

Reference: ``pkg/koordlet/runtimehooks`` — hook plugins registered by stage
(``hooks/hooks.go:44 Register``) mutate a container protocol object at
PreRunPodSandbox / PreCreateContainer / PreUpdateContainerResources, and
three delivery modes carry them: NRI (``nri/server.go:165``), the
runtime-proxy gRPC server (``proxyserver/``), and a standalone reconciler
polling cgroups (``reconciler/reconciler.go``).

Plugins here: groupidentity (bvt by QoS), cpuset (from scheduler
annotation), batchresource (cfs quota from batch resources), device env,
cpunormalization (quota scaling by the normalization ratio).
"""

from __future__ import annotations

import dataclasses
import json

from koordinator_tpu_torch.model import resources as res
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.koordlet.qosmanager import BVT_BY_QOS, CFS_PERIOD_US
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    ResourceUpdate,
    ResourceUpdateExecutor,
)

# hook stages (reference runtimehooks/protocol + hooks registry)
PRE_RUN_POD_SANDBOX = "PreRunPodSandbox"
PRE_CREATE_CONTAINER = "PreCreateContainer"
PRE_UPDATE_CONTAINER = "PreUpdateContainerResources"
POST_STOP_POD_SANDBOX = "PostStopPodSandbox"


@dataclasses.dataclass
class ContainerContext:
    """Protocol object passed through hooks (reference
    runtimehooks/protocol/container_context.go): request view + response
    mutations the runtime applies."""

    pod_name: str = ""
    pod_uid: str = ""
    container_name: str = ""
    qos: str = ""  # koordinator QoS LSE/LSR/LS/BE
    priority_class: str = ""
    pod_annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    pod_labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    limits: Dict[str, int] = dataclasses.field(default_factory=dict)
    cgroup_dir: str = ""
    # response / mutations
    cpuset_cpus: Optional[str] = None
    cfs_quota_us: Optional[int] = None
    cpu_shares: Optional[int] = None
    bvt_warp_ns: Optional[int] = None
    memory_limit_bytes: Optional[int] = None
    env: Dict[str, str] = dataclasses.field(default_factory=dict)


HookFn = Callable[[ContainerContext], None]


class HookRegistry:
    """hooks.go:44 Register/RunHooks."""

    def __init__(self):
        self._hooks: Dict[str, List[tuple]] = {}

    def register(self, stage: str, name: str, fn: HookFn) -> None:
        self._hooks.setdefault(stage, []).append((name, fn))

    def run(self, stage: str, ctx: ContainerContext) -> List[str]:
        ran = []
        for name, fn in self._hooks.get(stage, []):
            fn(ctx)
            ran.append(name)
        return ran


# ---------------------------------------------------------------------------
# Hook plugins
# ---------------------------------------------------------------------------


def group_identity_hook(ctx: ContainerContext) -> None:
    """bvt value by QoS class (reference hooks/groupidentity/rule.go:
    BE -> -1, LS/LSR/LSE -> 2, SYSTEM -> 0)."""
    ctx.bvt_warp_ns = BVT_BY_QOS.get(ctx.qos, 0)


CPUSET_ANNOTATION = "scheduling.koordinator.sh/resource-status"


def cpuset_hook(ctx: ContainerContext) -> None:
    """Apply the scheduler-allocated cpuset (reference hooks/cpuset:
    reads the resource-status annotation written at PreBind)."""
    raw = ctx.pod_annotations.get(CPUSET_ANNOTATION)
    if not raw:
        return
    status = raw if isinstance(raw, dict) else json.loads(raw)
    cpuset = status.get("cpuset")
    if cpuset:
        ctx.cpuset_cpus = cpuset


def batch_resource_hook(ctx: ContainerContext) -> None:
    """BE pods sized by batch resources get cfs quota / shares / memory
    from kubernetes.io/batch-* (reference hooks/batchresource/plugin.go):
    quota = batch-cpu(milli) * period / 1000, shares = milli*1024/1000."""
    milli = ctx.requests.get("kubernetes.io/batch-cpu")
    if milli:
        # batch-cpu quantities are already milli; accept string quantities
        milli = res.parse_quantity(milli, "kubernetes.io/batch-cpu")
        ctx.cfs_quota_us = milli * CFS_PERIOD_US // 1000
        ctx.cpu_shares = max(2, milli * 1024 // 1000)
    mem = ctx.limits.get("kubernetes.io/batch-memory") or ctx.requests.get(
        "kubernetes.io/batch-memory"
    )
    if mem:
        # webhook-mutated pods carry "<n>Mi" strings; raw numbers are bytes
        ctx.memory_limit_bytes = res.parse_quantity_bytes(
            mem, "kubernetes.io/batch-memory"
        )


DEVICE_ALLOCATED_ANNOTATION = "scheduling.koordinator.sh/device-allocated"


def device_env_hook(ctx: ContainerContext) -> None:
    """Expose allocated accelerator minors to the container (reference
    hooks/gpu/gpu.go InjectContainerGPUEnv: parses the DeviceAllocations
    annotation — apis/extension/device_share.go:56-66, type name ->
    [{"minor", "resources"}] — and sets NVIDIA_VISIBLE_DEVICES;
    TPU_VISIBLE_CHIPS here).  Only accelerator (gpu) minors are joined —
    an RDMA NIC id in the visible-devices list would expose the wrong
    device."""
    raw = ctx.pod_annotations.get(DEVICE_ALLOCATED_ANNOTATION)
    if not raw:
        return
    alloc = raw if isinstance(raw, dict) else json.loads(raw)
    entries = alloc.get("gpu")
    if entries is not None:
        minors = [e["minor"] for e in entries]
    else:
        # pre-round-5 rebuild payloads carried a flat accelerator list
        minors = alloc.get("minors")
    if minors:
        visible = ",".join(str(m) for m in minors)
        ctx.env["TPU_VISIBLE_CHIPS"] = visible
        ctx.env["NVIDIA_VISIBLE_DEVICES"] = visible


def make_cpu_normalization_hook(ratio_fn: Callable[[], float]) -> HookFn:
    """Scale cfs quota by the node's cpu-normalization ratio (reference
    hooks/cpunormalization: quota *= ratio for LS pods on amplified
    nodes)."""

    def hook(ctx: ContainerContext) -> None:
        ratio = ratio_fn()
        if ratio and ratio != 1.0 and ctx.cfs_quota_us and ctx.cfs_quota_us > 0:
            ctx.cfs_quota_us = int(ctx.cfs_quota_us * ratio)

    return hook


def default_registry(cpu_normalization_ratio: Optional[Callable[[], float]] = None):
    """Standard plugin set (reference runtimehooks.go:81 registered
    plugins)."""
    reg = HookRegistry()
    for stage in (PRE_CREATE_CONTAINER, PRE_UPDATE_CONTAINER):
        reg.register(stage, "groupidentity", group_identity_hook)
        reg.register(stage, "cpuset", cpuset_hook)
        reg.register(stage, "batchresource", batch_resource_hook)
        if cpu_normalization_ratio is not None:
            reg.register(
                stage,
                "cpunormalization",
                make_cpu_normalization_hook(cpu_normalization_ratio),
            )
    reg.register(PRE_CREATE_CONTAINER, "device", device_env_hook)
    return reg


# ---------------------------------------------------------------------------
# Reconciler delivery mode
# ---------------------------------------------------------------------------


class Reconciler:
    """Standalone reconciler (reference runtimehooks/reconciler): applies
    the hook mutations straight to cgroups for running containers, for
    runtimes without NRI/proxy."""

    def __init__(self, registry: HookRegistry, executor: ResourceUpdateExecutor):
        self.registry = registry
        self.executor = executor

    def reconcile_container(self, ctx: ContainerContext, now: float = 0.0) -> int:
        self.registry.run(PRE_UPDATE_CONTAINER, ctx)
        updates: List[ResourceUpdate] = []
        if ctx.cfs_quota_us is not None:
            updates.append(
                ResourceUpdate("cpu.cfs_quota", ctx.cgroup_dir, str(ctx.cfs_quota_us))
            )
        if ctx.cpu_shares is not None:
            updates.append(
                ResourceUpdate("cpu.shares", ctx.cgroup_dir, str(ctx.cpu_shares))
            )
        if ctx.bvt_warp_ns is not None:
            updates.append(
                ResourceUpdate(
                    "cpu.bvt_warp_ns", ctx.cgroup_dir, str(ctx.bvt_warp_ns)
                )
            )
        if ctx.cpuset_cpus is not None:
            updates.append(
                ResourceUpdate("cpuset.cpus", ctx.cgroup_dir, ctx.cpuset_cpus)
            )
        if ctx.memory_limit_bytes is not None:
            updates.append(
                ResourceUpdate(
                    "memory.limit", ctx.cgroup_dir, str(ctx.memory_limit_bytes)
                )
            )
        return self.executor.update_batch(updates, now)
