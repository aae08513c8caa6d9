"""Runtime proxy: CRI request interposition between kubelet and the runtime.

Reference: ``pkg/runtimeproxy`` — a UDS gRPC proxy re-registering
``RuntimeServiceServer`` (``server/cri/criserver.go:93-97``): intercepted
calls (RunPodSandbox / CreateContainer / StartContainer / StopContainer /
UpdateContainerResources) are sent to registered hook servers before and
after forwarding to the real runtime, with a failure policy deciding
whether hook errors fail the request (``config.FailurePolicyFail``) or are
ignored (``FailurePolicyIgnore``); a store keeps pod/container state
between calls (``store/``).

The transport here is in-process callables: the dispatcher and state store
are the behavior; koordlet's ``HookRegistry`` plugs in directly (the NRI
path in the reference supersedes the gRPC proto the same way,
``runtimehooks/nri/server.go``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Mapping, Optional

from koordinator_tpu_torch.koordlet.runtimehooks import (
    ContainerContext,
    HookRegistry,
    PRE_CREATE_CONTAINER,
    PRE_RUN_POD_SANDBOX,
    PRE_UPDATE_CONTAINER,
    POST_STOP_POD_SANDBOX,
)


class FailurePolicy(str, enum.Enum):
    FAIL = "Fail"
    IGNORE = "Ignore"


# CRI call -> hook stage (server/cri/criserver.go intercepted RPC set)
_STAGE_BY_CALL = {
    "RunPodSandbox": PRE_RUN_POD_SANDBOX,
    "CreateContainer": PRE_CREATE_CONTAINER,
    "UpdateContainerResources": PRE_UPDATE_CONTAINER,
    "StopPodSandbox": POST_STOP_POD_SANDBOX,
}


@dataclasses.dataclass
class CRIRequest:
    """Normalized CRI request view."""

    call: str  # RunPodSandbox | CreateContainer | ...
    pod_uid: str = ""
    container_name: str = ""
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    # linux container resources (the mutable part of the request)
    cpu_period: Optional[int] = None
    cpu_quota: Optional[int] = None
    cpu_shares: Optional[int] = None
    cpuset_cpus: Optional[str] = None
    memory_limit_bytes: Optional[int] = None
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    cgroup_parent: str = ""
    # pod-level resource spec (kubelet passes it via the CRI config; the
    # batchresource hook reads batch-* from it)
    requests: Dict[str, object] = dataclasses.field(default_factory=dict)
    limits: Dict[str, object] = dataclasses.field(default_factory=dict)


class RuntimeProxy:
    """Dispatcher + store (dispatcher/ + store/ condensed)."""

    def __init__(
        self,
        registry: HookRegistry,
        backend: Callable[[CRIRequest], Mapping],
        *,
        failure_policy: FailurePolicy = FailurePolicy.IGNORE,
    ):
        self.registry = registry
        self.backend = backend  # the real runtime (containerd/dockerd stand-in)
        self.failure_policy = failure_policy
        # store: pod uid -> sandbox info; (pod, container) -> container info
        self.pods: Dict[str, Dict] = {}
        self.containers: Dict[tuple, Dict] = {}

    def _hook_ctx(
        self, req: CRIRequest, response: Optional[Mapping] = None
    ) -> ContainerContext:
        """Post-stage hooks receive the RUNTIME'S RESPONSE state merged
        over the request (the reference dispatches the real response
        through the hook chain, ``server/cri/criserver.go:220``; round-2
        review flagged the request-only rebuild as context loss)."""
        pod = self.pods.get(req.pod_uid, {})
        resp_ann = dict((response or {}).get("annotations", {}))
        resp_labels = dict((response or {}).get("labels", {}))
        return ContainerContext(
            pod_uid=req.pod_uid,
            container_name=req.container_name,
            qos=req.labels.get("koordinator.sh/qosClass", pod.get("qos", "")),
            pod_annotations={
                **pod.get("annotations", {}),
                **req.annotations,
                **resp_ann,
            },
            pod_labels={**pod.get("labels", {}), **req.labels, **resp_labels},
            cgroup_dir=req.cgroup_parent,
            cfs_quota_us=req.cpu_quota,
            cpu_shares=req.cpu_shares,
            cpuset_cpus=req.cpuset_cpus,
            memory_limit_bytes=req.memory_limit_bytes,
            requests={**pod.get("requests", {}), **req.requests},
            limits={**pod.get("limits", {}), **req.limits},
        )

    def _merge(self, req: CRIRequest, ctx: ContainerContext) -> CRIRequest:
        """Apply hook mutations back onto the request (resexecutor/cri
        request-merge semantics)."""
        if ctx.cfs_quota_us is not None:
            req.cpu_quota = ctx.cfs_quota_us
        if ctx.cpu_shares is not None:
            req.cpu_shares = ctx.cpu_shares
        if ctx.cpuset_cpus is not None:
            req.cpuset_cpus = ctx.cpuset_cpus
        if ctx.memory_limit_bytes is not None:
            req.memory_limit_bytes = ctx.memory_limit_bytes
        req.env.update(ctx.env)
        return req

    def intercept(self, req: CRIRequest) -> Mapping:
        """One proxied CRI call: pre hooks -> merge -> backend -> post
        hooks -> store (criserver interposition order: Post* stages run
        only after the runtime call returned)."""
        stage = _STAGE_BY_CALL.get(req.call)
        is_post = stage is not None and stage.startswith("Post")
        if stage is not None and not is_post:
            ctx = self._hook_ctx(req)
            try:
                self.registry.run(stage, ctx)
                req = self._merge(req, ctx)
            except Exception:
                if self.failure_policy == FailurePolicy.FAIL:
                    raise
                # Ignore: forward the original request untouched
                # (criserver failure-policy passthrough)

        resp = self.backend(req)

        if is_post:
            ctx = self._hook_ctx(req, response=resp)
            try:
                self.registry.run(stage, ctx)
            except Exception:
                if self.failure_policy == FailurePolicy.FAIL:
                    raise

        if req.call == "RunPodSandbox":
            self.pods[req.pod_uid] = {
                "annotations": dict(req.annotations),
                "labels": dict(req.labels),
                "qos": req.labels.get("koordinator.sh/qosClass", ""),
                "requests": dict(req.requests),
                "limits": dict(req.limits),
            }
        elif req.call == "CreateContainer":
            self.containers[(req.pod_uid, req.container_name)] = {
                "cpu_quota": req.cpu_quota,
                "cpuset": req.cpuset_cpus,
            }
        elif req.call == "StopPodSandbox":
            self.pods.pop(req.pod_uid, None)
            for key in [k for k in self.containers if k[0] == req.pod_uid]:
                self.containers.pop(key, None)
        return resp
