"""FrameworkExtender: the plugin pipeline around the batched cycle.

Counterpart of ``koordinator_tpu/scheduler/framework.py`` (reference
``pkg/scheduler/frameworkext``: transformers around PreFilter / Filter /
Score, ``framework_extender.go:155,192,216``; reservation extension points,
``interface.go:110-226``; debug score tables, ``debug.go:37``; the
error-handler dispatcher, ``errorhandler_dispatcher.go``).

Every plugin contributes tensors, a bool ``[P, N]`` filter mask and an i64
``[P, N]`` score, composed once per cycle (masks AND, weighted scores SUM)
and handed to the port's ``solver.run_cycle``: on a CUDA snapshot the
kernel ladder, on the CPU the plain path.  The host extension points
(Reserve / Unreserve / PreBind) run only for the placements the cycle
chose, on numpy: each plugin first reads back, once for all of them, what
its hooks read (``TensorPlugin.read_back``), so no hook reads the device
once per placed pod.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.config import DEFAULT_CYCLE_CONFIG, CycleConfig
from koordinator_tpu_torch.model.snapshot import ClusterSnapshot
from koordinator_tpu_torch.solver import run_cycle, score_cycle
from koordinator_tpu_torch.solver.greedy import CycleResult


@dataclasses.dataclass
class CycleContext:
    """One scheduling cycle's world state handed to every plugin.

    ``extras`` carries optional subsystem tables (ZoneBatch,
    ReservationTable, DeviceBatch, policy vectors...) keyed by name;
    ``state`` is the host-side CycleState analog (reference
    framework.CycleState) for communication between extension points
    within the cycle.
    """

    snapshot: ClusterSnapshot
    cfg: CycleConfig = DEFAULT_CYCLE_CONFIG
    extras: Dict[str, object] = dataclasses.field(default_factory=dict)
    state: Dict[str, object] = dataclasses.field(default_factory=dict)


class TensorPlugin:
    """Base extended plugin (reference framework.Plugin + frameworkext
    extension interfaces).  Override any subset."""

    name = "plugin"
    weight = 1

    def filter_mask(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        """bool[P, N] admission mask, or None when not filtering."""
        return None

    def score(self, ctx: CycleContext) -> Optional[torch.Tensor]:
        """i64[P, N] scores in [0, MAX_NODE_SCORE], or None."""
        return None

    # Host-side extension points, invoked for chosen placements only.
    def read_back(self, ctx: CycleContext, pods: np.ndarray, nodes: np.ndarray) -> None:
        """Read to the host what ``reserve`` and ``pre_bind`` read for the
        placements ``pods[i]`` on ``nodes[i]`` (host int64 arrays), in one
        pass for all of them, into ``ctx.state``.  The framework calls it
        once a cycle: before the Reserve hooks, and before the PreBind hooks
        of a result it did not reserve.  Idempotent."""

    def host_value(self, ctx: CycleContext, key: str, pod_idx: int, node_idx: int):
        """``ctx.state[key][(pod_idx, node_idx)]`` as ``read_back`` stored
        it; a hook called outside the framework reads back its one
        placement first."""
        table = ctx.state.get(key)
        if table is None or (pod_idx, node_idx) not in table:
            self.read_back(ctx, np.array([pod_idx]), np.array([node_idx]))
            table = ctx.state[key]
        return table[(pod_idx, node_idx)]

    def reserve(self, ctx: CycleContext, pod_idx: int, node_idx: int) -> None:
        pass

    def unreserve(self, ctx: CycleContext, pod_idx: int, node_idx: int) -> None:
        pass

    def pre_bind(
        self, ctx: CycleContext, pod_idx: int, node_idx: int
    ) -> Optional[Mapping]:
        """Return a patch fragment; DefaultPreBind merges all fragments
        into one apiserver patch (reference plugins/defaultprebind)."""
        return None


Transformer = Callable[[CycleContext], CycleContext]
ErrorHandler = Callable[[CycleContext, int, Exception], bool]


@dataclasses.dataclass
class DebugScoresTable:
    """Top-N per-plugin score table (reference frameworkext/debug.go:37)."""

    top_n: int
    rows: List[Tuple[str, List[Tuple[str, int]]]]

    def __str__(self) -> str:
        lines = []
        for plugin, pairs in self.rows:
            cells = " | ".join(f"{n}:{s}" for n, s in pairs)
            lines.append(f"{plugin:>24} | {cells}")
        return "\n".join(lines)


def _placements(result: CycleResult, assigned_only: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(pods, nodes) of the cycle's placements, read to the host once;
    ``assigned_only`` keeps the pods whose status is ASSIGNED."""
    assignment = result.assignment.cpu().numpy()
    placed = assignment >= 0
    if assigned_only:
        placed &= result.status.cpu().numpy() == 0
    pods = np.flatnonzero(placed)
    return pods, assignment[pods].astype(np.int64)


class FrameworkExtender:
    """Composes transformers + tensor plugins into one cycle."""

    def __init__(
        self,
        plugins: Sequence[TensorPlugin] = (),
        *,
        before_pre_filter: Sequence[Transformer] = (),
        before_score: Sequence[Transformer] = (),
        debug_top_n: int = 0,
    ):
        self.plugins = list(plugins)
        self.before_pre_filter = list(before_pre_filter)
        self.before_score = list(before_score)
        self.debug_top_n = debug_top_n
        self.error_handlers: List[ErrorHandler] = []
        self.last_debug: Optional[DebugScoresTable] = None

    def register(self, plugin: TensorPlugin) -> None:
        self.plugins.append(plugin)

    def register_error_handler(self, handler: ErrorHandler) -> None:
        """reference errorhandler_dispatcher.go: handlers run in order until
        one claims the failure."""
        self.error_handlers.append(handler)

    # -- phases -----------------------------------------------------------

    def run_transformers(self, ctx: CycleContext) -> CycleContext:
        """BeforePreFilter transformer chain (framework_extender.go:155)."""
        for t in self.before_pre_filter:
            ctx = t(ctx)
        return ctx

    def extended_tensors(
        self, ctx: CycleContext
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        """Collect every plugin's mask and weighted score."""
        mask = None
        total = None
        per_plugin: Dict[str, torch.Tensor] = {}
        for t in self.before_score:
            ctx = t(ctx)
        for pl in self.plugins:
            m = pl.filter_mask(ctx)
            if m is not None:
                mask = m if mask is None else (mask & m)
            s = pl.score(ctx)
            if s is not None:
                per_plugin[pl.name] = s
                ws = pl.weight * s
                total = ws if total is None else (total + ws)
        return mask, total, per_plugin

    def run_cycle(self, ctx: CycleContext, *, i32_ok: Optional[bool] = None) -> CycleResult:
        """transformers -> masks + scores -> the assignment cycle -> the
        Reserve hooks (the reference's full cycle).  The cycle is the port's
        ``solver.run_cycle``, whose ``i32_ok`` this passes on (False keeps a
        CUDA cycle off the int32 kernels); the reference calls its
        ``greedy_assign``, with the same placements."""
        ctx = self.run_transformers(ctx)
        mask, scores, per_plugin = self.extended_tensors(ctx)
        result = run_cycle(
            ctx.snapshot, ctx.cfg, extra_mask=mask, extra_scores=scores, i32_ok=i32_ok
        )
        if self.debug_top_n:
            self.last_debug = self._debug_table(ctx, per_plugin, result)
        self.run_reserve(ctx, result)
        return result

    def run_reserve(self, ctx: CycleContext, result: CycleResult) -> None:
        """Reserve every placement of ``result`` in pod order; a failing
        Reserve unwinds that pod (Unreserve on every plugin) and goes to the
        error handlers, and is raised when none claims it."""
        pods, nodes = _placements(result, assigned_only=False)
        for pl in self.plugins:
            pl.read_back(ctx, pods, nodes)
        ctx.state["read_back_for"] = result
        for p, node in zip(pods.tolist(), nodes.tolist()):
            try:
                for pl in self.plugins:
                    pl.reserve(ctx, p, node)
            except Exception as exc:  # Reserve failure unwinds (Unreserve)
                for pl in self.plugins:
                    pl.unreserve(ctx, p, node)
                handled = any(h(ctx, p, exc) for h in self.error_handlers)
                if not handled:
                    raise

    def post_filter_preempt(
        self, ctx: CycleContext, result: CycleResult
    ) -> Dict[str, object]:
        """PostFilter quota preemption (reference elasticquota/preempt.go).
        It needs ``constraints/quota_enforce.py`` and
        ``constraints/quota_manager.py``, which are not ported yet
        (ROADMAP Queue A item 15)."""
        raise NotImplementedError(
            "post_filter_preempt needs constraints/quota_enforce.py and "
            "quota_manager.py, not ported yet (ROADMAP Queue A item 15)"
        )

    def run_score_only(self, ctx: CycleContext):
        """Score-only mode for strict plugin parity checks (the reference
        seam at framework_extender.go:216)."""
        ctx = self.run_transformers(ctx)
        mask, extra, per_plugin = self.extended_tensors(ctx)
        scores, feasible = score_cycle(ctx.snapshot, ctx.cfg)
        if extra is not None:
            scores = scores + extra
        if mask is not None:
            feasible = feasible & mask
        return scores, feasible, per_plugin

    def pre_bind_patches(
        self, ctx: CycleContext, result: CycleResult
    ) -> Dict[int, Dict]:
        """DefaultPreBind: merge every plugin's patch fragments into one
        combined patch per assigned pod (reference
        plugins/defaultprebind/plugin.go)."""
        pods, nodes = _placements(result, assigned_only=True)
        if ctx.state.get("read_back_for") is not result:
            # run_reserve of this result read back a superset already
            for pl in self.plugins:
                pl.read_back(ctx, pods, nodes)
        patches: Dict[int, Dict] = {}
        for p, node in zip(pods.tolist(), nodes.tolist()):
            merged: Dict = {}
            for pl in self.plugins:
                frag = pl.pre_bind(ctx, p, node)
                if frag:
                    _deep_merge(merged, frag)
            if merged:
                patches[p] = merged
        return patches

    def _debug_table(
        self,
        ctx: CycleContext,
        per_plugin: Mapping[str, torch.Tensor],
        result: CycleResult,
    ) -> DebugScoresTable:
        node_names = ctx.snapshot.nodes.names or tuple(
            f"node-{i}" for i in range(ctx.snapshot.nodes.capacity)
        )
        rows = []
        for name, scores in per_plugin.items():
            s0 = (scores[0] if scores.dim() == 2 else scores).cpu().numpy()
            top = np.argsort(-s0)[: self.debug_top_n]
            rows.append(
                (name, [(node_names[i] if i < len(node_names) else str(i), int(s0[i]))
                        for i in top])
            )
        return DebugScoresTable(self.debug_top_n, rows)


def _deep_merge(dst: Dict, src: Mapping) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
