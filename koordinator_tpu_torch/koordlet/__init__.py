"""koordlet — the node agent.

Reference: ``pkg/koordlet`` (``koordlet.go:68 NewDaemon``, ``:123 Run``)
wires six subsystems: metriccache -> statesinformer -> metricsadvisor ->
predictserver -> qosmanager -> runtimehooks.  ``Daemon`` here wires the
same set over the fake-able SysFS layer; ``run_once`` advances every
subsystem one tick (production loops call it from timers; tests drive it
directly, the same seam the reference's gomock harness fakes).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.collectors import (
    BEResourceCollector,
    Collector,
    MetricsAdvisor,
    NodeResourceCollector,
    PodMeta,
    PodResourceCollector,
    PSICollector,
    SysResourceCollector,
)
from koordinator_tpu_torch.koordlet.metriccache import MetricCache
from koordinator_tpu_torch.koordlet.pleg import Pleg
from koordinator_tpu_torch.koordlet.prediction import FileCheckpointer, PeakPredictServer
from koordinator_tpu_torch.koordlet.qosmanager import (
    Evictor,
    QOSManager,
    default_qos_strategies,
)
from koordinator_tpu_torch.koordlet.resourceexecutor import ResourceUpdateExecutor
from koordinator_tpu_torch.koordlet.runtimehooks import Reconciler, default_registry
from koordinator_tpu_torch.koordlet.statesinformer import (
    NodeMetricReporter,
    StatesInformer,
)
from koordinator_tpu_torch.koordlet.sysfs import SysFS


class Daemon:
    """koordlet.go:68 NewDaemon analog."""

    def __init__(
        self,
        fs: Optional[SysFS] = None,
        *,
        audit_dir: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        evictor: Optional[Evictor] = None,
    ):
        self.fs = fs or SysFS()
        self.cache = MetricCache()
        self.informer = StatesInformer()
        self.audit = Auditor(audit_dir) if audit_dir else None
        self.executor = ResourceUpdateExecutor(self.fs, audit=self.audit)
        self.evictor = evictor or Evictor()
        self.pleg = Pleg(self.fs)
        self.advisor = MetricsAdvisor(
            [
                NodeResourceCollector(self.fs, self.cache),
                PodResourceCollector(self.fs, self.cache, self.informer.get_all_pods),
                BEResourceCollector(self.fs, self.cache),
                SysResourceCollector(self.cache),
                PSICollector(self.fs, self.cache),
            ]
        )
        self.predictor = PeakPredictServer(
            FileCheckpointer(checkpoint_dir) if checkpoint_dir else None
        )
        self.reporter = NodeMetricReporter(self.cache, self.informer)
        self.qos = QOSManager(
            default_qos_strategies(
                self.informer, self.cache, self.executor, self.evictor
            )
        )
        self.hooks = default_registry()
        self.reconciler = Reconciler(self.hooks, self.executor)

    def run_once(self, now: Optional[float] = None) -> dict:
        """One tick of every subsystem; returns what ran."""
        now = time.time() if now is None else now
        pleg_events = self.pleg.poll_once()
        collected = self.advisor.run_once(now)
        qos_ran = self.qos.run_once(now)
        report = self.reporter.collect(now)
        return {
            "pleg": pleg_events,
            "collectors": collected,
            "qos": qos_ran,
            "node_metric": report,
        }
