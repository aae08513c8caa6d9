"""The port's node agent (``koordinator_tpu_torch/koordlet/``, ``native.py``
and the runtime proxy), held against the JAX package.

The reference's own cases (``tests/test_koordlet.py``, ``test_nri.py``,
``test_metriccache_persistence.py``, ``test_statesinformer_producers.py``,
``test_native.py``, ``test_native_extras.py``,
``test_device_annotation_e2e.py``, ``test_kubelet_reserve.py``, the proxy
and remote-hook classes of ``test_servers_ha.py`` and the proxy class of
``test_webhook_features_proxy.py``) run through both packages by the
rebinding of ``tests/test_torch_koordlint.py``, in groups of at most 40
parametrised tests, each from its own ``tests/test_torch_koordlet_<group>.py``.

The port's own cases follow: the CUDA device enumeration, the native
library's build and its delta codec against the numpy one, servers that
let go of their threads when stopped, the on-disk state read across the
two packages, and the two koordlet anchors recomputed from the JAX package.
"""

import json
import os
import tempfile
import threading
import types

import numpy as np
import pytest
import torch

from koordinator_tpu.harness import extras_scenario as jx
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.koordlet import audit as j_audit
from koordinator_tpu.koordlet import collectors as j_collectors
from koordinator_tpu.koordlet import daemon as j_daemon
from koordinator_tpu.koordlet import metriccache as j_mc
from koordinator_tpu.koordlet import prediction as j_pred
from koordinator_tpu.koordlet import statesinformer as j_si
from koordinator_tpu.koordlet import sysfs as j_sysfs
from koordinator_tpu.model import device as j_device
from koordinator_tpu.model import topology as j_topology
from koordinator_tpu.ops import numa as j_numa
from koordinator_tpu.scheduler import framework as jfw
from koordinator_tpu.scheduler import plugins as jpl

from koordinator_tpu_torch import native
from koordinator_tpu_torch.bridge import state as t_state
from koordinator_tpu_torch.harness import extras_scenario as tx
from koordinator_tpu_torch.harness import koordlet_fleet as kf
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    KOORDLET_ANCHOR_SHA256,
    KOORDLET_QOS_SEED,
    KOORDLET_QOS_SHA256,
    cycle_digest,
)
from koordinator_tpu_torch.koordlet import audit as t_audit
from koordinator_tpu_torch.koordlet import collectors as t_collectors
from koordinator_tpu_torch.koordlet import metriccache as t_mc
from koordinator_tpu_torch.koordlet import prediction as t_pred
from koordinator_tpu_torch.koordlet import statesinformer as t_si
from koordinator_tpu_torch.model import resources as res
from koordinator_tpu_torch.model import topology as t_topology
from koordinator_tpu_torch.ops import numa as t_numa
from koordinator_tpu_torch.scheduler.framework import FrameworkExtender
from test_torch_constraints import PACKAGES
from test_torch_koordlint import reference_cases, rebound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's koordlet, native and proxy cases, in groups of at most
# 40 parametrised tests (20 cases on two packages): each group runs from
# ``tests/test_torch_koordlet_<group>.py``.  ``None`` stands for a
# module's test functions.
GROUPS = {
    "agent": (("test_koordlet", ("TestSysFS", "TestMetricCache", "TestCollectors",
                                 "TestNodeMetricReport", "TestResourceExecutor",
                                 "TestCPUSuppress")),),
    "qos": (("test_koordlet", ("TestMemoryEvict", "TestRuntimeHooks", "TestPrediction",
                               "TestPleg", "TestAudit", "TestDaemon", "TestResctrlFull",
                               "TestQOSStrategyIsolation")),),
    "nri": (("test_nri", ("TestNriDelivery", "TestDaemonNriWiring",
                          "TestDefaultDaemonProducers", "TestDefaultDaemonStrategyBattery")),
            ("test_metriccache_persistence", None),
            ("test_kubelet_reserve", ("TestKubeletStub", "TestReservationAsPod",
                                      "TestInformerKubeletSync"))),
    "native": (("test_native", ("TestLibrary", "TestPerfSingleReader")),
               ("test_native_extras", ("TestNativeExtrasParity",)),
               ("test_statesinformer_producers", (
                   "TestSysfsTopology", "TestNodeTopoReporter", "TestDeviceReporter",
                   "TestProducerToSchedulerChain", "TestDeviceProducerToScheduler"))),
    "proxy": (("test_device_annotation_e2e", ("TestAnnotationProtocol", "TestDeliveryModes")),
              ("test_servers_ha", ("TestCRIProxyBoundary", "TestDockerProxy",
                                   "TestRemoteHookDispatch")),
              ("test_webhook_features_proxy", ("TestRuntimeProxy",))),
}


def group_cases(group):
    """The reference cases of one group: ``(module, class, method)``, the
    class ``""`` for a module-level test function."""
    cases = []
    for module, classes in GROUPS[group]:
        if classes is None:
            bound = rebound(module, "koordinator_tpu")
            cases += [(module, "", name) for name in sorted(vars(bound))
                      if name.startswith("test_") and callable(getattr(bound, name))]
        else:
            cases += reference_cases(module, classes)
    return cases


def test_the_reference_cases_are_collected():
    every = [case for group in GROUPS for case in group_cases(group)]
    assert len(every) == len(set(every)) >= 85
    for group in GROUPS:
        assert os.path.exists(os.path.join(REPO, "tests", f"test_torch_koordlet_{group}.py"))
        assert len(PACKAGES) * len(group_cases(group)) <= 40
    # every class of the reference's koordlet suite runs
    koordlet = rebound("test_koordlet", "koordinator_tpu")
    classes = {name for name, v in vars(koordlet).items()
               if isinstance(v, type) and name.startswith("Test")}
    assert classes == {c[1] for c in every if c[0] == "test_koordlet"}


# ---------------------------------------------------------------------------
# the device enumeration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
def test_a_cpu_host_publishes_no_device_cr(package):
    """The default enumeration on a host without an accelerator: the
    reporter publishes no Device CR and the collector stores nothing, in
    both packages (the reference enumerates JAX's CPU devices and drops
    them; the port finds no CUDA device)."""
    si, col, mc = ((j_si, j_collectors, j_mc) if package == "koordinator_tpu"
                   else (t_si, t_collectors, t_mc))
    if package == "koordinator_tpu_torch":
        assert not torch.cuda.is_available()
        assert t_collectors._cuda_devices() == []
    informer = si.StatesInformer()
    assert si.DeviceReporter(informer).sync(1.0) == []
    assert informer.get_devices() == []
    cache = mc.MetricCache()
    col.DeviceCollector(cache).collect(1.0)
    assert cache.series_labels(mc.DEVICE_MEMORY_USED) == []


def test_cuda_enumeration_reports_each_card(monkeypatch):
    """One entry per CUDA device (minor, "gpu", memory used = total less
    free), one Device CR of type "gpu" each, the memory stored by minor."""
    free_total = {0: (60 << 30, 80 << 30), 1: (79 << 30, 80 << 30)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: free_total[i])
    assert t_collectors._cuda_devices() == [
        {"minor": 0, "platform": "gpu", "memory_used": 20 << 30},
        {"minor": 1, "platform": "gpu", "memory_used": 1 << 30},
    ]
    crs = t_si.DeviceReporter(t_si.StatesInformer()).sync(1.0)
    assert [(d["type"], d["minor"]) for d in crs] == [("gpu", 0), ("gpu", 1)]
    cache = t_mc.MetricCache()
    t_collectors.DeviceCollector(cache).collect(5.0)
    got = cache.query(t_mc.DEVICE_MEMORY_USED, start=0, end=10, agg=t_mc.AGG_LATEST,
                      labels={"minor": "0"})
    assert got == float(20 << 30)


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------


def _tree_state(path):
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            st = os.stat(os.path.join(d, n))
            out[os.path.join(d, n)] = (st.st_size, st.st_mtime_ns)
    return out


def test_native_builds_into_the_port_build_dir(monkeypatch, tmp_path):
    """The library is compiled from ``native/koordnative.cpp`` alone into
    the port's build directory, keyed by the source and flags; nothing in
    ``native/`` changes, and the compile's log is kept."""
    assert native.available()
    info = native.build_info()
    assert os.path.dirname(info["path"]) == os.path.join(REPO, "koordinator_tpu_torch", "_build")
    assert os.path.basename(info["path"]).startswith("libkoordnative-")
    before = _tree_state(os.path.join(REPO, "native"))
    # a fresh process's first use, into an empty build directory
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build_info", {})
    assert native.available()
    fresh = native.build_info()
    assert fresh["built"] and fresh["seconds"] > 0 and "error" not in fresh
    assert os.listdir(tmp_path) == [os.path.basename(fresh["path"])]
    assert os.path.basename(fresh["path"]) == os.path.basename(info["path"])
    assert _tree_state(os.path.join(REPO, "native")) == before


@pytest.mark.parametrize("seed", range(3))
def test_native_delta_codec_matches_the_numpy_one(seed):
    """``delta_encode`` of node rows with the incremental recipe's changed
    rows is byte-identical to ``bridge/state.py delta_encode``; the apply
    reproduces the next rows."""
    rng = np.random.default_rng(seed)
    n, r = 400, res.NUM_RESOURCES
    prev = rng.integers(0, 1 << 40, size=(n, r)).astype(np.int64)
    nxt = prev.copy()
    rows = np.unique((np.arange(64) * max(1, n // 64)) % n)
    nxt[rows[:, None], [0, 1]] = (prev[rows][:, [0, 1]]
                                  * rng.uniform(0, 0.5, (len(rows), 2))).astype(np.int64)
    idx, val = native.delta_encode(prev, nxt)
    want_idx, want_val = t_state.delta_encode(prev, nxt, prev.size)
    assert idx.tobytes() == want_idx.tobytes() and val.tobytes() == want_val.tobytes()
    assert len(idx) > 0
    base = prev.copy()
    native.delta_apply(base, idx, val)
    assert np.array_equal(base, nxt)


def test_native_read_files_match_python(tmp_path):
    nodes = jgen.quota_colocation(seed=0, pods=16, nodes=12, tenants=2)[0]
    files = kf.tree_files(kf.build_trees(str(tmp_path), nodes))
    assert len(files) > 50
    want = []
    for p in files:
        with open(p) as f:
            want.append(f.read())
    assert native.read_files(files) == want


# ---------------------------------------------------------------------------
# stopped servers let go of their threads
# ---------------------------------------------------------------------------


def _short_dir():
    return tempfile.mkdtemp(dir="/tmp")


def _stop_uds(kind, d):
    from koordinator_tpu_torch.koordlet.hookserver import HookServer
    from koordinator_tpu_torch.koordlet.runtimehooks import default_registry
    from koordinator_tpu_torch.runtimeproxy import CRIRequest
    from koordinator_tpu_torch.runtimeproxy_server import (
        CRIProxyClient, CRIProxyServer, FakeRuntimeServer)

    backend = FakeRuntimeServer(os.path.join(d, "rt.sock")).start()
    servers = [backend]
    if kind == "hook":
        servers.append(HookServer(os.path.join(d, "hk.sock"), default_registry()).start())
    if kind == "cri":
        proxy = CRIProxyServer(os.path.join(d, "px.sock"), backend.path,
                               default_registry()).start()
        client = CRIProxyClient(os.path.join(d, "px.sock"))
        assert client.call(CRIRequest(call="Version"))["handled_by"] == "fake-runtime"
        client.close()
        servers.append(proxy._server)
        proxy.stop()
    threads = [s._thread for s in servers]
    for s in servers:
        s.stop()
    return threads


@pytest.mark.parametrize("kind", ["runtime", "hook", "cri", "nri_runtime", "nri_plugin"])
def test_a_stopped_server_lets_go_of_its_thread(kind):
    """``stop``/``close`` wakes a thread blocked in ``accept()`` (closing a
    listening socket alone does not, on every kernel) and joins it."""
    from koordinator_tpu_torch.koordlet.nri import NriPlugin, NriRuntime
    from koordinator_tpu_torch.koordlet.runtimehooks import default_registry

    d = _short_dir()
    if kind in ("runtime", "hook", "cri"):
        threads = _stop_uds(kind, d)
    elif kind == "nri_runtime":
        runtime = NriRuntime(os.path.join(d, "nri.sock"))
        errors = []

        def accept():
            try:
                runtime.accept_plugin(timeout=60.0)
            except RuntimeError as exc:
                errors.append(str(exc))

        t = threading.Thread(target=accept)
        t.start()
        while runtime._accepting is None:
            threading.Event().wait(0.01)
        runtime.close()
        t.join(timeout=10.0)
        threads = [t]
        assert errors and "closed" in errors[0]
    else:
        runtime = NriRuntime(os.path.join(d, "nri.sock"))
        box = {}
        t = threading.Thread(target=lambda: box.update(
            p=NriPlugin(os.path.join(d, "nri.sock"), default_registry())))
        t.start()
        runtime.accept_plugin()
        t.join(timeout=10.0)
        box["p"].close()
        threads = [box["p"]._thread]
        runtime.close()
    assert threads and not any(th.is_alive() for th in threads)
    assert not any(n.endswith(".sock") for n in os.listdir(d))


# ---------------------------------------------------------------------------
# on-disk state read across the packages
# ---------------------------------------------------------------------------

MODULES = {"koordinator_tpu": (j_mc, j_pred, j_audit),
           "koordinator_tpu_torch": (t_mc, t_pred, t_audit)}
AGGS = ("AVG", "P50", "P90", "P95", "P99", "latest", "count", "max", "min")


def _samples(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(300):
        metric = ("node_cpu_usage", "node_memory_usage", "pod_cpu_usage")[k % 3]
        labels = {"pod": f"p{k % 4}"} if metric == "pod_cpu_usage" else None
        out.append((metric, float(rng.uniform(0, 64)), 1000.0 + k * 1.5, labels))
    return out


def _queries(cache):
    out = {}
    for metric in ("node_cpu_usage", "node_memory_usage", "pod_cpu_usage"):
        for labels in cache.series_labels(metric):
            for agg in AGGS:
                for start in (1000.0, 1200.0):
                    out[(metric, json.dumps(labels, sort_keys=True), agg, start)] = \
                        cache.query(metric, start=start, end=2000.0, agg=agg, labels=labels)
    return out


def _write_state(fmt, mods, d):
    mc, pred, audit = mods
    if fmt in ("wal", "wal_torn"):
        cache = mc.PersistentMetricCache(d, segment_bytes=2048)
        for metric, v, ts, labels in _samples(1):
            cache.append(metric, v, ts=ts, labels=labels)
        cache.close()
        if fmt == "wal_torn":
            last = sorted(os.listdir(d))[-1]
            with open(os.path.join(d, last), "ab") as f:
                f.write(b"\x01\x00\x00\x00\x07")  # half a record
    elif fmt == "npz":
        cache = mc.MetricCache()
        for metric, v, ts, labels in _samples(2):
            cache.append(metric, v, ts=ts, labels=labels)
        cache.save(os.path.join(d, "cache.npz"))
    elif fmt == "checkpoint":
        server = pred.PeakPredictServer(pred.FileCheckpointer(d))
        rng = np.random.default_rng(3)
        for k in range(500):
            server.update(("prod", "batch", "node/n0")[k % 3], float(rng.uniform(0, 32)),
                          ts=1000.0 + k * 30)
        server.checkpoint_all()
    else:
        a = audit.Auditor(d, max_file_bytes=2048, max_files=4)
        for k in range(80):
            a.log(("cgroup-write", "evict")[k % 2], pod=f"p{k}", value=k)


def _read_state(fmt, mods, d):
    mc, pred, audit = mods
    if fmt in ("wal", "wal_torn"):
        cache = mc.PersistentMetricCache(d, segment_bytes=2048)
        try:
            return _queries(cache)
        finally:
            cache.close()
    if fmt == "npz":
        cache = mc.MetricCache()
        assert cache.load(os.path.join(d, "cache.npz"))
        return _queries(cache)
    if fmt == "checkpoint":
        server = pred.PeakPredictServer(pred.FileCheckpointer(d))
        return {(key, p): server.peak(key, p=p, now=1e6)
                for key in sorted(server.hists) for p in (50.0, 90.0, 95.0, 99.0)}
    a = audit.Auditor(d, max_file_bytes=2048, max_files=4)
    return [a.read_events(limit=500), a.read_events(limit=7, event="evict")]


@pytest.mark.parametrize("fmt", ["wal", "wal_torn", "npz", "checkpoint", "audit"])
@pytest.mark.parametrize("writer", PACKAGES)
def test_state_written_by_one_package_reads_the_same_in_the_other(fmt, writer, tmp_path):
    """The metric WAL (its segments and a torn tail), the ``save`` npz,
    the prediction checkpoints and the audit log: each package reads what
    either wrote, with identical queries at every aggregation, the same
    predictions and the same events."""
    d = str(tmp_path / "state")
    _write_state(fmt, MODULES[writer], d)
    if fmt.startswith("wal"):
        assert len(os.listdir(d)) > 1  # rotated into segments
    got = {package: _read_state(fmt, MODULES[package], d) for package in PACKAGES}
    assert got["koordinator_tpu"] == got["koordinator_tpu_torch"]
    assert got["koordinator_tpu"]


# ---------------------------------------------------------------------------
# the fleet and the two anchors
# ---------------------------------------------------------------------------

J_IMPL = types.SimpleNamespace(
    generators=jgen, extras_scenario=jx, topology=j_topology, device=j_device,
    statesinformer=j_si, metriccache=j_mc, sysfs=j_sysfs, collectors=j_collectors,
    daemon=j_daemon, encode_kw={},
)


def _j_cycle(fleet):
    fx = jfw.FrameworkExtender([jpl.NodeNUMAResourcePlugin(), jpl.ReservationPlugin(),
                                jpl.DeviceSharePlugin()])
    fx.register_error_handler(lambda ctx, p, exc: True)
    zones, policy, devices, rsv = fleet.tables
    return fx.run_cycle(jfw.CycleContext(snapshot=fleet.snapshot, extras={
        "zones": zones, "numa_policy": policy, "devices": devices, "reservations": rsv}))


def _t_cycle(fleet):
    fx = FrameworkExtender(tx.extended_plugins())
    fx.register_error_handler(lambda ctx, p, exc: True)
    return fx.run_cycle(tx.extras_context(fleet.snapshot, *fleet.tables))


def _tensors(obj):
    return {f: np.asarray(getattr(obj, f)) for f in obj.__dataclass_fields__
            if getattr(obj, f) is not None and not isinstance(getattr(obj, f), (int, str))}


def test_the_fleet_reports_build_the_same_tables_in_both_packages(tmp_path):
    """At a small size: every reporter publishes, the usage column from the
    reports is the scenario's, each node's zones split its whole CPUs and
    memory, its devices are the advertised ones, and both packages'
    reports and tables agree exactly."""
    rec = {"seed": 3, "pods": 128, "nodes": 40, "tenants": 4}
    jf = kf.fleet_snapshot(str(tmp_path / "j"), **rec, impl=J_IMPL)
    tf = kf.fleet_snapshot(str(tmp_path / "t"), **rec, impl=kf.port_impl("cpu"))
    for field in ("topos", "devices", "usages", "trees"):
        assert getattr(jf.reports, field) == getattr(tf.reports, field)
    assert tf.reports.trees == len({kf.node_shape(nd) for nd in tf.nodes}) >= 2
    usage = np.asarray(tf.snapshot.nodes.usage)[:rec["nodes"]]
    assert np.array_equal(usage, kf.fleet_usage_rows(res, tf.nodes))
    for nd, topo, devs in zip(tf.nodes, tf.reports.topos, tf.reports.devices):
        cpus, mem = kf.node_shape(nd)
        zones = topo["zones"]
        assert sum(len(z["cpus"]) for z in zones) == cpus and len(zones) == kf.NUMA_NODES
        assert sum(z["resources"]["memory"] for z in zones) == mem
        assert len(devs) == len(kf.node_devices(nd))
    assert any(tf.reports.devices)
    for name in ("zones", "devices"):
        j, t = _tensors(getattr(jf, name)), _tensors(getattr(tf, name))
        assert j.keys() == t.keys()
        for key in j:
            assert np.array_equal(j[key], t[key]), (name, key)
    j, t = _tensors(jf.snapshot.nodes), _tensors(tf.snapshot.nodes)
    for key in j:
        assert np.array_equal(j[key], t[key]), key


@pytest.fixture(scope="module")
def fleet_anchor(tmp_path_factory):
    return kf.fleet_snapshot(str(tmp_path_factory.mktemp("jfleet")), **ANCHOR_RECIPE,
                             impl=J_IMPL)


def test_koordlet_anchor_from_the_reference(fleet_anchor):
    result = _j_cycle(fleet_anchor)
    assert cycle_digest(result.assignment, result.status) == KOORDLET_ANCHOR_SHA256
    assert int((np.asarray(result.assignment) >= 0).sum()) > ANCHOR_RECIPE["pods"] // 2


def test_port_meets_the_koordlet_anchor(tmp_path):
    fleet = kf.fleet_snapshot(str(tmp_path), **ANCHOR_RECIPE, impl=kf.port_impl("cpu"))
    result = _t_cycle(fleet)
    assert cycle_digest(result.assignment, result.status) == KOORDLET_ANCHOR_SHA256


@pytest.mark.parametrize("package", PACKAGES)
def test_qos_anchor(package):
    """The daemon over the synthetic node: every QoS strategy runs, and the
    tree and the evictions after each tick give the constant."""
    impl = J_IMPL if package == "koordinator_tpu" else kf.port_impl("cpu")
    root = _short_dir()
    tree = kf.QosTree(root, KOORDLET_QOS_SEED)
    d = kf.qos_daemon(impl, root)
    try:
        digest, ran, tick_ms = kf.run_qos_ticks(d, tree)
    finally:
        d.shutdown()
    assert digest == KOORDLET_QOS_SHA256
    assert len(ran[-1]) == len(d.qos.strategies) == 8
    assert d.evictor.evicted
    assert os.path.exists(os.path.join(root, "sys", "fs", "cgroup", "kubepods", "besteffort",
                                       "cpu.max"))


@pytest.mark.parametrize("package", PACKAGES)
def test_zones_from_reports_refuse_a_pod_asking_for_a_resource_they_lack(package, tmp_path):
    """A NodeResourceTopology report carries cpu and memory per zone only,
    and the NUMA admission checks every requested resource against a zone:
    a pod that asks for ``pods`` is refused by every single-NUMA-node and
    restricted node built from reports, in both packages (kept for parity;
    ROADMAP Queue C)."""
    if package == "koordinator_tpu":
        si, topo, numa, impl, arr = j_si, j_topology, j_numa, J_IMPL, np.asarray
    else:
        si, topo, numa, impl, arr = (t_si, t_topology, t_numa, kf.port_impl("cpu"),
                                     torch.as_tensor)
    kf.write_topology(str(tmp_path), 16, 64 << 30)
    informer = si.StatesInformer()
    si.NodeTopoReporter(impl.sysfs.SysFS(root=str(tmp_path)), informer, "n0").sync(1.0)
    zones = topo.encode_zones(si.zones_from_node_topos([informer.get_node_topo()]),
                              node_bucket=1, **impl.encode_kw)
    requests = np.zeros((2, res.NUM_RESOURCES), np.int64)
    requests[:, res.RESOURCE_INDEX[res.CPU]] = 1000
    requests[1, res.RESOURCE_INDEX["pods"]] = 1
    admitted = {}
    for policy in (numa.POLICY_NONE, numa.POLICY_RESTRICTED, numa.POLICY_SINGLE_NUMA_NODE):
        got = numa.numa_admit_mask(arr(requests), zones.allocatable, zones.requested,
                                   zones.valid, arr(np.asarray([policy], np.int32)))
        admitted[policy] = np.asarray(got)[:, 0].tolist()
    assert admitted == {numa.POLICY_NONE: [True, True],
                        numa.POLICY_RESTRICTED: [True, False],
                        numa.POLICY_SINGLE_NUMA_NODE: [True, False]}
