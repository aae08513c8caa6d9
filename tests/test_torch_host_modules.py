"""The daemon's host modules of the port against the reference's on the
CPU: the REST services API (``scheduler/services.py``), the component
config (``scheduler/config_api.py``), the feature gates (``features.py``)
and the HTTP lifecycle (``httpserving.py``).  Every compared value is a
status, a JSON body, a dataclass field or a gate, so every comparison is
exact."""

import json

import pytest

from koordinator_tpu_torch.harness import generators


def _wsgi(app, path, query=""):
    captured = {}

    def start_response(status, headers):
        captured["status"] = status

    body = b"".join(app({"PATH_INFO": path, "QUERY_STRING": query}, start_response))
    return captured["status"], json.loads(body) if body else None


@pytest.mark.parametrize("path", [
    "/apis/v1/nodes/{first}", "/apis/v1/nodes/ghost", "/apis/v1/plugins/none/x",
    "/apis/v1/plugins", "/apis/v1/plugins/loadaware/state", "/apis/v1/plugins/bad/x",
    "/apis/v1/plugins/frameworkext/debug-scores",
    "/apis/v1/plugins/frameworkext/set-debug-scores",
])
def test_the_services_api_answers_as_the_references(path):
    """The REST services API on the same cluster: every route's status and
    body equal the reference's (a node view, a miss, plugin routes, a
    handler's error, the FrameworkExtender's endpoints)."""
    from koordinator_tpu.harness import generators as ref_generators
    from koordinator_tpu.model import encode_snapshot as ref_encode
    from koordinator_tpu.scheduler.framework import FrameworkExtender as RefExtender
    from koordinator_tpu.scheduler.services import (
        APIService as RefAPI, install_framework_endpoints as ref_install)

    from koordinator_tpu_torch.model import encode_snapshot
    from koordinator_tpu_torch.scheduler.framework import FrameworkExtender
    from koordinator_tpu_torch.scheduler.services import (
        APIService, install_framework_endpoints)

    out = []
    for api_cls, encode, gens, fx, install, kw in (
        (RefAPI, ref_encode, ref_generators, RefExtender, ref_install, {}),
        (APIService, encode_snapshot, generators, FrameworkExtender,
         install_framework_endpoints, {"device": "cpu"}),
    ):
        api = api_cls()
        nodes, pods, gangs, quotas = gens.spark_colocation()
        api.set_snapshot(encode(nodes, pods, gangs, quotas, **kw))
        api.register_plugin("loadaware", "state", lambda q: (200, {"ok": True}))
        api.register_plugin("bad", "x", lambda q: 1 / 0)
        install(api, fx([]))
        query = "top_n=3" if path.endswith("set-debug-scores") else ""
        out.append(_wsgi(api.wsgi_app, path.format(first=nodes[0]["name"]), query))
    assert out[1] == out[0]


CONFIGS = {
    "defaults": {},
    "yaml": """
profiles:
- schedulerName: koord-scheduler
  pluginConfig:
  - name: LoadAwareScheduling
    args:
      usageThresholds: {cpu: 65, memory: 95}
      estimatedScalingFactors: {cpu: 85, memory: 70}
  - name: NodeResourcesFit
    args:
      scoringStrategy:
        type: MostAllocated
        resources: [{name: cpu, weight: 2}, {name: memory, weight: 1}]
  - name: Coscheduling
    args: {defaultTimeoutSeconds: 300}
""",
    "two_profiles": {"profiles": [{"schedulerName": "a"}, {
        "schedulerName": "b", "pluginConfig": [
            {"name": "ElasticQuota", "args": {"delayEvictTime": 60}}]}]},
    "unknown_plugin": {"pluginConfig": [{"name": "Bogus", "args": {}}]},
    "unknown_field": {"pluginConfig": [{"name": "Coscheduling", "args": {"nope": 1}}]},
    "percent_over_100": {"pluginConfig": [
        {"name": "LoadAwareScheduling", "args": {"usageThresholds": {"cpu": 150}}}]},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_config_equals_the_references(name):
    """The same component config loads to the same profiles (the port's
    CycleConfig field for field), or fails with the same message."""
    import dataclasses

    from koordinator_tpu.scheduler import config_api as ref

    from koordinator_tpu_torch.scheduler import config_api as port

    def load(mod):
        try:
            return [dataclasses.asdict(p) for p in mod.load_config(CONFIGS[name])]
        except mod.ConfigError as exc:
            return str(exc)

    want = load(ref)
    assert load(port) == want
    if name == "yaml":
        assert want[0]["cycle"]["fit_scoring_strategy"] == "MostAllocated"


def test_feature_gates_equal_the_references():
    from koordinator_tpu import features as ref

    from koordinator_tpu_torch import features as port

    for table in ("KOORDLET_FEATURES", "MANAGER_FEATURES", "SCHEDULER_FEATURES"):
        assert getattr(port, table) == getattr(ref, table)
    for mod in (port, ref):
        g = mod.FeatureGate(mod.KOORDLET_FEATURES)
        g.parse("CPICollector=true,BECPUSuppress=false")
        assert g.enabled("CPICollector") and not g.enabled("BECPUSuppress")
        with pytest.raises(KeyError):
            g.set("NoSuchGate", True)
        with pytest.raises(ValueError):
            g.parse("CPICollector=maybe")
        assert mod.default_scheduler_gate.known() == ref.default_scheduler_gate.known()
        assert not mod.is_feature_disabled(
            {"resourceUsedThresholdWithBE": {"enable": True}}, "BECPUSuppress")
        assert mod.is_feature_disabled({}, "BECPUSuppress")


def test_the_http_lifecycle_stops_a_server_that_never_served():
    from http.server import HTTPServer

    from koordinator_tpu_torch.httpserving import HTTPLifecycle, format_thread_stacks

    never = HTTPLifecycle(HTTPServer(("127.0.0.1", 0), None))
    never.stop()  # no serve loop ran: must not block on shutdown()
    served = HTTPLifecycle(HTTPServer(("127.0.0.1", 0), None))
    served.start()
    served.stop()
    assert "Thread" in format_thread_stacks()
