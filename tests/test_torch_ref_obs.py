"""The reference's ``tests/test_obs.py`` cases of the span recorder, the
metric families and the raw UDS server's malformed frames, and
``tests/test_trace_export.py::TestFlightDumpTraceIdSchema``, on both
packages; and the daemon's ``/metrics`` case in the port's idiom.

Each case runs through the rebinding of ``tests/test_torch_koordlint.py``
(``tests/test_torch_ref.py`` says how).
"""

import time
import urllib.request

import pytest

from test_torch_constraints import PACKAGES
from test_torch_ref import (  # noqa: F401  (``shared`` is a fixture)
    case_id,
    check_group_file,
    group_cases,
    run_reference_case,
    shared,
)
from test_torch_koordlint import rebound
from koordinator_tpu_torch.bridge import wire
from koordinator_tpu_torch.scheduler.server import SchedulerServer

NOT_PORTED = {
    ("test_obs", "TestDaemonMetricsEndpoint", "test_metrics_endpoint_serves_scorer_families"):
        "its families include koord_scorer_jit_cache_miss_total, which a fresh jax.jit "
        "program's XLA cache miss populates; the port compiles no program at run time "
        "and never counts one (mirrored below without it)",
}
CASES = group_cases("obs", NOT_PORTED)


def test_the_file_holds_at_most_forty_tests():
    check_group_file(__name__)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reference_case(case, package, shared, tmp_path, tmp_path_factory, monkeypatch,
                        capsys):
    run_reference_case(case, package, shared, tmp_path=tmp_path,
                       tmp_path_factory=tmp_path_factory, monkeypatch=monkeypatch,
                       capsys=capsys)


def test_the_daemon_metrics_endpoint_serves_the_scorer_families(tmp_path):
    """``TestDaemonMetricsEndpoint::test_metrics_endpoint_serves_scorer_families``
    in the port's idiom: the same daemon, cycle and exposition checks, and
    no jit cache-miss family, since the port never counts one."""
    ref = rebound("test_obs", "koordinator_tpu_torch")
    s = SchedulerServer(
        lease_path=str(tmp_path / "leader.lease"), uds_path=str(tmp_path / "scorer.sock"),
        http_port=0, enable_grpc=False, state_dir=str(tmp_path / "state"), device="cpu",
    ).start()
    try:
        deadline = time.time() + 10
        while not s.elector.is_leader and time.time() < deadline:
            time.sleep(0.05)
        state = ref._random_state(ref.np.random.RandomState(5), n_nodes=4, n_pods=8,
                                  with_quota=False)
        reply = s.servicer.sync(ref._full_sync_request(state))
        s.servicer.assign(wire.AssignRequest(snapshot_id=reply.snapshot_id))
        with urllib.request.urlopen(f"http://127.0.0.1:{s.http_port}/metrics",
                                    timeout=5) as resp:
            text = resp.read().decode()
    finally:
        s.stop()
    for family in ("koord_scorer_cycle_latency_ms", "koord_scorer_cycles_total",
                   "koord_scorer_sync_total", "koord_scheduler_leader"):
        assert text.count(f"# TYPE {family} ") == 1, family
    assert "koord_scorer_cycle_latency_ms_count" in text
    assert "koord_scorer_jit_cache_miss_total" not in text
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name_part, _, value = line.rpartition(" ")
        assert name_part and float(value) is not None
