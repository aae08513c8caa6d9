"""The co-location configuration (``configs/koord_colocation_4034n.json``)
and its reference (``reference/colocation.py``): the configuration's
arithmetic and groups, and a 1/64-scale copy (``tests/coloc_64n.json``)
replayed through the program on the CPU against the reference, reply for
reply, with the program's counters held to the reference's count at every
step; then the readers of the per-layer metrics the cell adds."""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from kbench import manifest, run

FULL = json.loads((manifest.ROOT / "kbench/configs/koord_colocation_4034n.json").read_text())
SMALL = json.loads((manifest.PACKAGE / "tests" / "coloc_64n.json").read_text())
GEN = manifest.load_module(FULL["generator"])
REF = manifest.load_module(FULL["reference"])
COUNTERS = ("placed", "unschedulable", "wait_gang", "gangs_held", "quota_bound")
SEEDS = (2718281, 2**31 + 5, 3141592653)


def small_cell(**traffic) -> manifest.Cell:
    """The 1/64 copy as a cell with ``coloc4k.bind``'s loop; its running
    pods are the generator's hard band (the cell's band is full size)."""
    base = manifest.load_cell("coloc4k.bind")
    loop = {k: v for k, v in base.traffic.items() if k != "running_pods"}
    return manifest.Cell(name="coloc64.bind", chips=1, config=SMALL,
                         traffic=dict(loop, **traffic), end_to_end=base.end_to_end, per_layer=[])


def test_the_cell_names_the_configuration_and_its_own_reference():
    cell = manifest.load_cell("coloc4k.bind")
    assert cell.config["name"] == "koord_colocation_4034n" and cell.chips == 1
    assert cell.generator is GEN and cell.reference is REF
    assert cell.traffic["cycle"] == {"wave": 1, "top_m": 4}
    assert (cell.traffic["top_k"], cell.traffic["warmup_steps"], cell.traffic["check_steps"]) \
        == (8, 8, 4)
    assert cell.traffic["lifetime_steps"] == [1, 3]
    lo, hi = run.running_band(cell)
    assert FULL["init_pods"] < lo < hi < FULL["init_pods"] + FULL["pending_pods"] * 3
    names = {m["name"] for m in cell.per_layer}
    assert {"gang_pass_ms", "tables_sync_ms", "quota_bound_share"} <= names


def test_the_nodes_follow_koordinators_formulas():
    alloc = FULL["node_groups"][0]["allocatable"]
    usage = FULL["node_metrics"]["usage"]
    cpu, mem = alloc["cpu"], alloc["memory"]
    assert (FULL["node_groups"][0]["count"], cpu, mem, alloc["pods"]) == (4034, 96000, 524288, 110)
    assert usage == {"cpu": cpu * 30 // 100, "memory": mem * 40 // 100}
    # batch = capacity - capacity * (100 - reclaim %) / 100 - prod usage (60 % cpu, 65 % memory)
    assert alloc["kubernetes.io/batch-cpu"] == cpu - cpu * 40 // 100 - usage["cpu"] == 28800
    assert alloc["kubernetes.io/batch-memory"] == mem - mem * 35 // 100 - usage["memory"]
    # mid = min(prod requests - prod usage, allocatable * 100 %)
    assert alloc["kubernetes.io/mid-cpu"] == min(cpu * 50 // 100 - usage["cpu"], cpu)
    assert alloc["kubernetes.io/mid-memory"] == min(mem * 55 // 100 - usage["memory"], mem)


def test_the_queue_holds_the_stated_templates_and_podgroups():
    d = GEN.Deployment(FULL)
    slots = dict(zip(d.names, d.slots.tolist()))
    for t in range(4):
        assert (slots[f"t{t}-online"], slots[f"t{t}-batch"], slots[f"t{t}-gang"]) == (1200, 1600, 1000)
    assert slots["mid-svc"] == 800 and d.owner.shape[0] == 500
    assert set(d.size[d.gang].tolist()) == {8}
    bands = {t["band"] for t in FULL["pod_templates"]}
    assert bands == {"koord-prod", "koord-mid", "koord-batch"}
    assert FULL["reduced"] == [] and set(FULL["assumed"]) >= {
        "memory_per_node", "requests", "template_shares", "tenants_and_groups", "gang_size",
        "node_usage", "init_pods", "pending_pods"}


@pytest.mark.parametrize("seed", SEEDS)
def test_no_group_starts_over_its_runtime(seed):
    model = GEN.build(FULL, seed)
    assert model.running_pods() == FULL["init_pods"] == 5 * 4034
    assert not ((model.quse > model.qrt) & (model.qlim != 0)).any()
    assert model.pending_pods() == FULL["pending_pods"]


def test_the_test_copy_is_the_configuration_at_1_64():
    assert SMALL["node_groups"][0]["allocatable"] == FULL["node_groups"][0]["allocatable"]
    assert SMALL["node_groups"][0]["count"] == 64
    assert SMALL["pod_templates"] == FULL["pod_templates"]
    assert SMALL["node_metrics"] == FULL["node_metrics"]
    assert (SMALL["pending_pods"], SMALL["init_pods"]) == (256, 320)
    for small, full in zip(SMALL["quotas"], FULL["quotas"]):
        assert small["name"] == full["name"]
        assert small["runtime"] == {k: v // 64 for k, v in full["runtime"].items()}


def counted_replay(cell, seed, steps):
    """The program's replies to ``steps`` cycles of the cell's loop on the
    CPU, through the raw framing to an in-process servicer with the launch
    ledger on: (score, assign, model, the Assign's counter rows' deltas)."""
    from kbench import serve
    from koordinator_tpu_torch.bridge.client import RAW_SCHEME, ScorerClient
    from koordinator_tpu_torch.bridge.server import ScorerServicer
    from koordinator_tpu_torch.bridge.udsserver import RawUdsServer
    from koordinator_tpu_torch.obs import devprof

    def totals():
        rows = devprof.summary()["boundaries"]
        return {n: rows.get(f"server.assign.count.{n}", {"total": 0})["total"] for n in COUNTERS}

    t, gen = cell.traffic, cell.generator
    model = gen.build(cell.config, seed)
    loop = gen.BindLoop(model, t["lifetime_steps"], seed)
    devprof.reset()
    sv = ScorerServicer(cfg=serve.cycle_config(t["cycle"]), device="cpu", trace_export=False,
                        devprof_sample=1)
    d = tempfile.mkdtemp(prefix="kbc-", dir="/tmp")
    server = RawUdsServer(os.path.join(d, "s.sock"), servicer=sv).start()
    client = ScorerClient(RAW_SCHEME + server.path)
    try:
        kwargs = gen.full_sync_kwargs(model)
        for _ in range(steps):
            before = totals()
            client.sync(**kwargs)
            score = client.score_flat(top_k=t["top_k"])
            assign = client.assign()[:2]
            after = totals()
            yield score, assign, model, {n: after[n] - before[n] for n in COUNTERS}
            nxt = loop.after_assign(model, *assign)
            kwargs, model = gen.sync_kwargs(model, nxt), nxt
    finally:
        client.close()
        server.stop()
        sv.telemetry.close()
        devprof.reset()
        os.rmdir(d) if not os.listdir(d) else None


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_replays_the_colocation_cluster_as_its_reference(seed):
    cell = small_cell()
    bands_every_step = []
    quota_steps = held_steps = 0
    for score, assign, model, counted in counted_replay(cell, seed, 64):
        assert run.compare(score, assign, model, cell) == {"score": 0, "assign": 0}
        assignment, status = (np.asarray(a) for a in assign)
        # the program's counters are the reference's count of its reply
        assert counted == REF.cycle_counts(model, assignment, status)
        quota_steps += counted["quota_bound"] > 0
        held_steps += counted["wait_gang"] > 0
        bands_every_step.append({SMALL["pod_templates"][t]["band"]
                                 for t in model.template[status == 0]})
    assert quota_steps > 0 and held_steps > 0
    # all three bands place pods, over the replay
    assert set().union(*bands_every_step) == {"koord-prod", "koord-mid", "koord-batch"}


def test_a_colocation_run_is_correct_through_the_harness():
    cell = small_cell(check_steps=6, warmup_steps=4)
    result = run.run(cell, seed=2**31 + 99, seconds=1.5, traced=False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["steps_compared"]["value"] >= 6


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, kbench.reference.colocation, kbench.gen.tenants;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'koordinator_tpu_torch', 'koordinator_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(manifest.ROOT))
    assert out.stdout.strip() == "[]"


def test_the_reference_refuses_a_cycle_key_it_has_no_semantics_for():
    with pytest.raises(ValueError, match="terms"):
        REF.Semantics({"wave": 1, "top_m": 4, "terms": True})


def test_a_held_gang_keeps_its_quota_for_the_rest_of_the_cycle():
    """Two 2-pod gangs of one group on an ample node: the group's runtime
    admits three pods, so the second gang is split and held, and the
    pods after it find the group full though the held member binds
    nothing."""
    model = GEN.build(dict(SMALL, node_groups=[dict(SMALL["node_groups"][0], count=2)],
                           init_pods=0, pending_pods=256), 1)
    model.gang_id = np.full(model.preq.shape[0], -1, np.int64)
    model.gang_min = np.array([2, 2], np.int64)
    model.quota_id = np.full(model.preq.shape[0], -1, np.int64)
    model.preq = np.zeros_like(model.preq)
    cpu = GEN.RESOURCE_INDEX["kubernetes.io/batch-cpu"]
    model.preq[:5, cpu] = 1000
    model.pest = model.preq.copy()
    model.priority = np.zeros(model.preq.shape[0], np.int64)
    model.gang_id[:4] = [0, 0, 1, 1]
    model.quota_id[:5] = 0
    model.qrt = np.zeros((1, GEN.R), np.int64)
    model.qrt[0, cpu] = 3000
    model.quse, model.qlim = np.zeros_like(model.qrt), (model.qrt > 0).astype(np.int64)
    assignment, status = REF.assign_reply(model, {"wave": 1, "top_m": 4})
    assert status[:5].tolist() == [0, 0, 2, 1, 1]
    counts = REF.cycle_counts(model, assignment, status)
    assert (counts["wait_gang"], counts["gangs_held"], counts["quota_bound"]) == (1, 1, 2)


# -- the readers of the cell's per-layer metrics --

def _row(total, n=20, kind="stage"):
    return {"launches": n, "sampled": n, "device_us_total": float(total), "kind": kind}


def _run(rows, steps=20):
    devprof = {"server.assign.finish": _row(9000.0), "server.sync.commit": _row(7000.0)}
    devprof.update(rows)
    return {"devprof": devprof, "counts": {"scores": steps, "assigns": steps}}


@pytest.mark.parametrize("metric, row", [("gang_pass_ms", "server.assign.gang"),
                                         ("tables_sync_ms", "server.sync.tables")])
def test_a_stage_reader_reads_ms_a_step_and_none_without_its_row(metric, row):
    read = manifest.reader(metric)
    assert read(_run({})) is None
    assert read(_run({row: _row(0.0, n=0)})) is None
    assert read(_run({row: _row(4000.0)})) == pytest.approx(0.2)
    assert read(_run({row: _row(4000.0)}, steps=0)) is None


def test_quota_bound_share_is_the_windows_share_and_none_on_a_parent():
    read = manifest.reader("quota_bound_share")
    counters = {f"server.assign.count.{n}": _row(v, kind="counter") for n, v in
                (("placed", 12000), ("unschedulable", 7000), ("wait_gang", 1000),
                 ("gangs_held", 300), ("quota_bound", 5000))}
    assert read(_run(counters)) == pytest.approx(25.0)
    for name in ("quota_bound", "placed", "unschedulable", "wait_gang"):
        partial = dict(counters)
        del partial[f"server.assign.count.{name}"]
        assert read(_run(partial)) is None, name
    assert read(_run({})) is None


@pytest.mark.parametrize("metric", ["gang_pass_ms", "tables_sync_ms", "quota_bound_share"])
def test_each_metric_is_declared_for_the_cell(metric):
    entry = next(m for m in manifest.load_manifest()["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and entry["moves"] == "steps_per_s"
    assert entry["workloads"] == ["coloc4k.bind"]
