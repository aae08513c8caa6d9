"""BENCHMARK.json against the contract's shape, and every file it names."""

import json
import re

import pytest

from kbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
DOC = manifest.load_manifest()


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["kbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) <= 64 * 1024


@pytest.mark.parametrize("field", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(field):
    names = [e["name"] for e in DOC[field]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_units_sources_and_directions():
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in DOC["end_to_end"]}


def test_every_cell_has_its_files():
    configs = {c["name"] for c in DOC["configs"]}
    for cell in DOC["workloads"]:
        assert cell["config"] in configs
        assert cell["chips"] == 1
        assert len(cell["why"]) <= 200
        loaded = manifest.load_cell(cell["name"])
        assert loaded.traffic["mix_name"] == cell["traffic"]
        assert loaded.config["name"] == cell["config"]
    used = {cell["config"] for cell in DOC["workloads"]}
    assert used == configs


def test_every_metric_has_a_reader_and_reports_steps_per_s():
    cells = {w["name"] for w in DOC["workloads"]}
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            # the end-to-end metric it moves is one the cell reports
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for cell in cells:
        loaded = manifest.load_cell(cell)
        assert {m["name"] for m in loaded.end_to_end} >= {"setup_s", "steps_per_s"}
        assert loaded.per_layer


def test_layers_are_named_alike():
    by_layer = {}
    for m in DOC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_configs_state_their_cut():
    for c in DOC["configs"]:
        with open(manifest.ROOT / c["file"]) as f:
            doc = json.load(f)
        assert doc["reduced"] == c["reduced"]
        assert doc["source"] == c["source"]
        assert c["file"].startswith("kbench/")
