"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + ALL_METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_one_line_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.metrics(BENCH, w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics(BENCH, w["name"], traced=True)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_a_metric_all_its_cells_report(m):
    assert set(m) - {"workloads"} == LAYER_KEYS
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        reported = {e["name"] for e in manifest.metrics(BENCH, cell, traced=False)}
        assert m["moves"] in reported


def test_every_configuration_has_a_cell_and_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["reduced"] == [] or all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_by_name(w):
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] == 1
    c = manifest.cell(BENCH, w["name"])
    assert c["config"]["name"] == w["config"]
    assert manifest.driver(c["traffic"]).__name__ == "Driver"
    assert c["limits"]["iterations_gap"] == 0
    for m in manifest.metrics(BENCH, w["name"], False) + manifest.metrics(BENCH, w["name"], True):
        assert callable(manifest.reader(m["name"]))
