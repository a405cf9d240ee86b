"""The run's frame: the check for JAX by top-level name, the result line's
schema, the refusals, and the reading of a profiler timeline."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import manifest
from portbench import run as bench_run
from portbench.trace import SOLVE, WINDOW, Trace
from portbench.tests.helpers import BIG_SEED, CELLS, small_traffic

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,found", [
    ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"]),
    ("svi_mapper_tpu.ops.paths", ["svi_mapper_tpu"]),
    ("svi_mapper_tpu_torch.ops.paths", []), ("jaxtyping", []), ("svi_mapper_tpu2", [])])
def test_forbidden_modules_compare_whole_top_level_names(name, found, monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in bench_run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench_run.forbidden_modules() == found


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced):
    cell = CELLS[1]
    result, checks = bench_run.run_cell(cell, BIG_SEED, 0.3, traced, torch.device("cpu"),
                                        traffic=small_traffic(cell))
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1
    bench = manifest.load()
    want = {m["name"]: m["unit"] for m in manifest.metrics(bench, cell, traced)}
    assert set(line["metrics"]) <= set(want)
    if not traced:
        assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(checks)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_checkout_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(manifest.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import torch; from portbench import run; from portbench.tests.helpers import "
            f"small_traffic; run.run_cell({CELLS[0]!r}, 1, 0.1, False, torch.device('cpu'), "
            f"traffic=small_traffic({CELLS[0]!r}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and "svi_mapper_tpu_torch" in p.stderr


class _Event:
    def __init__(self, name, start, end, cuda=False, corr=0, linked=0, thread=1):
        self._v = (name, start, end, cuda, corr, linked, thread)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def end_ns(self): return self._v[2]
    def device_type(self): return DeviceType.CUDA if self._v[3] else DeviceType.CPU
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]


def _trace(events):
    results = types.SimpleNamespace(events=lambda: events)
    return Trace(types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results)))


def test_trace_busy_idle_and_attribution():
    ev = [
        _Event(WINDOW, 100, 1100), _Event(SOLVE, 100, 600), _Event(SOLVE, 600, 1100),
        _Event(WINDOW, 100, 1100, cuda=True),                 # the span's device copy
        _Event("aten::linalg_cholesky_ex", 150, 400, corr=1),
        _Event("aten::mul", 160, 170, corr=2),                # called inside it
        _Event("cudaLaunchKernel", 161, 169, corr=900, linked=2),
        _Event("aten::add", 500, 510, corr=3),
        _Event("potrf_kernel", 200, 300, cuda=True, linked=2),
        _Event("add_kernel", 250, 350, cuda=True, linked=3),  # overlaps the first
        _Event("Memcpy DtoH (Device -> Pageable)", 700, 720, cuda=True, linked=3),
        _Event("before_window", 0, 50, cuda=True, linked=3),
    ]
    t = _trace(ev)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(170e-9)
    assert t.count("kernel") == 2 and t.count("gpu_memcpy", "DtoH") == 1
    assert t.launched_under(("aten::linalg_cholesky_ex",)) == pytest.approx(100e-9)
    assert t.device_seconds("potrf") == pytest.approx(100e-9)
    gaps = dict(t.top_idle_gaps())
    assert gaps["dispatch/aten::mul"] == pytest.approx(100e-9)
    assert gaps["dispatch/aten::add"] == pytest.approx(350e-9)
    assert gaps["window_end"] == pytest.approx(380e-9)
    assert t.top_device_ops()[0] == ["potrf_kernel", pytest.approx(100e-9)]
