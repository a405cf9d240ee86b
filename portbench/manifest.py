"""``BENCHMARK.json`` and the files it names, found by name.

* a cell ``<config>.<traffic>`` is an entry of ``workloads``;
* its configuration is the ``file`` of the ``configs`` entry it names;
* its traffic is ``portbench/traffic/<traffic>.json``, whose ``driver``
  names ``portbench/drivers/<driver>.py``;
* each metric is read by ``portbench/metrics/<metric>.py`` (its ``read``);
* its limits are ``portbench/limits/<cell>.json``.

A cell or a metric is added by adding files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load() -> dict:
    return _read_json(CHECKOUT / "BENCHMARK.json")


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The workload entry ``name``, with its configuration, traffic and
    limits loaded: ``{"entry", "config", "traffic", "limits"}``."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]]
    if len(cfg) != 1:
        raise KeyError(f"workload {name!r} names an unknown config {w['config']!r}")
    return dict(entry=w,
                config=_read_json(CHECKOUT / cfg[0]["file"]),
                traffic=_read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(HERE / "limits" / f"{name}.json"))


def metrics(bench: dict, name: str, traced: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def reader(metric: str):
    """The ``read(run)`` of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(traffic: dict):
    """The ``Driver`` class of the traffic's driver module."""
    if not MODULE.match(traffic["driver"]):
        raise ValueError(f"bad driver name {traffic['driver']!r}")
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver
