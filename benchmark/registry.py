"""Everything a cell is made of, found by name from ``BENCHMARK.json``: the
workload's configuration file, its traffic file
``benchmark/traffic/<mix>.json``, the limits of its correctness check
``benchmark/limits/<workload>.json``, and a metric's reader
``benchmark/metrics/<metric>.py`` (or, where there is none, that of the
name's part before its first dot: a metric such as ``step_ms_p50.serve``
is ``step_ms_p50`` with a bound and a set of cells of its own).  Adding a
cell, a mix or a metric adds files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload_name}.json").read_text())


def settings(cfg: dict, mix_: dict) -> dict:
    """A cell's training settings: the configuration's, under the mix's."""
    return {**cfg["train"], **mix_.get("train", {})}


def metric(name: str):
    """The reader module of metric ``name``: ``metrics/<name>.py``, else
    that of the part of ``name`` before its first dot (names may hold
    dots, so it is loaded from its file, not imported by a dotted name)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, kind: str, workload_name: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a workload reports."""
    return [m for m in bench[kind] if workload_name in m.get("workloads", [workload_name])]
