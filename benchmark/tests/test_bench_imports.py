"""Nothing the harness or its reference loads has ``jax``, ``jaxlib``,
``flax`` or ``qbmx`` as its top-level module name, and the reference
loads nothing of the program."""

from __future__ import annotations

import subprocess
import sys

from benchmark import run
from benchmark.run import ROOT


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qbmx_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qbmx.models", sys)
    assert run.forbidden_modules() == ["qbmx"]


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_run_loads_nothing_forbidden():
    code = ("import torch; from benchmark import run; from benchmark.tests.bench_tiny import tiny; "
            "run.run_cell('flat_h5.sweep10_pt', 5, 0.1, False, torch.device('cpu'), shape=tiny); "
            "print(run.forbidden_modules())")
    assert _fresh(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.check, benchmark.bound, benchmark.data, "
            "benchmark.registry, benchmark.trace, benchmark.reference.dqbm, "
            "benchmark.reference.cdqbm; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'qbmx_torch', 'qbmx', 'jax', 'jaxlib', 'flax'}))")
    assert _fresh(code) == "[]"


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result: the run needs the program beside it."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch; from benchmark import run; "
            "print(run.run_cell('flat_h5.sweep10_sa', 5, 0.1, False, torch.device('cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "qbmx_torch" in out.stderr
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flat_h5.sweep10_sa",
                          "--seed", "5", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and not out.stdout.strip()
