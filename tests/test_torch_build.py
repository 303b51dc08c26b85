"""The kernels' build (qbmx_torch._build), as far as it runs without nvcc:
the library's content key and the refusal to go on without a toolkit."""

from __future__ import annotations

import shutil

import pytest

from qbmx_torch import _build


def test_digest_covers_every_source_and_header(tmp_path):
    """An edit to a shared header must rebuild the library, as an edit to a
    kernel source does; an unchanged tree keeps its key."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert {p.name for p in csrc.glob("*.cuh")} >= {"philox.cuh"}
    first = _build.source_digest(csrc)
    assert _build.source_digest(csrc) == first
    for name in ("philox.cuh", "sa_heatbath.cu"):
        src = csrc / name
        text = src.read_text()
        src.write_text(text + "\n// edited\n")
        assert _build.source_digest(csrc) != first, name
        src.write_text(text)
        assert _build.source_digest(csrc) == first
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.source_digest(csrc) != first


def test_no_toolkit_raises_instead_of_falling_back(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # no bin/nvcc there
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_kernels()
