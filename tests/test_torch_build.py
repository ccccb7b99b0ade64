"""Where ``ray_tpu_torch/ops/_build.py`` puts a kernel library.

The library's name carries a hash of its source, of every header in
``csrc/`` and of the flags, so an edit to a header that a source includes
rebuilds it, and an unchanged tree reuses what was built. The path is
computed without ``nvcc``, here on a temporary copy of ``csrc/``.
"""

import shutil

import pytest

from ray_tpu_torch.ops import _build

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def _path(name, csrc, tmp_path):
    return _build.target_path(name, csrc, tmp_path / "build")


def test_every_source_has_a_library_path():
    assert "flash_attention" in SOURCES and "fused" in SOURCES
    assert list(_build.CSRC.glob("*.cuh")), "no header to hash"
    for name in SOURCES:
        path = _build.target_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


@pytest.mark.parametrize("name", SOURCES)
def test_unchanged_tree_keeps_its_path(csrc, tmp_path, name):
    first = _path(name, csrc, tmp_path)
    assert _path(name, csrc, tmp_path) == first
    assert _path(name, csrc, tmp_path).name \
        == _build.target_path(name).name


@pytest.mark.parametrize("name", SOURCES)
def test_header_edit_changes_the_path(csrc, tmp_path, name):
    before = _path(name, csrc, tmp_path)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _path(name, csrc, tmp_path) != before


def test_new_header_changes_the_path(csrc, tmp_path):
    before = _path("flash_attention", csrc, tmp_path)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _path("flash_attention", csrc, tmp_path) != before


def test_source_edit_changes_only_its_own_path(csrc, tmp_path):
    before = {name: _path(name, csrc, tmp_path) for name in SOURCES}
    source = csrc / "fused.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    after = {name: _path(name, csrc, tmp_path) for name in SOURCES}
    assert after["fused"] != before["fused"]
    assert after["flash_attention"] == before["flash_attention"]


def test_flags_change_the_path(csrc, tmp_path, monkeypatch):
    before = _path("flash_attention", csrc, tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _path("flash_attention", csrc, tmp_path) != before
