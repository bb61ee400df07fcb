"""The kernel build's content hash covers every file a kernel includes.

A library's name carries a hash of its source, the headers in
``_build.HEADERS`` and the flags; a header missing from HEADERS would let
an edited header load a stale library. Runs without nvcc."""

import os
import re

import pytest

from vidmat_torch.ops import _build

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _csrc_files():
    return sorted(f for f in os.listdir(_build.CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


@pytest.mark.parametrize("name", _csrc_files())
def test_every_local_include_is_hashed(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        included = _LOCAL_INCLUDE.findall(f.read())
    missing = [h for h in included if h not in _build.HEADERS]
    assert not missing, f"{name} includes {missing}, not in _build.HEADERS"


def test_sources_and_headers_exist():
    for name in list(_build.SOURCES.values()) + list(_build.HEADERS):
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, name)), name
    # Every source in csrc/ is built, every header is listed.
    files = _csrc_files()
    assert sorted(f for f in files if f.endswith(".cu")) == sorted(
        _build.SOURCES.values())
    assert sorted(f for f in files if f.endswith(".cuh")) == sorted(
        _build.HEADERS)


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    """Editing a header changes the library name of a source including it."""
    for f in _csrc_files():
        with open(os.path.join(_build.CSRC_DIR, f), "rb") as src:
            (tmp_path / f).write_bytes(src.read())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build.library_path("planar_gru")
    with open(tmp_path / "planar_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("planar_gru") != before
