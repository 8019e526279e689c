"""``ops/_build.py``: when a kernel library counts as stale. Needs no
nvcc: the sources and the library are empty files in a temporary tree
whose modification times the test sets."""

import os

import pytest

from multimodalsimilar_tpu_torch.ops import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))

    def touch(path, mtime):
        path.write_text("")
        os.utime(path, (mtime, mtime))
        return path

    return csrc, build, touch


def test_missing_library_is_stale(tree):
    csrc, _, touch = tree
    touch(csrc / "topk.cu", 100)
    assert _build._stale("topk")


@pytest.mark.parametrize("edited,stale", [
    (None, False), ("topk.cu", True), ("tf32x3.cuh", True),
    ("arcface.cu", False)])
def test_a_newer_source_or_shared_header_rebuilds(tree, edited, stale):
    """The library is rebuilt when its own .cu or any csrc/*.cuh header
    is newer than it; another kernel's .cu does not touch it."""
    csrc, build, touch = tree
    for name in ("topk.cu", "arcface.cu", "tf32x3.cuh"):
        touch(csrc / name, 100)
    touch(build / "libtopk.so", 200)
    if edited:
        touch(csrc / edited, 300)
    assert _build._stale("topk") is stale
