"""The native dense library is built from the committed source under a
name keyed by the source hash: a changed source builds a new library, an
unchanged one is reused, and a failed build is reported."""

import ctypes
import os
import shutil

import pytest

from arnoldimethod_jax.dense import native

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs g++ to build"
)

SRC = 'extern "C" int am_probe() { return %d; }\n'


def _write(path, value):
    path.write_text(SRC % value)
    return str(path)


def test_rebuild_after_source_hash_changes(tmp_path):
    src = _write(tmp_path / "probe.cpp", 1)
    p1, err = native.build(src, str(tmp_path))
    assert err is None and os.path.exists(p1)
    assert ctypes.CDLL(p1).am_probe() == 1

    _write(tmp_path / "probe.cpp", 2)
    p2, err = native.build(src, str(tmp_path))
    assert err is None and p2 != p1
    assert ctypes.CDLL(p2).am_probe() == 2
    assert os.path.exists(p1)  # the other version's library is untouched


def test_unchanged_source_is_not_rebuilt(tmp_path):
    src = _write(tmp_path / "probe.cpp", 3)
    p1, _ = native.build(src, str(tmp_path))
    mtime = os.stat(p1).st_mtime_ns
    p2, err = native.build(src, str(tmp_path))
    assert err is None and p2 == p1
    assert os.stat(p2).st_mtime_ns == mtime
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_failed_build_is_reported(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    path, err = native.build(str(src), str(tmp_path))
    assert path is None
    assert "g++" in err and "broken.cpp" in err
    assert not os.path.exists(native.library_path(str(src), str(tmp_path)))


def test_package_library_matches_committed_source():
    """The library the package loaded is the one keyed by the committed
    source (never a stale build of another version)."""
    if not native.available():
        pytest.skip(f"native library unavailable: {native.build_error()}")
    expected = native.library_path(native._SRC_PATH)
    assert os.path.exists(expected)
    assert native._lib._name == expected
