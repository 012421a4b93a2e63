"""Native C++ OBJ loader vs the Python oracle."""

import os
import subprocess

import numpy as np
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.native import loader
from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
    obj as obj_mod,
    procedural,
)

NATIVE_DIR = os.path.dirname(os.path.abspath(loader.__file__))


def ensure_built() -> bool:
    if loader.available():
        return True
    try:
        subprocess.run(
            ["make", "-C", NATIVE_DIR], check=True, capture_output=True
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    loader._lib = None  # force re-probe
    return loader.available()


needs_native = pytest.mark.skipif(
    not ensure_built(), reason="native loader not built and no toolchain"
)


@needs_native
def test_matches_python_loader_on_cornell(tmp_path):
    verts, idx = procedural.cornell_box()
    path = str(tmp_path / "cornell.obj")
    procedural.write_obj(path, verts, idx)

    pv, pi = obj_mod.load_obj_python(path)
    nv, ni = loader.load_obj(path)
    np.testing.assert_array_equal(pv, nv)
    np.testing.assert_array_equal(pi, ni)


@needs_native
def test_quads_and_negative_indices(tmp_path):
    src = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
f -4 -3 -2
"""
    path = str(tmp_path / "quads.obj")
    with open(path, "w") as f:
        f.write(src)
    pv, pi = obj_mod.load_obj_python(path)
    nv, ni = loader.load_obj(path)
    np.testing.assert_array_equal(pv, nv)
    np.testing.assert_array_equal(pi, ni)
    assert pi.shape == (3, 3)  # quad fan-triangulated + one triangle


@needs_native
def test_slash_formats(tmp_path):
    src = """
v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vn 0 0 1
f 1/1 2/1 3/1
f 1//1 2//1 3//1
f 1/1/1 2/1/1 3/1/1
"""
    path = str(tmp_path / "slashes.obj")
    with open(path, "w") as f:
        f.write(src)
    pv, pi = obj_mod.load_obj_python(path)
    nv, ni = loader.load_obj(path)
    np.testing.assert_array_equal(pv, nv)
    np.testing.assert_array_equal(pi, ni)


@needs_native
def test_large_soup_roundtrip(tmp_path):
    verts, idx = procedural.random_soup(5000, seed=3)
    path = str(tmp_path / "soup.obj")
    procedural.write_obj(path, verts, idx)
    nv, ni = loader.load_obj(path)
    pv, pi = obj_mod.load_obj_python(path)
    np.testing.assert_array_equal(pv, nv)
    np.testing.assert_array_equal(pi, ni)


@needs_native
def test_bad_index_rejected(tmp_path):
    path = str(tmp_path / "bad.obj")
    with open(path, "w") as f:
        f.write("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError):
        loader.load_obj(path)


def test_load_obj_falls_back_without_native(tmp_path, monkeypatch):
    verts, idx = procedural.cornell_box()
    path = str(tmp_path / "c.obj")
    procedural.write_obj(path, verts, idx)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_LIB_PATH", "/nonexistent/libptsf.so")
    v, i = obj_mod.load_obj(path)
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(i, idx)
