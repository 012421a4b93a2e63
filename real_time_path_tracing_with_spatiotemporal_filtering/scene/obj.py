"""Wavefront OBJ loading.

The reference loads the Cornell Box twice with tinyobjloader
(main.cpp:409-462): once as a raw triangle soup for ray tracing and once
position-deduplicated for rasterization. Both index the same triangulation,
so a single load suffices here; :func:`deduplicate_positions` reproduces the
second view for API parity (the dedup'd mesh and the soup describe identical
triangles in identical order).

Quads and higher n-gons are fan-triangulated exactly like tinyobjloader's
default ((0, i, i+1) for i in 1..n-2), keeping primitive IDs aligned with the
reference's BLAS/raster primitive order -- the visibility LUT and all
temporal reprojection are keyed on those IDs.

A C++ fast path (native/objloader.cpp, loaded via ctypes) handles large
scenes; this module is the always-available reference implementation and the
parity oracle for it.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_SCENE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "assets",
    "CornellBox-Original-Merged.obj",
)


def ensure_default_scene() -> str:
    """Materialize the bundled Cornell Box OBJ and return its path.

    The reference vendors the asset (scenes/CornellBox-Original-Merged.obj,
    loaded at main.cpp:417). Here the same triangles are synthesized from the
    procedural generator (verified triangle-exact against the reference OBJ
    in tests) and written once into the package's assets directory, so
    ``load_obj()`` with no arguments works out of the box.
    """
    if not os.path.exists(DEFAULT_SCENE):
        from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
            procedural,
        )

        os.makedirs(os.path.dirname(DEFAULT_SCENE), exist_ok=True)
        procedural.write_obj(DEFAULT_SCENE, *procedural.cornell_box())
    return DEFAULT_SCENE


def parse_obj(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse OBJ source into (vertices (V, 3) f32, indices (T, 3) i32)."""
    vertices: list[tuple[float, float, float]] = []
    triangles: list[tuple[int, int, int]] = []

    def resolve(token: str) -> int:
        # "v", "v/vt", "v//vn", "v/vt/vn"; negative indices are relative.
        idx = int(token.split("/", 1)[0])
        if idx < 0:
            return len(vertices) + idx
        return idx - 1

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "v" and len(parts) >= 4:
            vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif parts[0] == "f" and len(parts) >= 4:
            corners = [resolve(tok) for tok in parts[1:]]
            for i in range(1, len(corners) - 1):
                triangles.append((corners[0], corners[i], corners[i + 1]))

    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    idx = np.asarray(triangles, np.int32).reshape(-1, 3)
    if idx.size and (idx.min() < 0 or idx.max() >= len(verts)):
        raise ValueError("OBJ face index out of range")
    return verts, idx


def load_obj_python(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Pure-Python OBJ load (the parity oracle for the native loader)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_obj(f.read())


def load_obj(path: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file, preferring the native C++ loader when built.

    Returns (vertices (V, 3) float32, indices (T, 3) int32). Defaults to the
    bundled Cornell Box (the reference's only scene, main.cpp:417).
    """
    if path is None:
        path = ensure_default_scene()
    if not os.path.exists(path):
        raise FileNotFoundError(f"OBJ file not found: {path!r}")
    try:
        from real_time_path_tracing_with_spatiotemporal_filtering.native import (
            loader as native_loader,
        )

        if native_loader.available():
            return native_loader.load_obj(path)
    except ImportError:
        pass
    return load_obj_python(path)


def deduplicate_positions(
    vertices: np.ndarray, indices: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Position-dedup in first-seen order (main.cpp:442-461).

    The reference's raster mesh collapses identical positions through an
    unordered_map keyed on position; we reproduce the same vertex ordering
    (first occurrence wins) and re-key the index buffer.
    """
    seen: dict[tuple[float, float, float], int] = {}
    new_vertices: list[np.ndarray] = []
    flat = indices.reshape(-1)
    out = np.empty_like(flat)
    for i, vi in enumerate(flat):
        key = tuple(vertices[vi])
        if key not in seen:
            seen[key] = len(new_vertices)
            new_vertices.append(vertices[vi])
        out[i] = seen[key]
    return (
        np.asarray(new_vertices, np.float32).reshape(-1, 3),
        out.reshape(indices.shape).astype(np.int32),
    )
