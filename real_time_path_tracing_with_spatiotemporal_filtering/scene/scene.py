"""Scene, camera and light pytrees.

The reference's scene state is a pile of Vulkan buffers (vertex/index
buffers, visibility LUT, UBO matrices -- main.cpp:357-407, 471-478) mutated
in place; here it is immutable pytrees flowing through a pure frame function.
``TriangleData`` is the device-resident, precomputed form: intersection
planes, per-triangle unit normals, albedos, and the (T+1, 3, 3) visibility
LUT (slot 0 reserved for background, visibility.geom.glsl:32-35).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from real_time_path_tracing_with_spatiotemporal_filtering.ops import shading
from real_time_path_tracing_with_spatiotemporal_filtering.ops.intersect import (
    TrianglePlanes,
    build_triangle_planes,
)
from real_time_path_tracing_with_spatiotemporal_filtering.utils.pytree import (
    pytree_dataclass,
)


@pytree_dataclass
class Scene:
    """Triangle mesh in world space (model transform pre-applied; the
    reference's model matrix is always identity, main.cpp:482/1470)."""

    vertices: jnp.ndarray  # (V, 3) float32
    indices: jnp.ndarray   # (T, 3) int32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def triangles(self) -> jnp.ndarray:
        """(T, 3, 3) gathered triangle vertices."""
        return self.vertices[self.indices]

    @classmethod
    def from_arrays(cls, vertices: np.ndarray, indices: np.ndarray) -> "Scene":
        return cls(
            vertices=jnp.asarray(vertices, jnp.float32),
            indices=jnp.asarray(indices, jnp.int32),
        )

    @classmethod
    def cornell_box(cls) -> "Scene":
        from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
            procedural,
        )

        return cls.from_arrays(*procedural.cornell_box())


@pytree_dataclass
class Camera:
    """Pinhole camera. The reference camera never rotates (rays go along
    -z, raytrace.comp.glsl:319; view is a translation, main.cpp:1471), so
    ``rotation`` defaults to identity for parity; it is a camera->world
    basis (columns = right, up, back) enabling orbits/look-at as an
    extension."""

    position: jnp.ndarray  # (3,) float32
    rotation: jnp.ndarray  # (3, 3) float32, camera->world

    @classmethod
    def default(cls) -> "Camera":
        # main.cpp:65 cameraOrigin(-0.001, 1.0, 6.0)
        return cls(
            position=jnp.array([-0.001, 1.0, 6.0], jnp.float32),
            rotation=jnp.eye(3, dtype=jnp.float32),
        )

    @classmethod
    def looking_at(cls, position, target, up=(0.0, 1.0, 0.0)) -> "Camera":
        """Extension: camera at ``position`` looking at ``target``."""
        import numpy as np

        p = np.asarray(position, np.float32)
        f = np.asarray(target, np.float32) - p
        f = f / np.linalg.norm(f)
        u = np.asarray(up, np.float32)
        r = np.cross(f, u)
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        rot = np.stack([r, u, -f], axis=1)  # columns: right, up, back
        # numpy leaves on purpose: an orbit/look-at camera is rebuilt every
        # frame, and numpy inputs ship with the frame dispatch instead of
        # paying an eager host->device transfer here.
        return cls(position=p, rotation=rot)

    @classmethod
    def orbit(cls, center, radius, azimuth, height) -> "Camera":
        """Extension: orbit around ``center`` at ``radius``, looking in."""
        import numpy as np

        c = np.asarray(center, np.float32)
        pos = c + np.array(
            [radius * np.sin(azimuth), height, radius * np.cos(azimuth)],
            np.float32,
        )
        return cls.looking_at(pos, c)


@pytree_dataclass
class Light:
    """Analytic sphere light (raytrace.comp.glsl:26-30, 278-282). ``color``
    is the LDR base color; kernels scale by cfg.light_intensity."""

    position: jnp.ndarray  # (3,) float32
    color: jnp.ndarray     # (3,) float32

    @classmethod
    def default(cls) -> "Light":
        # main.cpp:70-72: lightPos(1, 1.0, -0.4), lightColor(0.5, 0.5, 0.5)
        return cls(
            position=jnp.array([1.0, 1.0, -0.4], jnp.float32),
            color=jnp.array([0.5, 0.5, 0.5], jnp.float32),
        )


@pytree_dataclass
class TriangleData:
    """Precomputed device-side triangle tables.

    ``lut`` is the visibility LUT: world-space triangle vertices at slot
    primID+1 with slot 0 zeroed for background -- the same layout the
    reference's geometry shader scatters every frame
    (visibility.geom.glsl:32-35). With static geometry we build it once.
    ``lut_normals`` caches getNormalFromTriangleIndex
    (temporalFiltering.comp.glsl:80-91): slot 0 is the background sentinel
    normal (0, 0, 1).
    """

    planes: TrianglePlanes     # intersection constants, all (T, ...)
    normals: jnp.ndarray       # (T, 3) unit geometric normals (raytrace:150)
    albedo: jnp.ndarray        # (T, 3) hardcoded material (raytrace:155-163)
    lut: jnp.ndarray           # (T+1, 3, 3) visibility LUT
    lut_normals: jnp.ndarray   # (T+1, 3) filter normals w/ background slot


def transform_triangle_data(
    tri_data: "TriangleData", model: jnp.ndarray
) -> "TriangleData":
    """Apply a per-frame model matrix to static triangle tables, in-graph.

    The reference carries ``model``/``modelPrev`` in its UBO and applies
    them in the visibility vertex shader (visibility.vert.glsl:22-24,
    main.cpp:1465-1469) -- always identity in practice, but the plumbing
    for animated geometry exists. This is the equivalent here: a jittable
    map from the rest-pose tables to the transformed frame's tables, so
    the whole thing fuses into the frame program. ``modelPrev`` needs no
    explicit plumbing here: History.lut carries the PREVIOUS frame's
    transformed vertices (the reference's end-of-frame LUT blit,
    main.cpp:1370-1372), which is exactly what the filter backprojection
    and the temporal gradient consume for reprojection under motion.

    ``model`` is a (4, 4) (or (3, 4)) row-major matrix applied as
    ``p' = M[:3, :3] @ p + M[:3, 3]``. Intersection planes and unit
    normals are rebuilt from the transformed vertices; the normal-keyed
    albedo is re-derived from the new normals because the reference
    computes it from the hit normal AT TRACE TIME
    (raytrace.comp.glsl:155-163), so a rotated wall changes color there
    too.
    """
    m = jnp.asarray(model, jnp.float32)
    rot = m[:3, :3]
    trans = m[:3, 3]
    tris = (
        jnp.einsum(
            "ij,tvj->tvi",
            rot,
            tri_data.lut[1:],
            precision=jax.lax.Precision.HIGHEST,
        )
        + trans
    )
    planes = build_triangle_planes(tris)
    normals = planes.n / jnp.linalg.norm(planes.n, axis=-1, keepdims=True)
    lut = jnp.concatenate([jnp.zeros((1, 3, 3), jnp.float32), tris], axis=0)
    lut_normals = jnp.concatenate(
        [jnp.array([[0.0, 0.0, 1.0]], jnp.float32), normals], axis=0
    )
    return TriangleData(
        planes=planes,
        normals=normals,
        albedo=shading.albedo_from_normal(normals),
        lut=lut,
        lut_normals=lut_normals,
    )


# Above this triangle count the base tables are built with numpy instead of
# eager jnp (which costs seconds of per-op dispatch at 250k tris). The two
# paths differ by <= 1 ulp (XLA's CPU cross product uses FMA, numpy's
# cannot), so small scenes keep the jax path to hold golden snapshots
# bit-stable; at large-scene sizes every trace route consumes the same
# tables, so the ulp never becomes a parity issue.
_NUMPY_PREP_MIN_TRIS = 1024


def _base_tables_np(tris: np.ndarray):
    """Numpy twin of the jax table build (within 1 ulp, see
    _NUMPY_PREP_MIN_TRIS). 250k-tri scene prep drops from seconds of eager
    jnp dispatch to ~0.1 s."""
    tris = np.asarray(tris, np.float32)
    v0 = tris[:, 0, :]
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    n = np.cross(e1, e2)
    inv_nn = (np.float32(1.0) / np.sum(n * n, axis=-1, keepdims=True)).astype(
        np.float32
    )
    n1 = np.cross(e2, n) * inv_nn
    n2 = np.cross(n, e1) * inv_nn
    planes = TrianglePlanes(
        v0=v0, e1=e1, e2=e2, n=n,
        d0=np.sum(n * v0, axis=-1),
        n1=n1, d1=-np.sum(n1 * v0, axis=-1),
        n2=n2, d2=-np.sum(n2 * v0, axis=-1),
    )
    norm = np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    normals = n / norm
    nx = normals[:, 0]
    albedo = np.where(
        (nx > 0.99)[:, None],
        np.array([1.0, 0.0, 0.0], np.float32),
        np.where(
            (nx < -0.99)[:, None],
            np.array([0.0, 1.0, 0.0], np.float32),
            np.array([0.7, 0.7, 0.7], np.float32),
        ),
    ).astype(np.float32)
    lut = np.concatenate([np.zeros((1, 3, 3), np.float32), tris], axis=0)
    lut_normals = np.concatenate(
        [np.array([[0.0, 0.0, 1.0]], np.float32), normals], axis=0
    )
    return planes, normals.astype(np.float32), albedo, lut, lut_normals


def precompute_triangle_data(scene: Scene, albedo=None) -> TriangleData:
    """Build all per-triangle tables. Pure and jittable; for static scenes
    call once at load, for animated geometry call per frame on the
    transformed vertices. Concrete (non-traced) scenes take a vectorized
    numpy fast path (bit-identical; ~0.5 s at 250k triangles).

    ``albedo``: optional (T, 3) per-triangle albedo. Default reproduces the
    reference's hardcoded normal-keyed materials (raytrace.comp.glsl:
    155-163); overriding is the extension point for real material systems
    (both backends read TriangleData.albedo)."""
    concrete = not isinstance(scene.vertices, jax.core.Tracer) and not isinstance(
        scene.indices, jax.core.Tracer
    )
    if concrete and scene.num_triangles == 0:
        # empty scene: substitute one degenerate triangle (zero area -> its
        # plane normal is 0, so every intersection test self-rejects) and
        # render sky only; keeps every downstream gather/argmin non-empty
        scene = Scene.from_arrays(
            np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32)
        )
    if concrete and scene.num_triangles >= _NUMPY_PREP_MIN_TRIS:
        tris_np = np.asarray(scene.vertices)[np.asarray(scene.indices)]
        planes, normals, albedo_np, lut, lut_normals = _base_tables_np(tris_np)
        if albedo is None:
            albedo = albedo_np
        else:
            albedo = np.asarray(albedo, np.float32)
            if albedo.shape != tris_np.shape[:1] + (3,):
                raise ValueError(f"albedo must be (T, 3), got {albedo.shape}")
    else:
        tris = scene.triangles
        planes = build_triangle_planes(tris)
        normals = planes.n / jnp.linalg.norm(planes.n, axis=-1, keepdims=True)
        if albedo is None:
            albedo = shading.albedo_from_normal(normals)
        else:
            albedo = jnp.asarray(albedo, jnp.float32)
            if albedo.shape != tris.shape[:1] + (3,):
                raise ValueError(f"albedo must be (T, 3), got {albedo.shape}")
        lut = jnp.concatenate([jnp.zeros((1, 3, 3), tris.dtype), tris], axis=0)
        background_normal = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
        lut_normals = jnp.concatenate([background_normal, normals], axis=0)
    return TriangleData(
        planes=jax.tree_util.tree_map(jnp.asarray, planes),
        normals=jnp.asarray(normals),
        albedo=jnp.asarray(albedo),
        lut=jnp.asarray(lut),
        lut_normals=jnp.asarray(lut_normals),
    )
