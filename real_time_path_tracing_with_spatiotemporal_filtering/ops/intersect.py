"""Ray/scene intersection as dense linear algebra.

The reference leans on VK_KHR_ray_query hardware traversal
(raytrace.comp.glsl:208-222), which JAX cannot reach. The plain reference
here re-derives the nearest-hit query as dense linear algebra: we
precompute per-triangle plane equations (Havel-Herout style) and reduce the
per-(ray, triangle) work to six (N, 3) @ (3, T) matmuls plus an elementwise
epilogue and an argmin over T, scanned over triangle blocks when the scene
is large. It is exact at any scene size; the per-pixel trace kernel
(ops/pallas/pathtrace.py) fuses the same test into its triangle loop.

Plane precomputation (per triangle with edges e1, e2 and normal n = e1 x e2):
    t  = (dot(n, v0) - dot(n, o)) / dot(n, d)
    u  = dot(n1, o) + t * dot(n1, d) + d1      n1 = (e2 x n) / |n|^2
    v  = dot(n2, o) + t * dot(n2, d) + d2      n2 = (n x e1) / |n|^2
hit iff u >= 0, v >= 0, u + v <= 1 and t in (0, t_max] -- the same
barycentric-inside test the hardware ray query commits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class TrianglePlanes(NamedTuple):
    """Precomputed per-triangle intersection constants (all (T, ...))."""

    v0: jnp.ndarray       # (T, 3)
    e1: jnp.ndarray       # (T, 3) v1 - v0
    e2: jnp.ndarray       # (T, 3) v2 - v0
    n: jnp.ndarray        # (T, 3) unnormalized geometric normal e1 x e2
    d0: jnp.ndarray       # (T,)   dot(n, v0)
    n1: jnp.ndarray       # (T, 3) barycentric-u plane normal
    d1: jnp.ndarray       # (T,)   barycentric-u plane offset
    n2: jnp.ndarray       # (T, 3) barycentric-v plane normal
    d2: jnp.ndarray       # (T,)   barycentric-v plane offset


def build_triangle_planes(triangles: jnp.ndarray) -> TrianglePlanes:
    """Precompute plane constants from (T, 3, 3) triangle vertices."""
    v0 = triangles[:, 0, :]
    e1 = triangles[:, 1, :] - v0
    e2 = triangles[:, 2, :] - v0
    n = jnp.cross(e1, e2)
    inv_nn = 1.0 / jnp.sum(n * n, axis=-1, keepdims=True)
    n1 = jnp.cross(e2, n) * inv_nn
    n2 = jnp.cross(n, e1) * inv_nn
    return TrianglePlanes(
        v0=v0,
        e1=e1,
        e2=e2,
        n=n,
        d0=jnp.sum(n * v0, axis=-1),
        n1=n1,
        d1=-jnp.sum(n1 * v0, axis=-1),
        n2=n2,
        d2=-jnp.sum(n2 * v0, axis=-1),
    )


class HitRecord(NamedTuple):
    """Nearest-hit query result for a batch of rays (leading dims shared)."""

    t: jnp.ndarray        # (...,)  hit distance (t_max where no hit)
    prim: jnp.ndarray     # (...,)  int32 triangle index (0 where no hit)
    hit: jnp.ndarray      # (...,)  bool
    bary_u: jnp.ndarray   # (...,)  barycentric u of the committed hit
    bary_v: jnp.ndarray   # (...,)  barycentric v of the committed hit


# Byte budget of one (rays x triangle-block) f32 interaction plane. The
# dense test materializes several such planes per call; scenes whose
# (rays x T) plane exceeds the budget are scanned over triangle blocks so
# the plain reference runs at any scene size (a 1080p frame against 32k
# triangles would otherwise need ~272 GB per plane).
PLANE_BYTES_BUDGET = 1 << 28


def triangle_block(num_rays: int, num_tris: int) -> int:
    """Triangles per block of :func:`nearest_hit` for ``num_rays`` rays:
    the most that keep one (rays x block) f32 plane within
    PLANE_BYTES_BUDGET, at least 1 and at most ``num_tris``."""
    per_plane = max(1, PLANE_BYTES_BUDGET // (4 * max(num_rays, 1)))
    return max(1, min(num_tris, per_plane))


def _block_hits(planes: TrianglePlanes, o, d, t_max, eps):
    """Dense nearest-hit of (N, 3) rays against one block of triangles.

    Returns (t_cand, prim, hit, u, v) at the block's argmin, where t_cand
    is the winning candidate distance (2 * t_max when nothing is valid)
    and prim the block-local index (argmin's first-index tie rule).
    """
    # HIGHEST precision: a float32 matmul may otherwise run at reduced
    # precision (TF32 on the GPU, bf16 passes on other accelerators),
    # whose short mantissas visibly bend rays (hits land ~0.5% off the
    # true line); geometry needs full f32.
    mm = functools.partial(
        jnp.matmul, precision=jax.lax.Precision.HIGHEST
    )
    no = mm(o, planes.n.T)          # (N, T)
    nd = mm(d, planes.n.T)
    n1o = mm(o, planes.n1.T)
    n1d = mm(d, planes.n1.T)
    n2o = mm(o, planes.n2.T)
    n2d = mm(d, planes.n2.T)

    safe_nd = jnp.where(jnp.abs(nd) < eps, eps, nd)
    t = (planes.d0[None, :] - no) / safe_nd
    u = n1o + t * n1d + planes.d1[None, :]
    v = n2o + t * n2d + planes.d2[None, :]

    valid = (
        (jnp.abs(nd) >= eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t <= t_max)
    )
    t_cand = jnp.where(valid, t, jnp.float32(t_max) * 2.0)
    prim = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)

    def pick(x):
        return jnp.take_along_axis(x, prim[:, None], axis=-1)[:, 0]

    return pick(t_cand), prim, pick(valid), pick(u), pick(v)


def nearest_hit(
    planes: TrianglePlanes,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_max: float = 10000.0,
    eps: float = 1e-9,
    block: int | None = None,
) -> HitRecord:
    """Closest triangle along each ray (the rayQueryProceed loop's result).

    ``origins``/``directions``: (..., 3). All (ray x triangle) interaction
    terms are matmuls; the (N, T) epilogue is fused elementwise work.

    ``block``: triangles per dense block (default :func:`triangle_block`).
    When the scene has more triangles than one block, a ``lax.scan`` over
    triangle blocks keeps the running best (t, prim, u, v); a later block
    replaces it only on a strictly smaller distance, so the result is
    identical to the single-block test, first-index tie rule included.
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    num_tris = planes.n.shape[0]

    if num_tris == 0:
        # empty scene: every ray misses (sky only); argmin over zero
        # triangles is undefined, so short-circuit
        zero_f = jnp.zeros(batch_shape, jnp.float32)
        return HitRecord(
            t=jnp.full(batch_shape, jnp.float32(t_max)),
            prim=jnp.zeros(batch_shape, jnp.int32),
            hit=jnp.zeros(batch_shape, bool),
            bary_u=zero_f,
            bary_v=zero_f,
        )

    if block is None:
        block = triangle_block(o.shape[0], num_tris)
    block = max(1, min(block, num_tris))
    if block == num_tris:
        t_hit, prim, hit, bu, bv = _block_hits(planes, o, d, t_max, eps)
    else:
        num_blocks = -(-num_tris // block)
        pad = num_blocks * block - num_tris

        def blocked(x):
            # padding triangles have zero normals: |dot(n, d)| < eps
            # rejects them, so they can never win
            x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
            return x.reshape((num_blocks, block) + x.shape[1:])

        stacked = jax.tree_util.tree_map(blocked, planes)

        def scan_block(best, xs):
            blk_planes, base = xs
            cand = _block_hits(blk_planes, o, d, t_max, eps)
            cand = (cand[0], cand[1] + base) + cand[2:]
            better = cand[0] < best[0]
            return tuple(
                jnp.where(better, c, b) for c, b in zip(cand, best)
            ), None

        first = jax.tree_util.tree_map(lambda x: x[0], stacked)
        rest = jax.tree_util.tree_map(lambda x: x[1:], stacked)
        bases = jnp.arange(1, num_blocks, dtype=jnp.int32) * block
        (t_hit, prim, hit, bu, bv), _ = jax.lax.scan(
            scan_block, _block_hits(first, o, d, t_max, eps), (rest, bases)
        )

    return HitRecord(
        t=jnp.where(hit, t_hit, jnp.float32(t_max)).reshape(batch_shape),
        prim=jnp.where(hit, prim, 0).reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        bary_u=jnp.where(hit, bu, 0.0).reshape(batch_shape),
        bary_v=jnp.where(hit, bv, 0.0).reshape(batch_shape),
    )


def hit_position(planes: TrianglePlanes, rec: HitRecord) -> jnp.ndarray:
    """World position of committed hits, via barycentrics like the reference
    (raytrace.comp.glsl:133-139): p = v0*(1-u-v) + v1*u + v2*v."""
    v0 = planes.v0[rec.prim]
    e1 = planes.e1[rec.prim]
    e2 = planes.e2[rec.prim]
    return v0 + rec.bary_u[..., None] * e1 + rec.bary_v[..., None] * e2


def ray_sphere(origins, directions, center, radius):
    """checkRayLightIntersection (raytrace.comp.glsl:168-198).

    Returns (hit: bool, t: nearest positive root). Matches the reference:
    a = dot(d, d) (not assumed 1), smallest positive of the two roots, no
    far-plane clamp -- and, per the reference quirk, callers apply it
    regardless of triangle occlusion.
    """
    oc = origins - center
    a = jnp.sum(directions * directions, axis=-1)
    b = 2.0 * jnp.sum(oc * directions, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sqrt_d) / (2.0 * a)
    t2 = (-b + sqrt_d) / (2.0 * a)
    t = jnp.where(t1 > 0.0, t1, t2)
    hit = (disc >= 0.0) & (t > 0.0)
    return hit, jnp.where(hit, t, 0.0)
