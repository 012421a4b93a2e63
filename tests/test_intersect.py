"""Ray/triangle and ray/sphere intersection vs NumPy oracles, and the
triangle-block scan of the dense intersector."""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.ops import intersect


def moller_trumbore_oracle(o, d, tri):
    """Classic Moller-Trumbore in float64 as the ground-truth oracle."""
    v0, v1, v2 = (np.asarray(v, np.float64) for v in tri)
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    if abs(det) < 1e-12:
        return None
    inv = 1.0 / det
    tvec = np.asarray(o, np.float64) - v0
    u = np.dot(tvec, p) * inv
    if u < 0 or u > 1:
        return None
    q = np.cross(tvec, e1)
    v = np.dot(np.asarray(d, np.float64), q) * inv
    if v < 0 or u + v > 1:
        return None
    t = np.dot(e2, q) * inv
    if t <= 0:
        return None
    return t, u, v


def test_single_triangle_hits_and_misses(rng_np):
    tri = np.array([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    planes = intersect.build_triangle_planes(jnp.asarray(tri))

    # straight-on hit
    rec = intersect.nearest_hit(
        planes,
        jnp.array([[0.2, 0.2, 1.0]]),
        jnp.array([[0.0, 0.0, -1.0]]),
    )
    assert bool(rec.hit[0])
    np.testing.assert_allclose(float(rec.t[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(rec.bary_u[0]), 0.2, atol=1e-6)
    np.testing.assert_allclose(float(rec.bary_v[0]), 0.2, atol=1e-6)

    # miss outside the triangle
    rec = intersect.nearest_hit(
        planes,
        jnp.array([[0.9, 0.9, 1.0]]),
        jnp.array([[0.0, 0.0, -1.0]]),
    )
    assert not bool(rec.hit[0])

    # behind the origin -> no hit (t > 0 required)
    rec = intersect.nearest_hit(
        planes,
        jnp.array([[0.2, 0.2, -1.0]]),
        jnp.array([[0.0, 0.0, -1.0]]),
    )
    assert not bool(rec.hit[0])

    # parallel ray -> no hit
    rec = intersect.nearest_hit(
        planes,
        jnp.array([[0.2, 0.2, 1.0]]),
        jnp.array([[1.0, 0.0, 0.0]]),
    )
    assert not bool(rec.hit[0])


def test_random_rays_match_oracle(rng_np, cornell_scene):
    tris = np.asarray(cornell_scene.triangles)
    planes = intersect.build_triangle_planes(jnp.asarray(tris))
    n = 200
    origins = rng_np.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    origins[:, 1] = rng_np.uniform(0.1, 1.8, n).astype(np.float32)
    dirs = rng_np.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    rec = intersect.nearest_hit(planes, jnp.asarray(origins), jnp.asarray(dirs))
    for i in range(n):
        best = None
        for ti in range(len(tris)):
            res = moller_trumbore_oracle(origins[i], dirs[i], tris[ti])
            if res is not None and (best is None or res[0] < best[0]):
                best = (res[0], ti)
        if best is None:
            assert not bool(rec.hit[i])
        else:
            assert bool(rec.hit[i])
            # skip prim comparison on near-ties (coplanar shared edges)
            np.testing.assert_allclose(float(rec.t[i]), best[0], rtol=2e-4)


def test_hit_position_on_surface(cornell_tri_data):
    planes = cornell_tri_data.planes
    o = jnp.array([[0.0, 1.0, 3.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    rec = intersect.nearest_hit(planes, o, d)
    assert bool(rec.hit[0])
    pos = intersect.hit_position(planes, rec)
    expected = np.asarray(o[0]) + float(rec.t[0]) * np.asarray(d[0])
    np.testing.assert_allclose(np.asarray(pos[0]), expected, atol=1e-4)


def test_ray_sphere_matches_reference_semantics():
    center = jnp.array([0.0, 0.0, 0.0])
    r = 0.5

    # outside, pointing at it: nearest root
    hit, t = intersect.ray_sphere(
        jnp.array([[0.0, 0.0, 2.0]]), jnp.array([[0.0, 0.0, -1.0]]), center, r
    )
    assert bool(hit[0]) and abs(float(t[0]) - 1.5) < 1e-6

    # inside: positive exit root
    hit, t = intersect.ray_sphere(
        jnp.array([[0.0, 0.0, 0.0]]), jnp.array([[0.0, 0.0, -1.0]]), center, r
    )
    assert bool(hit[0]) and abs(float(t[0]) - 0.5) < 1e-6

    # behind: both roots negative -> miss
    hit, _ = intersect.ray_sphere(
        jnp.array([[0.0, 0.0, 2.0]]), jnp.array([[0.0, 0.0, 1.0]]), center, r
    )
    assert not bool(hit[0])

    # tangent-ish miss
    hit, _ = intersect.ray_sphere(
        jnp.array([[2.0, 0.0, 2.0]]), jnp.array([[0.0, 0.0, -1.0]]), center, r
    )
    assert not bool(hit[0])

    # unnormalized direction: t scales like the reference (a = dot(d, d))
    hit, t = intersect.ray_sphere(
        jnp.array([[0.0, 0.0, 2.0]]), jnp.array([[0.0, 0.0, -2.0]]), center, r
    )
    assert bool(hit[0]) and abs(float(t[0]) - 0.75) < 1e-6


@functools.lru_cache(maxsize=None)
def _scene_planes(splits):
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Scene,
        precompute_triangle_data,
    )

    scene = (
        Scene.cornell_box() if splits == 0
        else Scene.from_arrays(*procedural.subdivided_cornell(splits))
    )
    return precompute_triangle_data(scene).planes


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


_nearest = jax.jit(intersect.nearest_hit, static_argnames=("block",))


@pytest.mark.parametrize("splits", [0, 4])
@pytest.mark.parametrize("block", ["1", "7", "T", "T+5"])
def test_tiled_nearest_hit_matches_untiled(splits, block):
    """Scanning triangle blocks gives exactly the single-block record."""
    planes = _scene_planes(splits)
    t = planes.n.shape[0]
    b = {"1": 1, "7": 7, "T": t, "T+5": t + 5}[block]
    o, d = _rays(400, splits)
    ref = _nearest(planes, o, d, block=t)
    got = _nearest(planes, o, d, block=b)
    assert int(np.asarray(ref.hit).sum()) > 50
    for name, x, y in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), name)


@pytest.mark.parametrize("block", [1, 2, 3])
def test_tiled_nearest_hit_keeps_first_index_on_ties(block):
    """Duplicated triangles tie exactly; like argmin, the lowest index wins,
    also when the twins fall into different blocks."""
    tri = np.array(
        [[[-1.0, -1.0, -2.0], [1.0, -1.0, -2.0], [0.0, 1.0, -2.0]]],
        np.float32,
    )
    far = tri + np.array([0.0, 0.0, -3.0], np.float32)
    tris = np.concatenate([far, tri, tri, far], axis=0)  # twins at 1, 2
    planes = intersect.build_triangle_planes(jnp.asarray(tris))
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.asarray(np.tile([[0.0, 0.0, -1.0]], (4, 1)), jnp.float32)
    rec = _nearest(planes, o, d, block=block)
    np.testing.assert_array_equal(np.asarray(rec.prim), [1, 1, 1, 1])
    np.testing.assert_allclose(np.asarray(rec.t), 2.0)


def test_triangle_block_budget():
    budget = intersect.PLANE_BYTES_BUDGET
    # the headline frame: one block holds the 32-triangle Cornell box
    assert intersect.triangle_block(1920 * 1080, 32) == 32
    # a 32,768-triangle scene at 1080p is scanned in budget-sized blocks
    b = intersect.triangle_block(1920 * 1080, 32768)
    assert 1 <= b < 32768 and 1920 * 1080 * b * 4 <= budget
    # never below one triangle, never above the scene
    assert intersect.triangle_block(10**9, 5) == 1
    assert intersect.triangle_block(10, 5) == 5
