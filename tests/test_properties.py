"""Property-based tests (hypothesis) for the math core."""

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    intersect,
    rng as rng_ops,
    shading,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops.barycentric import (
    barycentric_coordinates,
)

finite = st.floats(-5.0, 5.0, allow_nan=False, width=32)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_pcg_output_in_unit_interval(seed):
    state = jnp.asarray([seed], jnp.uint32)
    for _ in range(4):
        state, val = rng_ops.pcg_step(state)
        assert 0.0 <= float(val[0]) <= 1.0


@settings(max_examples=25, deadline=None)
@given(st.lists(finite, min_size=9, max_size=9), st.floats(0.05, 0.45), st.floats(0.05, 0.45))
def test_point_inside_triangle_is_hit(coords, a, b):
    tri = np.asarray(coords, np.float32).reshape(3, 3)
    e1, e2 = tri[1] - tri[0], tri[2] - tri[0]
    area2 = np.linalg.norm(np.cross(e1, e2))
    if area2 < 1e-3:
        return  # skip degenerate triangles
    # point strictly inside, ray from off-plane straight at it
    p = tri[0] + a * e1 + b * e2
    n = np.cross(e1, e2) / area2
    origin = p + 2.0 * n
    planes = intersect.build_triangle_planes(jnp.asarray(tri[None]))
    rec = intersect.nearest_hit(
        planes, jnp.asarray(origin[None]), jnp.asarray(-n[None])
    )
    assert bool(rec.hit[0])
    assert abs(float(rec.t[0]) - 2.0) < 1e-2


@settings(max_examples=25, deadline=None)
@given(st.lists(finite, min_size=9, max_size=9), st.floats(0.0, 1.0), st.floats(0.0, 1.0))
def test_barycentric_partition_of_unity(coords, a, b):
    tri = np.asarray(coords, np.float32).reshape(3, 3)
    if np.linalg.norm(np.cross(tri[1] - tri[0], tri[2] - tri[0])) < 1e-3:
        return
    if a + b > 1.0:
        a, b = 1.0 - a, 1.0 - b
    p = tri[0] + a * (tri[1] - tri[0]) + b * (tri[2] - tri[0])
    bary = np.asarray(
        barycentric_coordinates(
            jnp.asarray(p), jnp.asarray(tri[0]), jnp.asarray(tri[1]), jnp.asarray(tri[2])
        )
    )
    assert abs(bary.sum() - 1.0) < 1e-3
    assert (bary >= -1e-4).all()


@settings(max_examples=20, deadline=None)
@given(st.lists(finite, min_size=3, max_size=3))
def test_sky_color_bounded(direction):
    d = np.asarray(direction, np.float32)
    if np.linalg.norm(d) < 1e-3:
        return
    d = d / np.linalg.norm(d)
    c = np.asarray(shading.sky_color(jnp.asarray(d)))
    assert (c >= 0.0).all() and (c <= 1.0 + 1e-6).all()


@settings(max_examples=20, deadline=None)
@given(st.lists(finite, min_size=3, max_size=3), st.lists(finite, min_size=3, max_size=3))
def test_faceforward_opposes_incident(n, incident):
    n = np.asarray(n, np.float32)
    i = np.asarray(incident, np.float32)
    if np.linalg.norm(n) < 1e-3 or np.linalg.norm(i) < 1e-3:
        return
    out = np.asarray(shading.faceforward(jnp.asarray(n), jnp.asarray(i)))
    # GLSL semantics: dot(I, N) < 0 keeps N, else flips; result never has
    # positive alignment with the incident direction beyond fp noise
    assert float(np.dot(out, i)) <= 1e-4


def test_models_presets_construct():
    from real_time_path_tracing_with_spatiotemporal_filtering import models

    r = models.cornell_box_reference(width=32, height=24, max_bounces=3,
                                     wavelet_iterations=3)
    assert r.cfg.width == 32
    r2 = models.cornell_stress(splits=2, width=64, height=48)
    assert r2.scene.num_triangles == 128
