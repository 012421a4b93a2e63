"""Shading + barycentric behavior vs the GLSL formulas."""

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import shading
from real_time_path_tracing_with_spatiotemporal_filtering.ops.barycentric import (
    barycentric_coordinates,
)


def test_sky_color_gradient():
    up = shading.sky_color(jnp.array([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(np.asarray(up), [0.25, 0.5, 1.0], atol=1e-6)
    horizon = shading.sky_color(jnp.array([1.0, 1e-6, 0.0]))
    np.testing.assert_allclose(np.asarray(horizon), [1.0, 1.0, 1.0], atol=1e-4)
    down = shading.sky_color(jnp.array([0.0, -1.0, 0.0]))
    np.testing.assert_allclose(np.asarray(down), [0.03, 0.03, 0.03], atol=1e-6)


def test_albedo_keying(cornell_tri_data):
    n = np.asarray(cornell_tri_data.normals)
    a = np.asarray(cornell_tri_data.albedo)
    for i in range(len(n)):
        if n[i, 0] > 0.99:
            np.testing.assert_allclose(a[i], [1, 0, 0])
        elif n[i, 0] < -0.99:
            np.testing.assert_allclose(a[i], [0, 1, 0])
        else:
            np.testing.assert_allclose(a[i], [0.7, 0.7, 0.7])
    # Cornell must contain at least one red and one green wall
    assert (a == [1, 0, 0]).all(axis=-1).any()
    assert (a == [0, 1, 0]).all(axis=-1).any()


def test_faceforward():
    n = jnp.array([[0.0, 0.0, 1.0]])
    toward = jnp.array([[0.0, 0.0, -1.0]])  # dot < 0: keep
    away = jnp.array([[0.0, 0.0, 1.0]])     # dot > 0: flip
    np.testing.assert_allclose(
        np.asarray(shading.faceforward(n, toward)), [[0, 0, 1]]
    )
    np.testing.assert_allclose(
        np.asarray(shading.faceforward(n, away)), [[0, 0, -1]]
    )


def test_phong_components():
    # head-on light: ambient 0.1 + diffuse 1 + specular 0.5, times 0.7 gray
    p = jnp.array([0.0, 0.0, 0.0])
    n = jnp.array([0.0, 0.0, 1.0])
    cam = jnp.array([0.0, 0.0, 2.0])
    light_pos = jnp.array([0.0, 0.0, 3.0])
    color = jnp.array([1.0, 1.0, 1.0])
    out = np.asarray(shading.phong(p, n, cam, light_pos, color))
    np.testing.assert_allclose(out, 0.7 * (0.1 + 1.0 + 0.5), rtol=1e-5)

    # light behind the surface: diffuse clamps to 0, reflect dir points away
    light_behind = jnp.array([0.0, 0.0, -3.0])
    out = np.asarray(shading.phong(p, n, cam, light_behind, color))
    np.testing.assert_allclose(out, 0.7 * 0.1, atol=1e-5)


def test_barycentric_recovers_point(rng_np):
    v0 = jnp.array([0.0, 0.0, 0.0])
    v1 = jnp.array([2.0, 0.0, 0.0])
    v2 = jnp.array([0.0, 2.0, 0.0])
    for _ in range(10):
        w = rng_np.dirichlet([1, 1, 1]).astype(np.float32)
        p = w[0] * np.asarray(v0) + w[1] * np.asarray(v1) + w[2] * np.asarray(v2)
        bary = np.asarray(barycentric_coordinates(jnp.asarray(p), v0, v1, v2))
        np.testing.assert_allclose(bary, w, atol=1e-5)
        recon = bary[0] * np.asarray(v0) + bary[1] * np.asarray(v1) + bary[2] * np.asarray(v2)
        np.testing.assert_allclose(recon, p, atol=1e-5)


def test_barycentric_degenerate_guard():
    z = jnp.zeros(3)
    bary = barycentric_coordinates(jnp.array([1.0, 1.0, 1.0]), z, z, z)
    assert np.isfinite(np.asarray(bary)).all()
