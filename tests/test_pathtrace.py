"""Path tracer behavior: reference quirks, convergence, reproducibility."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Light,
    Camera,
)


def test_light_pixel_dimmed_on_first_hit(cornell_tri_data, small_cfg):
    """A ray aimed straight at the light returns light_color*30/5
    (raytrace.comp.glsl:229): accum is 1 on the first segment."""
    light = Light.default()
    hdr = light.color * small_cfg.light_intensity
    o = jnp.asarray(light.position)[None, :] + jnp.array([[0.0, 0.0, 3.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    state = jnp.zeros((1,), jnp.uint32)
    out = pathtrace.trace_paths(
        cornell_tri_data, light.position, hdr, o, d, state, small_cfg
    )
    np.testing.assert_allclose(
        np.asarray(out[0]), np.asarray(hdr) / 5.0, rtol=1e-5
    )


def test_light_visible_through_walls_quirk(cornell_tri_data, small_cfg):
    """Reference quirk (raytrace.comp.glsl:226-235): the light terminates the
    path even when a wall is closer. With the quirk disabled the same ray
    shades the wall instead."""
    light = Light.default()
    hdr = light.color * small_cfg.light_intensity
    # from outside the box, behind the back wall, aiming through it at the light
    o = jnp.asarray(light.position)[None, :] + jnp.array([[0.0, 0.0, -3.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    state = jnp.zeros((1,), jnp.uint32)

    out = pathtrace.trace_paths(
        cornell_tri_data, light.position, hdr, o, d, state, small_cfg
    )
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(hdr) / 5.0, rtol=1e-5)

    no_quirk = dataclasses.replace(small_cfg, light_through_walls=False)
    out2 = pathtrace.trace_paths(
        cornell_tri_data, light.position, hdr, o, d, state, no_quirk
    )
    assert not np.allclose(np.asarray(out2[0]), np.asarray(hdr) / 5.0)


def test_sky_ray(cornell_tri_data, small_cfg):
    light = Light.default()
    hdr = light.color * small_cfg.light_intensity
    o = jnp.array([[0.0, 5.0, 6.0]])
    d = jnp.array([[0.0, 1.0, 0.0]])  # straight up, misses everything
    state = jnp.zeros((1,), jnp.uint32)
    out = pathtrace.trace_paths(
        cornell_tri_data, light.position, hdr, o, d, state, small_cfg
    )
    np.testing.assert_allclose(np.asarray(out[0]), [0.25, 0.5, 1.0], rtol=1e-5)


def test_pass_is_deterministic(cornell_tri_data, small_cfg):
    light = Light.default()
    cam = Camera.default()
    a = pathtrace.path_trace_pass(
        cornell_tri_data, cam.position, light, jnp.int32(3), small_cfg
    )
    b = pathtrace.path_trace_pass(
        cornell_tri_data, cam.position, light, jnp.int32(3), small_cfg
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = pathtrace.path_trace_pass(
        cornell_tri_data, cam.position, light, jnp.int32(4), small_cfg
    )
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_radiance_is_finite_and_plausible(cornell_tri_data, small_cfg):
    light = Light.default()
    cam = Camera.default()
    img = np.asarray(
        pathtrace.path_trace_pass(
            cornell_tri_data, cam.position, light, jnp.int32(0), small_cfg
        )
    )
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    assert img.mean() > 0.01  # the scene is lit


def test_spp_reduces_variance(cornell_tri_data, small_cfg):
    """Monte Carlo sanity: multi-sample frames are closer to a high-spp
    reference than single-sample frames."""
    light = Light.default()
    cam = Camera.default()
    cfg1 = dataclasses.replace(small_cfg, width=32, height=24, spp=1)
    cfg8 = dataclasses.replace(small_cfg, width=32, height=24, spp=8)
    cfg64 = dataclasses.replace(small_cfg, width=32, height=24, spp=64)

    ref = np.asarray(
        pathtrace.path_trace_pass(cornell_tri_data, cam.position, light, jnp.int32(0), cfg64)
    )
    e1 = e8 = 0.0
    for f in range(1, 4):  # frames give independent seeds
        i1 = np.asarray(
            pathtrace.path_trace_pass(cornell_tri_data, cam.position, light, jnp.int32(f), cfg1)
        )
        i8 = np.asarray(
            pathtrace.path_trace_pass(cornell_tri_data, cam.position, light, jnp.int32(f), cfg8)
        )
        e1 += np.mean((i1 - ref) ** 2)
        e8 += np.mean((i8 - ref) ** 2)
    assert e8 < e1
