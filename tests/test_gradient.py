"""Temporal gradient lambda: static scenes give 0, light motion gives > 0."""

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import gbuffer, gradient
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.frame import (
    camera_matrices,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)


def make_inputs(tri_data, cfg):
    cam = Camera.default()
    view, proj = camera_matrices(cam.position, cfg)
    g = gbuffer.visibility_pass(tri_data, cam.position, view, proj, cfg)
    return cam, g


def test_static_scene_gives_zero(cornell_tri_data, small_cfg):
    cam, g = make_inputs(cornell_tri_data, small_cfg)
    light = Light.default()
    lam = gradient.temporal_gradient_pass(
        g, cornell_tri_data.lut, cornell_tri_data.lut,
        cam.position, light.position, light.position, light.color, light.color,
    )
    np.testing.assert_allclose(np.asarray(lam), 0.0, atol=1e-5)


def test_background_is_zero(cornell_tri_data, small_cfg):
    cam, g = make_inputs(cornell_tri_data, small_cfg)
    light = Light.default()
    moved = light.position + jnp.array([1.0, 0.0, 0.0])
    lam = np.asarray(
        gradient.temporal_gradient_pass(
            g, cornell_tri_data.lut, cornell_tri_data.lut,
            cam.position, light.position, moved, light.color, light.color,
        )
    )
    vis = np.asarray(g.visibility)
    np.testing.assert_allclose(lam[vis == 0], 0.0)


def test_light_motion_raises_lambda(cornell_tri_data, small_cfg):
    cam, g = make_inputs(cornell_tri_data, small_cfg)
    light = Light.default()
    moved = light.position + jnp.array([2.0, 0.0, 0.0])
    lam = np.asarray(
        gradient.temporal_gradient_pass(
            g, cornell_tri_data.lut, cornell_tri_data.lut,
            cam.position, moved, light.position, light.color, light.color,
        )
    )
    vis = np.asarray(g.visibility)
    assert lam[vis > 0].mean() > 0.01
    assert lam.min() >= 0.0 and lam.max() <= 1.0


def test_color_change_raises_lambda(cornell_tri_data, small_cfg):
    cam, g = make_inputs(cornell_tri_data, small_cfg)
    light = Light.default()
    lam = np.asarray(
        gradient.temporal_gradient_pass(
            g, cornell_tri_data.lut, cornell_tri_data.lut,
            cam.position, light.position, light.position,
            jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]),
        )
    )
    vis = np.asarray(g.visibility)
    assert lam[vis > 0].mean() > 0.1
