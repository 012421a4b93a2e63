"""Visibility pass: G-buffer contents on the Cornell box."""

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import gbuffer
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.frame import (
    camera_matrices,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
)


def make_gbuf(tri_data, cfg):
    cam = Camera.default()
    view, proj = camera_matrices(cam.position, cfg)
    return gbuffer.visibility_pass(tri_data, cam.position, view, proj, cfg)


def test_gbuffer_shapes_and_ranges(cornell_tri_data, small_cfg):
    g = make_gbuf(cornell_tri_data, small_cfg)
    h, w = small_cfg.height, small_cfg.width
    assert g.visibility.shape == (h, w)
    assert g.world_pos.shape == (h, w, 3)
    assert g.depth.shape == (h, w)
    vis = np.asarray(g.visibility)
    # IDs are integers in [0, T] stored as float (primID+1 convention)
    assert vis.min() >= 0 and vis.max() <= cornell_tri_data.lut.shape[0] - 1
    np.testing.assert_array_equal(vis, np.round(vis))


def test_center_pixel_hits_back_wall(cornell_tri_data, small_cfg):
    g = make_gbuf(cornell_tri_data, small_cfg)
    cy, cx = small_cfg.height // 2, small_cfg.width // 2
    vis = float(g.visibility[cy, cx])
    assert vis > 0  # camera looks into the box
    # the hit point lies on the triangle it claims to hit
    prim = int(vis) - 1
    tri = np.asarray(cornell_tri_data.lut[int(vis)])
    p = np.asarray(g.world_pos[cy, cx])
    n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    n /= np.linalg.norm(n)
    assert abs(np.dot(p - tri[0], n)) < 1e-4


def test_background_conventions(cornell_tri_data, small_cfg):
    g = make_gbuf(cornell_tri_data, small_cfg)
    vis = np.asarray(g.visibility)
    bg = vis == 0
    # Cornell from the default camera has sky around the box opening
    assert bg.any() and (~bg).any()
    np.testing.assert_allclose(np.asarray(g.depth)[bg], 1.0)
    np.testing.assert_allclose(np.asarray(g.world_pos)[bg], 0.0)


def test_depth_increases_into_the_scene(cornell_tri_data, small_cfg):
    g = make_gbuf(cornell_tri_data, small_cfg)
    vis = np.asarray(g.visibility)
    depth = np.asarray(g.depth)
    pos = np.asarray(g.world_pos)
    hit = vis > 0
    # depth should be strictly ordered with camera-space distance
    cam_z = 6.0 - pos[..., 2]  # camera at z=6 looking -z
    d_near = depth[hit & (cam_z < 5.5)]
    d_far = depth[hit & (cam_z > 6.5)]
    if d_near.size and d_far.size:
        assert d_near.mean() < d_far.mean()


def test_lut_layout(cornell_tri_data, cornell_scene):
    lut = np.asarray(cornell_tri_data.lut)
    assert lut.shape == (cornell_scene.num_triangles + 1, 3, 3)
    np.testing.assert_allclose(lut[0], 0.0)  # background slot
    np.testing.assert_allclose(
        lut[1:], np.asarray(cornell_scene.triangles)
    )  # slot primID+1 (visibility.geom.glsl:33-35)
    # background sentinel normal (temporalFiltering.comp.glsl:83)
    np.testing.assert_allclose(
        np.asarray(cornell_tri_data.lut_normals[0]), [0.0, 0.0, 1.0]
    )
