"""Per-frame model-matrix hook: animated geometry with correct temporal
reprojection.

The reference plumbs ``model``/``modelPrev`` through its UBO and applies
them in the visibility vertex shader (/root/reference/shaders/
visibility.vert.glsl:22-24, /root/reference/main.cpp:1465-1469) -- always
identity in practice. Here the hook is scene.transform_triangle_data +
the ``model`` argument of the frame function; these tests prove the part
the reference never exercised: reprojection and temporal accumulation
stay correct while the geometry actually moves.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    atrous,
    gbuffer,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    transform_triangle_data,
)

CFG = ptsf.RenderConfig(width=64, height=48, max_bounces=4)


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _center_rot_y(angle: float, center) -> np.ndarray:
    """Rotate about a vertical axis through ``center``."""
    m = _rot_y(angle)
    c = np.asarray(center, np.float32)
    m[:3, 3] = c - m[:3, :3] @ c
    return m


def test_identity_model_bit_identical():
    """model=identity must reproduce the rest-pose tables bit-for-bit
    (same build path: jax-traced plane construction)."""
    td = ptsf.precompute_triangle_data(ptsf.Scene.cornell_box())
    td_t = transform_triangle_data(td, jnp.eye(4))
    np.testing.assert_array_equal(np.asarray(td_t.lut), np.asarray(td.lut))
    np.testing.assert_array_equal(
        np.asarray(td_t.normals), np.asarray(td.normals)
    )
    np.testing.assert_array_equal(
        np.asarray(td_t.albedo), np.asarray(td.albedo)
    )
    hist = frame_mod.init_history(td, CFG)
    rgb_plain, _ = frame_mod.render_frame_impl(
        td, Camera.default(), Light.default(), hist, CFG
    )
    hist2 = frame_mod.init_history(td, CFG)
    rgb_model, _ = frame_mod.render_frame_impl(
        td, Camera.default(), Light.default(), hist2, CFG,
        model=jnp.eye(4),
    )
    np.testing.assert_array_equal(np.asarray(rgb_plain), np.asarray(rgb_model))


def test_albedo_rekeyed_from_rotated_normals():
    """The reference derives albedo from the hit normal at trace time
    (raytrace.comp.glsl:155-163): rotating the box 90 degrees about y must
    turn former +x (red) walls into -z-facing gray ones."""
    td = ptsf.precompute_triangle_data(ptsf.Scene.cornell_box())
    td_t = transform_triangle_data(td, _rot_y(np.pi / 2))
    red = np.asarray(td.albedo)[:, 0] > 0.99
    assert red.any()
    rot_albedo = np.asarray(td_t.albedo)[red]
    assert not (rot_albedo[:, 0] > 0.99).any()


def test_backprojection_tracks_rigid_motion():
    """Barycentric backprojection through (current lut, previous lut) must
    track a rigid geometry step: for each current surface pixel it should
    land on (or next to) the analytic previous pixel of the same material
    point, projection of M_prev @ M_cur^-1 @ hit. The reference's
    backprojection is deliberately approximate under motion -- it takes
    barycentrics of the CURRENT position against the PREVIOUS vertices
    (temporalFiltering.comp.glsl:221-229, a preserved quirk) -- so the
    bound is a couple of pixels at this step size, not exact; the filter
    only needs the history fetch to stay on the same surface, asserted via
    the previous frame's visibility ids."""
    td = ptsf.precompute_triangle_data(ptsf.Scene.cornell_box())
    center = [0.0, 1.0, 0.0]
    m_prev = _center_rot_y(0.00, center)
    m_cur = _center_rot_y(0.08, center)
    td_prev = transform_triangle_data(td, m_prev)
    td_cur = transform_triangle_data(td, m_cur)
    cam = Camera.default()
    view, proj = frame_mod.camera_matrices(cam, CFG)
    gbuf_prev = gbuffer.visibility_pass(td_prev, cam.position, view, proj, CFG)
    gbuf = gbuffer.visibility_pass(td_cur, cam.position, view, proj, CFG)
    py, px = atrous.backproject_pixels(gbuf, td_prev.lut, view, proj, CFG)

    # analytic expectation per hit pixel
    hit = np.asarray(gbuf.visibility) > 0
    world = np.asarray(gbuf.world_pos)
    rel = np.linalg.inv(np.asarray(m_cur, np.float64))
    rel = np.asarray(m_prev, np.float64) @ rel
    prev_world = world @ rel[:3, :3].T + rel[:3, 3]
    clip = (
        np.concatenate(
            [prev_world, np.ones_like(prev_world[..., :1])], axis=-1
        )
        @ (np.asarray(proj, np.float64) @ np.asarray(view, np.float64)).T
    )
    ndc = clip[..., :2] / clip[..., 3:4]
    ex = (ndc[..., 0] * 0.5 + 0.5) * CFG.width
    ey = (ndc[..., 1] * 0.5 + 0.5) * CFG.height
    in_img = hit & (ex >= 2) & (ex < CFG.width - 2) & (ey >= 2) & (
        ey < CFG.height - 2
    )
    assert in_img.sum() > 200  # the box fills most of the view
    dx = np.abs(np.asarray(px, np.float64)[in_img] - (ex[in_img] - 0.5))
    dy = np.abs(np.asarray(py, np.float64)[in_img] - (ey[in_img] - 0.5))
    err = np.maximum(dx, dy)
    # prev-verts-barycentrics quirk: a couple of px of drift at a 0.08 rad
    # step, typically sub-pixel
    assert float(np.median(err)) <= 1.0
    assert float(err.max()) <= 5.0
    # same-surface consistency: the fetched history pixel saw the same
    # triangle last frame for nearly all non-silhouette pixels
    vis_prev = np.asarray(gbuf_prev.visibility)
    fetched = vis_prev[np.asarray(py), np.asarray(px)]
    same = fetched[in_img] == np.asarray(gbuf.visibility)[in_img]
    assert same.mean() > 0.9, same.mean()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rotating_box_temporal_accumulation(backend):
    """Temporal accumulation must survive geometry motion: a box rotating
    0.08 rad/frame for 10 frames, accumulated with the model hook, stays
    at the spatial-only quality floor (no ghosting cost) and far below the
    same accumulation with a frozen history LUT -- which is what dropping
    modelPrev would mean (measured on this config: tracked 0.178 vs
    frozen 0.277 vs spatial-only 0.175 rMSE)."""
    cfg = dataclasses.replace(CFG, backend=backend, pallas_interpret=True)
    scene = ptsf.Scene.cornell_box()
    td = ptsf.precompute_triangle_data(scene)
    center = [0.0, 1.0, 0.0]
    step = 0.08
    n_frames = 10

    hist = frame_mod.init_history(td, cfg)
    out = None
    for i in range(n_frames):
        out, hist = frame_mod.render_frame_impl(
            td, Camera.default(), Light.default(), hist, cfg,
            model=jnp.asarray(_center_rot_y(step * (i + 1), center)),
        )
    assert np.isfinite(np.asarray(out)).all()

    # truth: converged (multi-seed) render at the final pose
    td_final = transform_triangle_data(
        td, _center_rot_y(step * n_frames, center)
    )

    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        pathtrace,
    )

    acc = np.zeros((cfg.height, cfg.width, 3), np.float64)
    for f in range(64):
        acc += np.asarray(
            pathtrace.path_trace_pass(
                td_final, Camera.default().position, Light.default(),
                jnp.int32(f + 50_000), cfg,
            )
        )
    truth = np.clip(acc / 64.0, 0.0, 1.0)

    def rmse(img):
        return float(
            np.sqrt(np.mean((np.clip(np.asarray(img), 0, 1) - truth) ** 2))
        )

    err_model = rmse(out)

    # ablation: same frames, but the history LUT frozen at the rest pose
    # (reprojection ignores the motion -- ghosting)
    hist_f = frame_mod.init_history(td, cfg)
    out_f = None
    for i in range(n_frames):
        td_i = transform_triangle_data(
            td, jnp.asarray(_center_rot_y(step * (i + 1), center))
        )
        out_f, hist_f = frame_mod.render_frame_impl(
            td_i, Camera.default(), Light.default(), hist_f, cfg
        )
        hist_f = dataclasses.replace(hist_f, lut=jnp.array(td.lut, copy=True))
    err_frozen = rmse(out_f)
    assert err_model < err_frozen * 0.8, (err_model, err_frozen)

    # and accumulation under motion costs nothing vs no history at all
    cfg1 = dataclasses.replace(cfg, ema_alpha=1.0)
    hist1 = frame_mod.init_history(td, cfg1)
    out1, _ = frame_mod.render_frame_impl(
        td, Camera.default(), Light.default(), hist1, cfg1,
        model=jnp.asarray(_center_rot_y(step * n_frames, center)),
    )
    assert err_model < rmse(out1) * 1.1, (err_model, rmse(out1))
