"""A-SVGF path-space temporal gradient (cfg.path_gradient, extension).

The reference's temporal gradient Phong-shades one world point under both
lights (temporalGradient.comp.glsl:104-171) -- dense, analytic, but blind
to shadows and indirect transport. ops/pathgrad.py instead RE-TRACES one
previous-frame sample per stratum (same pixel, same camera, same PCG seed)
under the current light; because the sample sequence is bit-identical, the
luminance difference is exactly zero when nothing changed and a true
path-space shading gradient when the light moved. Off by default --
parity mode is bit-unchanged (History.noisy_lum is None; covered by the
golden tests).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    atrous,
    gbuffer,
    pathgrad,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)

CFG = RenderConfig(
    width=64, height=48, max_bounces=6, wavelet_iterations=3,
    adaptive_alpha=True, path_gradient=True,
)


def test_stratum_pixels_in_bounds_and_deterministic():
    h, w, s = 50, 67, 3
    gy, gx = pathgrad.stratum_pixels(h, w, jnp.int32(7), s)
    gy, gx = np.asarray(gy), np.asarray(gx)
    assert gy.shape == (-(-h // s), -(-w // s))
    assert (gy >= 0).all() and (gy < h).all()
    assert (gx >= 0).all() and (gx < w).all()
    # each chosen pixel lies inside its own stratum cell
    sy = np.arange(gy.shape[0])[:, None]
    sx = np.arange(gy.shape[1])[None, :]
    assert (gy // s == np.minimum(sy, (h - 1) // s)).all()
    assert (gx // s == np.minimum(sx, (w - 1) // s)).all()
    gy2, gx2 = pathgrad.stratum_pixels(h, w, jnp.int32(7), s)
    np.testing.assert_array_equal(gy, np.asarray(gy2))
    np.testing.assert_array_equal(gx, np.asarray(gx2))
    # a different frame picks (mostly) different offsets
    gy3, _ = pathgrad.stratum_pixels(h, w, jnp.int32(8), s)
    assert (np.asarray(gy3) != gy).any()


def test_trace_pixels_matches_full_frame_subset():
    """trace_pixels at arbitrary global coordinates is bitwise identical to
    the same pixels of a full-frame pass -- the property the re-trace
    relies on."""
    cfg = dataclasses.replace(CFG, adaptive_alpha=False, path_gradient=False)
    scene = ptsf.Scene.cornell_box()
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        precompute_triangle_data,
    )

    td = precompute_triangle_data(scene)
    cam, light = Camera.default(), Light.default()
    full = pathtrace.path_trace_pass(
        td, cam.position, light, jnp.int32(3), cfg, rotation=cam.rotation
    )
    rng = np.random.default_rng(0)
    py = jnp.asarray(rng.integers(0, cfg.height, (5, 7)), jnp.int32)
    px = jnp.asarray(rng.integers(0, cfg.width, (5, 7)), jnp.int32)
    sub = pathtrace.trace_pixels(
        td, cam.position, light, jnp.int32(3), px, py, cfg,
        rotation=cam.rotation,
    )
    np.testing.assert_array_equal(
        np.asarray(sub), np.asarray(full)[np.asarray(py), np.asarray(px)]
    )


def _gradient_inputs(cfg, cornell_tri_data):
    cam, light = Camera.default(), Light.default()
    view, proj = frame_mod.camera_matrices(cam, cfg)
    f = jnp.int32(5)
    noisy_prev = pathtrace.path_trace_pass(
        cornell_tri_data, cam.position, light, f - 1, cfg,
        rotation=cam.rotation,
    )
    lum_prev = atrous.luminance(noisy_prev)
    gbuf = gbuffer.visibility_pass(
        cornell_tri_data, cam.position, view, proj, cfg,
        rotation=cam.rotation,
    )
    py, px = atrous.backproject_pixels(
        gbuf, cornell_tri_data.lut, view, proj, cfg
    )
    return cam, light, f, lum_prev, gbuf, py, px


def test_gradient_exactly_zero_when_nothing_changed(cornell_tri_data):
    cfg = CFG
    cam, light, f, lum_prev, gbuf, py, px = _gradient_inputs(
        cfg, cornell_tri_data
    )
    lam = pathgrad.path_gradient_pass(
        cornell_tri_data, light, f, cfg, lum_prev,
        jnp.asarray(cam.position), jnp.asarray(cam.rotation),
        py, px, gbuf.visibility, gbuf.visibility,
    )
    assert lam.shape == (cfg.height, cfg.width)
    assert float(jnp.max(jnp.abs(lam))) == 0.0


def test_gradient_exactly_zero_with_gbuffer_primary(cornell_tri_data):
    """With cfg.gbuffer_primary the stored frame luminance comes from the
    G-buffer-seeded (center-ray) trace; the re-trace must drop the AA
    jitter too (aa_sigma=0 re-trace, bit-identical by the mode's
    contract) or a fully static scene shows a spurious gradient and
    temporal accumulation is spuriously reset (round-4 advisor finding)."""
    cfg = dataclasses.replace(CFG, gbuffer_primary=True)
    cam, light = Camera.default(), Light.default()
    view, proj = frame_mod.camera_matrices(cam, cfg)
    f = jnp.int32(5)
    gbuf = gbuffer.visibility_pass(
        cornell_tri_data, cam.position, view, proj, cfg,
        rotation=cam.rotation,
    )
    normal_img = cornell_tri_data.lut_normals[
        gbuf.visibility.astype(jnp.int32)
    ]
    prim = (
        gbuf.visibility,
        gbuf.world_pos,
        normal_img,
        atrous.albedo_image(cornell_tri_data, gbuf.visibility),
    )
    noisy_prev = pathtrace.path_trace_pass(
        cornell_tri_data, cam.position, light, f - 1, cfg,
        rotation=cam.rotation, primary=prim,
    )
    lum_prev = atrous.luminance(noisy_prev)
    py, px = atrous.backproject_pixels(
        gbuf, cornell_tri_data.lut, view, proj, cfg
    )
    lam = pathgrad.path_gradient_pass(
        cornell_tri_data, light, f, cfg, lum_prev,
        jnp.asarray(cam.position), jnp.asarray(cam.rotation),
        py, px, gbuf.visibility, gbuf.visibility,
    )
    assert float(jnp.max(jnp.abs(lam))) == 0.0


def test_gradient_fires_where_light_moved(cornell_tri_data):
    cfg = CFG
    cam, light, f, lum_prev, gbuf, py, px = _gradient_inputs(
        cfg, cornell_tri_data
    )
    moved = dataclasses.replace(
        light,
        position=jnp.asarray(light.position) + jnp.array([1.5, 0.0, 0.0]),
    )
    lam = pathgrad.path_gradient_pass(
        cornell_tri_data, moved, f, cfg, lum_prev,
        jnp.asarray(cam.position), jnp.asarray(cam.rotation),
        py, px, gbuf.visibility, gbuf.visibility,
    )
    lam = np.asarray(lam)
    assert (lam >= 0.0).all() and (lam <= 1.0).all()
    assert lam.max() > 0.05
    assert (lam > 0).mean() > 0.05  # the box filter spreads sparse samples


def test_gradient_zero_on_frame_zero(cornell_tri_data):
    """Frame 0 has no previous frame to re-trace; lambda must be zero."""
    cfg = CFG
    cam, light, _, lum_prev, gbuf, py, px = _gradient_inputs(
        cfg, cornell_tri_data
    )
    lam = pathgrad.path_gradient_pass(
        cornell_tri_data, light, jnp.int32(0), cfg,
        jnp.zeros_like(lum_prev),
        jnp.asarray(cam.position), jnp.asarray(cam.rotation),
        py, px, gbuf.visibility, gbuf.visibility,
    )
    assert float(jnp.max(jnp.abs(lam))) == 0.0


def test_frame_smoke_and_xla_pallas_parity():
    """The full frame runs with path_gradient on both trace routes and the
    path-space lambda drives the same blend: XLA vs the trace kernel (in
    the Pallas interpreter) match to kernel tolerance."""
    scene = ptsf.Scene.cornell_box()
    light0 = Light.default()
    outs = {}
    for backend in ("xla", "pallas"):
        cfg = dataclasses.replace(CFG, backend=backend, pallas_interpret=True)
        r = ptsf.Renderer(scene, cfg)
        r.step()
        r.light = dataclasses.replace(
            light0,
            position=np.asarray(light0.position, np.float32)
            + np.array([0.8, 0.0, 0.0], np.float32),
        )
        out = np.asarray(r.step())
        assert np.isfinite(out).all()
        assert r.history.noisy_lum is not None
        outs[backend] = out
    np.testing.assert_allclose(outs["xla"], outs["pallas"], atol=2e-5)


def _large_tri_data():
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        precompute_triangle_data,
    )

    return precompute_triangle_data(
        ptsf.Scene.from_arrays(*procedural.subdivided_cornell(12))
    )


def test_frame_path_gradient_streamed_scene():
    """A 4608-triangle scene keeps the FULL path-space gradient on the
    kernel route (noisy trace by the kernel, stratum re-trace by the XLA
    tracer) without warning or falling back to the Phong-only lambda."""
    import warnings

    td = _large_tri_data()
    cfg = dataclasses.replace(
        CFG, backend="pallas", pallas_interpret=True, max_bounces=3,
        wavelet_iterations=3,
    )
    light0 = Light.default()

    def run(pg):
        c = dataclasses.replace(cfg, path_gradient=pg)
        hist = frame_mod.init_history(td, c)
        cam = Camera.default()
        out = None
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # any fallback warning fails
            for i in range(3):
                light = dataclasses.replace(
                    light0,
                    position=np.asarray(light0.position, np.float32)
                    + np.array([0.6 * i, 0.0, 0.0], np.float32),
                )
                out, hist = frame_mod.render_frame_impl(
                    td, Camera.default(), light, hist, c
                )
        return np.asarray(out), hist

    with_pg, hist = run(True)
    assert np.isfinite(with_pg).all()
    assert hist.noisy_lum is not None
    without_pg, _ = run(False)
    # the gradient signal must actually reach the blend on large scenes
    assert np.abs(with_pg - without_pg).max() > 1e-4


def test_history_state_carried_only_when_enabled():
    r = ptsf.Renderer(
        ptsf.Scene.cornell_box(),
        dataclasses.replace(CFG, path_gradient=False),
    )
    r.step()
    assert r.history.noisy_lum is None
    assert r.history.cam_pos is None


def test_adaptive_alpha_responds_to_path_gradient():
    """With the light moving, the path gradient raises lambda in shaded
    regions; the blended output must differ from the Phong-only run (same
    seeds, same scene -- the only difference is the gradient signal)."""
    scene = ptsf.Scene.cornell_box()
    light0 = Light.default()

    def run(pg):
        cfg = dataclasses.replace(CFG, path_gradient=pg)
        r = ptsf.Renderer(scene, cfg)
        for i in range(3):
            r.light = dataclasses.replace(
                light0,
                position=np.asarray(light0.position, np.float32)
                + np.array([0.5 * i, 0.0, 0.0], np.float32),
            )
            out = r.step()
        return np.asarray(out)

    a, b = run(False), run(True)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a - b).max() > 1e-4
