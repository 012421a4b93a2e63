"""Multi-resolution indirect illumination (cfg.indirect_split, extension).

The reference traces every bounce segment at full resolution
(raytrace.comp.glsl:204). ops/multires.py splits the estimator: full-res
truncated trace (direct segments) + coarse full-length trace whose tail
residual -- exact at coarse pixels by PCG-prefix identity -- is
throughput-demodulated, joint-bilaterally upsampled, and re-modulated.
Off by default; parity mode is bit-unchanged (covered by golden tests).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    multires,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    precompute_triangle_data,
)

CFG = RenderConfig(width=64, height=48, max_bounces=6, wavelet_iterations=3)


@pytest.fixture(scope="module")
def cornell_td():
    return precompute_triangle_data(Scene.cornell_box())


def test_config_validation():
    with pytest.raises(ValueError):
        RenderConfig(indirect_split=6, max_bounces=6)  # tail empty
    with pytest.raises(ValueError):
        RenderConfig(indirect_split=2, indirect_stride=0)
    RenderConfig(indirect_split=2, max_bounces=8)  # valid


def test_truncate_radiance_identity(cornell_td):
    """Exact decomposition: the parity estimator equals the truncated
    estimator plus the truncation-point throughput (the fall-through,
    raytrace.comp.glsl:270, returns bare throughput for survivors; dead
    lanes carry zero throughput). Bitwise, by construction."""
    cfg = dataclasses.replace(CFG, max_bounces=2)
    cam, light = Camera.default(), Light.default()
    parity = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3), cfg,
        rotation=cam.rotation,
    )
    tcfg = dataclasses.replace(cfg, truncate_radiance=True)
    trunc, thru = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3), tcfg,
        rotation=cam.rotation, emit_throughput=True,
    )
    np.testing.assert_array_equal(
        np.asarray(parity), np.asarray(trunc) + np.asarray(thru)
    )
    # the closed box keeps many 2-segment paths alive -> throughput is
    # actually exercised (per-pixel: parity albedos carry exact-zero
    # channels, e.g. the red wall's G/B)
    assert (np.asarray(thru).max(axis=-1) > 0).mean() > 0.3


def test_truncate_radiance_noop_when_all_paths_terminate():
    """On an open scene where every path escapes to the sky before the
    bounce cap, the fall-through never fires and truncate_radiance is
    bit-identical to parity."""
    verts = np.array(
        [[-5, -1, -3], [5, -1, -3], [0, -1, -9]], np.float32
    )
    tris = np.array([[0, 1, 2]], np.int32)
    td = precompute_triangle_data(Scene.from_arrays(verts, tris))
    cfg = dataclasses.replace(CFG, max_bounces=8)
    cam, light = Camera.default(), Light.default()
    parity = pathtrace.path_trace_pass(
        td, cam.position, light, jnp.int32(1), cfg, rotation=cam.rotation
    )
    trunc = pathtrace.path_trace_pass(
        td, cam.position, light, jnp.int32(1),
        dataclasses.replace(cfg, truncate_radiance=True),
        rotation=cam.rotation,
    )
    np.testing.assert_array_equal(np.asarray(parity), np.asarray(trunc))


def test_multires_stride1_matches_full_trace(cornell_td):
    """At stride 1 the coarse grid IS the pixel grid and the upsampler is
    an exact pass-through (nearest weight 1, identical guides), so the
    multi-res estimate reduces to trunc + resid = the full-length trace,
    up to the throughput demodulation round-trip (one multiply+divide)."""
    cfg = dataclasses.replace(
        CFG, indirect_split=2, indirect_stride=1, max_bounces=6
    )
    cam, light = Camera.default(), Light.default()
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        gbuffer,
    )

    view, proj = frame_mod.camera_matrices(cam, cfg)
    gbuf = gbuffer.visibility_pass(
        cornell_td, cam.position, view, proj, cfg, rotation=cam.rotation
    )
    normal_img = cornell_td.lut_normals[gbuf.visibility.astype(jnp.int32)]
    noisy = multires.multires_noisy_xla(
        cornell_td, cam.position, light, jnp.int32(5), cfg,
        normal_img, gbuf.depth, rotation=cam.rotation,
    )
    full = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(5),
        dataclasses.replace(cfg, indirect_split=0),
        rotation=cam.rotation,
    )
    np.testing.assert_allclose(
        np.asarray(noisy), np.asarray(full), rtol=0, atol=1e-4
    )


def test_multires_coarse_pixels_exact(cornell_td):
    """At stride 2 the coarse-grid pixels reconstruct the full-length
    trace (pass-through upsample at zero-fraction pixels)."""
    cfg = dataclasses.replace(
        CFG, indirect_split=2, indirect_stride=2, max_bounces=6
    )
    cam, light = Camera.default(), Light.default()
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        gbuffer,
    )

    view, proj = frame_mod.camera_matrices(cam, cfg)
    gbuf = gbuffer.visibility_pass(
        cornell_td, cam.position, view, proj, cfg, rotation=cam.rotation
    )
    normal_img = cornell_td.lut_normals[gbuf.visibility.astype(jnp.int32)]
    noisy = np.asarray(
        multires.multires_noisy_xla(
            cornell_td, cam.position, light, jnp.int32(5), cfg,
            normal_img, gbuf.depth, rotation=cam.rotation,
        )
    )
    full = np.asarray(
        pathtrace.path_trace_pass(
            cornell_td, cam.position, light, jnp.int32(5),
            dataclasses.replace(cfg, indirect_split=0),
            rotation=cam.rotation,
        )
    )
    np.testing.assert_allclose(
        noisy[::2, ::2], full[::2, ::2], rtol=0, atol=1e-4
    )
    # off-grid pixels interpolate the residual: still finite, and the
    # truncated direct part anchors them near the full trace on the
    # smooth interior
    assert np.isfinite(noisy).all()


def test_grid_phase_deterministic_and_varying():
    """The per-frame coarse-grid phase (cfg.indirect_jitter) is a pure
    function of the frame index, in range, and actually varies."""
    phases = []
    for f in range(16):
        oy, ox = multires.grid_phase(jnp.int32(f), 4)
        oy2, ox2 = multires.grid_phase(jnp.int32(f), 4)
        assert int(oy) == int(oy2) and int(ox) == int(ox2)
        assert 0 <= int(oy) < 4 and 0 <= int(ox) < 4
        phases.append((int(oy), int(ox)))
    assert len(set(phases)) > 4  # the rotation visits many phases


def test_jitter_config_validation():
    with pytest.raises(ValueError, match="indirect_jitter"):
        RenderConfig(indirect_jitter=True)  # needs a split
    with pytest.raises(ValueError, match="divisible"):
        RenderConfig(
            width=65, height=48, indirect_split=2, indirect_stride=4,
            indirect_jitter=True, max_bounces=6,
        )
    RenderConfig(
        width=64, height=48, indirect_split=2, indirect_stride=4,
        indirect_jitter=True, max_bounces=6,
    )


def test_jittered_coarse_pixels_exact(cornell_td):
    """With indirect_jitter the exact-residual pass-through moves to the
    phased coarse pixels: at frame f's (oy, ox), noisy[oy::s, ox::s]
    reconstructs the full-length trace (same PCG-prefix identity as the
    fixed grid -- the phased samples are still real global pixels)."""
    s = 2
    cfg = dataclasses.replace(
        CFG, indirect_split=2, indirect_stride=s, indirect_jitter=True,
        max_bounces=6,
    )
    cam, light = Camera.default(), Light.default()
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        gbuffer,
    )

    view, proj = frame_mod.camera_matrices(cam, cfg)
    gbuf = gbuffer.visibility_pass(
        cornell_td, cam.position, view, proj, cfg, rotation=cam.rotation
    )
    normal_img = cornell_td.lut_normals[gbuf.visibility.astype(jnp.int32)]
    full = None
    seen = set()
    for f in (3, 4, 7):
        oy, ox = map(int, multires.grid_phase(jnp.int32(f), s))
        seen.add((oy, ox))
        noisy = np.asarray(
            multires.multires_noisy_xla(
                cornell_td, cam.position, light, jnp.int32(f), cfg,
                normal_img, gbuf.depth, rotation=cam.rotation,
            )
        )
        full = np.asarray(
            pathtrace.path_trace_pass(
                cornell_td, cam.position, light, jnp.int32(f),
                dataclasses.replace(
                    cfg, indirect_split=0, indirect_jitter=False
                ),
                rotation=cam.rotation,
            )
        )
        np.testing.assert_allclose(
            noisy[oy::s, ox::s], full[oy::s, ox::s], rtol=0, atol=1e-4
        )
        assert np.isfinite(noisy).all()
    assert len(seen) > 1  # the frames actually exercised distinct phases


def test_jitter_frame_level_runs(cornell_td):
    """Frame-level smoke: the jittered multi-res frame runs through the
    public Renderer config on the XLA path and stays finite; consecutive
    frames see different phases (outputs differ beyond estimator noise
    at the coarse rows)."""
    cfg = dataclasses.replace(
        CFG, indirect_split=1, indirect_stride=4, indirect_jitter=True,
        max_bounces=6,
    )
    hist = frame_mod.init_history(cornell_td, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(3):
        rgb, hist = frame_mod.render_frame_impl(
            cornell_td, cam, light, hist, cfg
        )
        assert np.isfinite(np.asarray(rgb)).all()


def test_jitter_with_gbuffer_primary(cornell_td):
    """jitter + gbuffer_primary: the phased coarse subsample also applies
    to the (H, W, 3) primary attribute arrays of the XLA path (regression:
    _subsample must pass trailing axes through). Frame-level, 2 frames."""
    cfg = dataclasses.replace(
        CFG, indirect_split=1, indirect_stride=4, indirect_jitter=True,
        gbuffer_primary=True, max_bounces=6,
    )
    hist = frame_mod.init_history(cornell_td, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb, hist = frame_mod.render_frame_impl(
            cornell_td, cam, light, hist, cfg
        )
        assert np.isfinite(np.asarray(rgb)).all()
    # and the seeded jittered estimate equals the aa_sigma=0 unseeded one
    cfg0 = dataclasses.replace(cfg, gbuffer_primary=False, aa_sigma=0.0)
    hist0 = frame_mod.init_history(cornell_td, cfg0)
    hist1 = frame_mod.init_history(cornell_td, cfg)
    for _ in range(2):
        rgb0, hist0 = frame_mod.render_frame_impl(
            cornell_td, cam, light, hist0, cfg0
        )
        rgb1, hist1 = frame_mod.render_frame_impl(
            cornell_td, cam, light, hist1, cfg
        )
    np.testing.assert_array_equal(np.asarray(rgb1), np.asarray(rgb0))


def test_bilateral_upsample_constant_preserved():
    """A constant residual upsamples to the same constant whatever the
    guides do (weights normalize)."""
    cfg = RenderConfig(
        width=16, height=12, indirect_split=1, indirect_stride=4,
        max_bounces=4,
    )
    rng = np.random.default_rng(0)
    hc, wc = 3, 4
    const = tuple(
        jnp.full((hc, wc), v, jnp.float32) for v in (0.25, 1.5, 3.0)
    )
    guide_full = tuple(
        jnp.asarray(rng.normal(size=(12, 16)), jnp.float32) for _ in range(4)
    )
    guide_coarse = tuple(g[::4, ::4] for g in guide_full)
    up = multires.bilateral_upsample(const, guide_coarse, guide_full, cfg)
    for plane, v in zip(up, (0.25, 1.5, 3.0)):
        np.testing.assert_allclose(
            np.asarray(plane), np.full((12, 16), v, np.float32),
            rtol=0, atol=1e-5,
        )


def test_multires_frame_xla(cornell_td):
    """The full frame function runs with indirect_split on the XLA path
    and stays finite across frames (history donation intact)."""
    cfg = dataclasses.replace(
        CFG, indirect_split=2, indirect_stride=2, backend="xla"
    )
    cam, light = Camera.default(), Light.default()
    hist = frame_mod.init_history(cornell_td, cfg)
    for _ in range(3):
        rgb, hist = frame_mod.render_frame(cornell_td, cam, light, hist, cfg)
    assert np.isfinite(np.asarray(rgb)).all()
    assert np.asarray(rgb).max() > 0
