"""SVGF albedo demodulation (cfg.demodulate_albedo, extension).

The filter chain runs on irradiance (color / primary-hit albedo
luminance, SVGF Schied et al. 2017 section 3 adapted to the parity
albedos' zero channels -- see ops.atrous.demod_scale); history is carried
demodulated and the returned frame re-modulates for display. Off by
default -- parity mode is bit-unchanged (covered by the golden tests).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)

CFG = RenderConfig(
    width=64, height=48, max_bounces=6, wavelet_iterations=3,
    demodulate_albedo=True, variance_guided=True,
)


def test_demod_requires_variance_guidance():
    import pytest

    with pytest.raises(ValueError, match="variance_guided"):
        RenderConfig(demodulate_albedo=True)


def test_albedo_image_lut(cornell_tri_data):
    """albedo_image: slot 0 (background) -> 1.0, primID+1 -> albedo[prim]."""
    vis = jnp.asarray(
        [[0.0, 1.0], [2.0, float(cornell_tri_data.albedo.shape[0])]],
        jnp.float32,
    )
    img = np.asarray(atrous.albedo_image(cornell_tri_data, vis))
    alb = np.asarray(cornell_tri_data.albedo)
    np.testing.assert_array_equal(img[0, 0], np.ones(3, np.float32))
    np.testing.assert_array_equal(img[0, 1], alb[0])
    np.testing.assert_array_equal(img[1, 0], alb[1])
    np.testing.assert_array_equal(img[1, 1], alb[-1])


def test_demod_roundtrip(rng_np):
    """modulate(demodulate(c)) == c for EVERY albedo (the scalar-luminance
    scale makes the round trip exact even at zero-channel albedos like the
    parity red wall)."""
    c = jnp.asarray(rng_np.uniform(0, 4, (8, 8, 3)).astype(np.float32))
    a = rng_np.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    a[:2] = [0.75, 0.0, 0.0]  # red-wall-style zero channels
    a[2:4] = 0.0              # fully black albedo (guarded by demod_eps)
    s = atrous.demod_scale(jnp.asarray(a), CFG)
    out = np.asarray(atrous.modulate(atrous.demodulate(c, s), s))
    np.testing.assert_allclose(out, np.asarray(c), rtol=1e-6)


def test_demod_frame_xla_vs_pallas(cornell_tri_data):
    """Full demodulated frames agree across trace routes (same tolerance
    as the parity-mode frame test)."""
    cfg_x = dataclasses.replace(CFG, backend="xla")
    cfg_p = dataclasses.replace(CFG, backend="pallas", pallas_interpret=True)
    cam, light = Camera.default(), Light.default()
    hist_x = frame_mod.init_history(cornell_tri_data, cfg_x)
    hist_p = frame_mod.init_history(cornell_tri_data, cfg_p)
    for _ in range(2):
        rgb_x, hist_x = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_x, cfg_x
        )
        rgb_p, hist_p = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_p, cfg_p
        )
    assert np.abs(np.asarray(rgb_x) - np.asarray(rgb_p)).max() < 1e-3


def test_demod_history_space(cornell_tri_data):
    """The returned frame is the re-modulated history: display ==
    history.image * albedo(history.visibility), and the carried history
    differs from the display exactly on non-unit-albedo surfaces."""
    cam, light = Camera.default(), Light.default()
    cfg = dataclasses.replace(CFG, backend="xla")
    hist = frame_mod.init_history(cornell_tri_data, cfg)
    for _ in range(2):
        rgb, hist = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist, cfg
        )
    s = atrous.demod_scale(
        atrous.albedo_image(cornell_tri_data, hist.visibility), cfg
    )
    np.testing.assert_allclose(
        np.asarray(rgb),
        np.asarray(atrous.modulate(hist.image, s)),
        rtol=1e-6, atol=1e-7,
    )
    assert np.isfinite(np.asarray(rgb)).all()


def test_demod_energy_sanity(cornell_tri_data):
    """Demodulation changes WHERE the filter smooths (irradiance space,
    different w_l normalization) but must not create or destroy energy at
    image scale: mean brightness stays within 15% of parity filtering,
    everything finite and non-negative."""
    base = dataclasses.replace(CFG, demodulate_albedo=False, backend="xla")  # variance-guided, no demod
    demod = dataclasses.replace(CFG, backend="xla")
    cam, light = Camera.default(), Light.default()

    def run(cfg):
        hist = frame_mod.init_history(cornell_tri_data, cfg)
        rgb = None
        for _ in range(4):
            rgb, hist = frame_mod.render_frame_impl(
                cornell_tri_data, cam, light, hist, cfg
            )
        return np.asarray(rgb)

    a = run(base)
    b = run(demod)
    assert np.isfinite(b).all() and (b >= 0).all()
    assert abs(b.mean() - a.mean()) < 0.15 * a.mean()
