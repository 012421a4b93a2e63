"""Golden-image regression: exact snapshots of the XLA path on CPU.

Guards against silent semantic drift (RNG sequences, shading constants,
filter weights, temporal blend) across refactors. Snapshots were produced
by tests/golden/regenerate (the generating code is embedded below); if a
change is *intentional* (and justified against the reference shaders),
regenerate and explain in the commit.
"""

import os

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    precompute_triangle_data,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CFG = RenderConfig(
    width=48, height=32, max_bounces=6, wavelet_iterations=3, backend="xla"
)


def test_pathtrace_matches_golden(cornell_tri_data):
    cam, light = Camera.default(), Light.default()
    noisy = np.asarray(
        pathtrace.path_trace_pass(
            cornell_tri_data, cam.position, light, jnp.int32(7), CFG
        )
    )
    golden = np.load(os.path.join(GOLDEN, "pathtrace_48x32_f7.npy"))
    np.testing.assert_allclose(noisy, golden, rtol=1e-5, atol=1e-6)


def test_full_frame_matches_golden(cornell_tri_data):
    cam, light = Camera.default(), Light.default()
    hist = frame_mod.init_history(cornell_tri_data, CFG)
    rgb = None
    for _ in range(3):
        rgb, hist = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist, CFG
        )
    golden = np.load(os.path.join(GOLDEN, "frame3_48x32.npy"))
    np.testing.assert_allclose(np.asarray(rgb), golden, rtol=1e-5, atol=1e-6)


def test_variance_guided_frame_matches_golden(cornell_tri_data):
    """Pins the variance-guided SVGF extension (moment accumulation,
    variance-normalized w_l, variance propagation through the a-trous
    iterations)."""
    import dataclasses

    cfg = dataclasses.replace(CFG, variance_guided=True)
    cam, light = Camera.default(), Light.default()
    hist = frame_mod.init_history(cornell_tri_data, cfg)
    rgb = None
    for _ in range(3):
        rgb, hist = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist, cfg
        )
    golden = np.load(os.path.join(GOLDEN, "frame3_48x32_var.npy"))
    np.testing.assert_allclose(np.asarray(rgb), golden, rtol=1e-5, atol=1e-6)
