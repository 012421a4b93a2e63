"""Next-event estimation (non-parity extension; cfg.nee).

The reference finds the light only when a cosine-sampled bounce happens to
cross the sphere (raytrace.comp.glsl:226-235). nee=True samples the light's
solid-angle cone explicitly at every diffuse hit with a shadow ray, banks
tp * L * cos * Omega/pi, silently terminates deeper sphere crossings (the
sphere stays a blocker), and drops the loop fall-through quirk. Pinned
here: estimator agreement between the XLA trace and the kernel, unbiasedness
vs the occlusion-aware implicit estimator, and shadowing semantics.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas.pathtrace import (
    path_trace_pass_pallas,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)

CFG = RenderConfig(width=64, height=48, max_bounces=8, nee=True)


def _xla(tri_data, cfg, frame=2):
    cam, light = Camera.default(), Light.default()
    return np.asarray(
        pathtrace.path_trace_pass(
            tri_data, cam.position, light, jnp.int32(frame), cfg
        )
    )


def test_nee_pallas_matches_xla(cornell_tri_data):
    """The per-pixel trace kernel (Pallas interpreter) vs the XLA oracle,
    NEE enabled (its shadow rays run a second triangle loop)."""
    cam, light = Camera.default(), Light.default()
    ref = _xla(cornell_tri_data, CFG)
    pal = np.asarray(
        path_trace_pass_pallas(
            cornell_tri_data, cam.position, light, jnp.int32(2), CFG,
            interpret=True,
        )
    )
    assert np.abs(ref - pal).max() < 2e-4


def test_nee_with_rr_pallas_matches_xla(cornell_tri_data):
    """NEE + Russian roulette compose (NEE banks use pre-RR throughput)."""
    cfg = dataclasses.replace(CFG, rr_start_bounce=3)
    cam, light = Camera.default(), Light.default()
    ref = _xla(cornell_tri_data, cfg, frame=4)
    pal = np.asarray(
        path_trace_pass_pallas(
            cornell_tri_data, cam.position, light, jnp.int32(4), cfg,
            interpret=True,
        )
    )
    # RR's 1/p boost amplifies the ~1e-6 hit-position formulation gap
    assert np.abs(ref - pal).max() < 1e-3


def test_nee_is_unbiased_vs_implicit(cornell_tri_data):
    """Image mean must converge to the occlusion-aware implicit
    estimator's (same transport: sphere blocks; quirk contributions are
    zero at 24 bounces: survivor throughput ~0.7^24)."""
    base = RenderConfig(
        width=48, height=48, max_bounces=24, sample_batches=96,
        light_through_walls=False,
    )
    implicit = _xla(cornell_tri_data, base, frame=5).mean()
    nee = _xla(
        cornell_tri_data, dataclasses.replace(base, nee=True), frame=5
    ).mean()
    assert abs(nee - implicit) / implicit < 0.02, (nee, implicit)


def test_nee_reduces_1spp_noise(cornell_tri_data):
    """The point of NEE: raw 1-spp rMSE vs a converged truth drops."""
    truth_cfg = RenderConfig(
        width=48, height=48, max_bounces=8, sample_batches=64, nee=True
    )
    truth = _xla(cornell_tri_data, truth_cfg, frame=9)
    one = dataclasses.replace(truth_cfg, sample_batches=1)
    c = lambda x: np.clip(x, 0.0, 1.0)  # noqa: E731

    def rmse(a, b):
        return float(np.sqrt(((c(a) - c(b)) ** 2).mean()))

    noisy_imp = _xla(
        cornell_tri_data, dataclasses.replace(one, nee=False), frame=3
    )
    noisy_nee = _xla(cornell_tri_data, one, frame=3)
    assert rmse(noisy_nee, truth) < 0.8 * rmse(noisy_imp, truth)


def test_nee_light_respects_walls(cornell_tri_data):
    """Under NEE the sphere test is occlusion-aware: a ray aimed at the
    light through the back wall shades the wall instead (contrast with
    the parity quirk, test_pathtrace.py)."""
    light = Light.default()
    cfg = CFG
    hdr = light.color * cfg.light_intensity
    o = jnp.asarray(light.position)[None, :] + jnp.array([[0.0, 0.0, -3.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    state = jnp.zeros((1,), jnp.uint32)
    out = pathtrace.trace_paths(
        cornell_tri_data, light.position, hdr, o, d, state, cfg
    )
    assert not np.allclose(np.asarray(out[0]), np.asarray(hdr) / 5.0)
    assert np.isfinite(np.asarray(out)).all()


def test_nee_pathtrace_matches_golden(cornell_tri_data):
    """Exact snapshot (48x32, nee, frame 7): pins cone-sample draw order,
    solid-angle weights and shadow semantics."""
    import os

    golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    cfg = RenderConfig(
        width=48, height=32, max_bounces=6, wavelet_iterations=3,
        backend="xla", nee=True,
    )
    out = _xla(cornell_tri_data, cfg, frame=7)
    golden = np.load(os.path.join(golden_dir, "pathtrace_48x32_f7_nee.npy"))
    np.testing.assert_allclose(out, golden, rtol=1e-5, atol=1e-6)
