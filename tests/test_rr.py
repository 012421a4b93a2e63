"""Russian-roulette termination (non-parity extension; cfg.rr_start_bounce).

The reference always traces all max_bounces segments
(raytrace.comp.glsl:204); RR is the framework's config-gated early
termination: from bounce rr_start_bounce on, a bounced path survives with
p = clamp(max(throughput), rr_min_prob, rr_max_prob) and survivors divide
their throughput by p (unbiased). Pinned here: exact no-op when gated off
or out of range, XLA/kernel agreement, and unbiasedness.
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

CFG = RenderConfig(width=64, height=48, max_bounces=8)


def _xla(tri_data, cfg, frame=2):
    cam, light = Camera.default(), Light.default()
    return np.asarray(
        pathtrace.path_trace_pass(
            tri_data, cam.position, light, jnp.int32(frame), cfg
        )
    )


def test_rr_start_at_max_bounces_is_exact_noop(cornell_tri_data):
    """seg runs 0..max_bounces-1, so rr_start_bounce == max_bounces never
    gambles: no extra PCG draws, bit-identical to RR off."""
    off = _xla(cornell_tri_data, CFG)
    gated = _xla(
        cornell_tri_data,
        dataclasses.replace(CFG, rr_start_bounce=CFG.max_bounces),
    )
    np.testing.assert_array_equal(off, gated)


def test_rr_changes_image_and_stays_finite(cornell_tri_data):
    off = _xla(cornell_tri_data, CFG)
    rr = _xla(cornell_tri_data, dataclasses.replace(CFG, rr_start_bounce=2))
    assert np.isfinite(rr).all()
    assert np.abs(rr - off).max() > 1e-3  # RR actually kicked in


def test_rr_pallas_matches_xla(cornell_tri_data):
    cfg = dataclasses.replace(CFG, rr_start_bounce=2)
    cam, light = Camera.default(), Light.default()
    ref = _xla(cornell_tri_data, cfg)
    pal = np.asarray(
        path_trace_pass_pallas(
            cornell_tri_data, cam.position, light, jnp.int32(2), cfg,
            interpret=True,
        )
    )
    # same tolerance as the parity test without RR (hit-position
    # formulation differs ~1e-6; RR draws share the PCG stream)
    assert np.abs(ref - pal).max() < 1e-4


def test_rr_is_unbiased_in_the_mean(cornell_tri_data):
    """Image-mean radiance with RR must match no-RR within Monte-Carlo
    noise: many samples via sample_batches (averaged), loose 3% bar."""
    base = dataclasses.replace(CFG, sample_batches=16)
    off = _xla(cornell_tri_data, base).mean()
    rr = _xla(
        cornell_tri_data, dataclasses.replace(base, rr_start_bounce=3)
    ).mean()
    assert abs(rr - off) / off < 0.03, (rr, off)


def test_rr_config_validation():
    import pytest

    with pytest.raises(ValueError):
        RenderConfig(rr_start_bounce=-1)
    with pytest.raises(ValueError):
        RenderConfig(rr_min_prob=0.5, rr_max_prob=0.4)
    with pytest.raises(ValueError):
        RenderConfig(rr_min_prob=0.0)


def test_rr_pathtrace_matches_golden(cornell_tri_data):
    """Exact snapshot of the RR trace (48x32, rr_start_bounce=2, frame 7):
    pins the RR draw order / probability / compensation semantics."""
    import os

    golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    cfg = dataclasses.replace(
        CFG, width=48, height=32, max_bounces=6, wavelet_iterations=3,
        backend="xla", rr_start_bounce=2,
    )
    out = _xla(cornell_tri_data, cfg, frame=7)
    golden = np.load(os.path.join(golden_dir, "pathtrace_48x32_f7_rr2.npy"))
    np.testing.assert_allclose(out, golden, rtol=1e-5, atol=1e-6)
