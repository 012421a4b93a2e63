"""End-to-end denoising quality: the filter must beat raw 1-spp output
against a converged reference (SURVEY.md section 4 test pyramid, level c)."""

import numpy as np
import jax
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.renderer import (
    Renderer,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering.utils.image import rmse

CFG = RenderConfig(width=64, height=48, max_bounces=8)


def test_denoiser_beats_raw_input(cornell_tri_data):
    cam, light = Camera.default(), Light.default()
    fn = jax.jit(
        lambda f: pathtrace.path_trace_pass(
            cornell_tri_data, cam.position, light, f, CFG
        )
    )
    truth = np.zeros((CFG.height, CFG.width, 3), np.float64)
    spp = 192
    for f in range(spp):
        truth += np.asarray(fn(jnp.int32(f + 1_000_000)))
    truth /= spp

    r = Renderer(Scene.cornell_box(), CFG)
    out = None
    for _ in range(16):
        out = np.asarray(r.step())
    noisy = np.asarray(fn(jnp.int32(17)))

    c = lambda x: np.clip(x, 0.0, 1.0)
    e_denoised = rmse(c(out), c(truth))
    e_noisy = rmse(c(noisy), c(truth))
    # The full spatiotemporal pipeline must be closer to the converged image
    # than any single 1-spp frame. The margin is algorithm-limited, not a
    # bug: the reference's 9-iteration LINEAR-stride a-trous has an
    # effective support of +-45 px (temporalFiltering.comp.glsl:135), which
    # at this tiny test resolution blurs most of the frame, so steady-state
    # output carries large filter bias relative to ground truth (the
    # improvement factor grows with resolution; see benchmarks/quality.py).
    assert e_denoised < 0.85 * e_noisy
    assert e_denoised < 0.3


# --- pinned quality bar (north star: "within 5% of the Vulkan A-SVGF
# output"; tracked proxy: rMSE vs a converged reference at a resolution
# where the a-trous support no longer covers the whole frame). Thresholds
# pinned from measured values so a filter regression FAILS CI instead of
# drifting a doc number:
#   128x128, 192-spp truth, 20 frames (measured on CPU, 2026-08-16):
#     reference parity    denoised 0.210, noisy 0.354 (1.69x)
#     variance-guided     denoised 0.160, noisy 0.354 (2.22x)
# The same harness at 256x256 (benchmarks/quality.py) gives 0.19/0.15 --
# the 128px numbers track it within noise.


def _quality_stats(variance_guided: bool):
    from benchmarks.quality import run

    stats = run(size=128, spp=192, frames=20, variance_guided=variance_guided)
    return (
        stats["rmse_denoised"],
        stats["rmse_noisy_1spp"] / max(stats["rmse_denoised"], 1e-12),
    )


def test_quality_bar_reference_parity():
    denoised, improvement = _quality_stats(variance_guided=False)
    assert denoised <= 0.23, f"denoised rMSE regressed: {denoised:.4f}"
    assert improvement >= 1.55, f"improvement regressed: {improvement:.2f}x"


def test_quality_bar_variance_guided():
    denoised, improvement = _quality_stats(variance_guided=True)
    assert denoised <= 0.175, f"denoised rMSE regressed: {denoised:.4f}"
    assert improvement >= 2.0, f"improvement regressed: {improvement:.2f}x"


def test_quality_bar_albedo_demod():
    """Variance-guided SVGF filtering irradiance (albedo demodulation):
    measured 0.151 denoised / 2.31x at 128px (1024-spp truth, 32 frames,
    2026-08-18) vs 0.160 for variance-guided filtering of radiance. Bars
    leave headroom for sampling noise at the CI's 192-spp truth."""
    from benchmarks.quality import run

    stats = run(
        size=128, spp=192, frames=20, variance_guided=True, demodulate=True
    )
    denoised = stats["rmse_denoised"]
    improvement = stats["rmse_noisy_1spp"] / max(denoised, 1e-12)
    assert denoised <= 0.17, f"denoised rMSE regressed: {denoised:.4f}"
    assert improvement >= 2.05, f"improvement regressed: {improvement:.2f}x"


def test_quality_bar_nee():
    """NEE + variance-guided: the framework's best-quality estimator.
    Measured 0.043 denoised / 5.2x at 128px (512-spp truth, 2026-08-18);
    bars leave headroom for sampling noise at the CI's 192-spp truth."""
    from benchmarks.quality import run

    stats = run(size=128, spp=192, frames=20, variance_guided=True, nee=True)
    denoised = stats["rmse_denoised"]
    improvement = stats["rmse_noisy_1spp"] / max(denoised, 1e-12)
    assert denoised <= 0.06, f"denoised rMSE regressed: {denoised:.4f}"
    assert improvement >= 4.0, f"improvement regressed: {improvement:.2f}x"


def test_quality_bar_multires_interactive_stack():
    """The interactive estimator (the suite's interactive row levers:
    multi-res indirect split@1 stride 4 + G-buffer primaries +
    max_bounces=8 + RR@2). Measured 0.2255 denoised / 1.61x at 128px
    (512-spp truth, 32 frames, CPU; full sweep:
    s2x2 0.1785, s2x4 0.2005, s1x4 0.2169, s1x4+gp 0.2170 vs
    variance-guided full-res 0.1547). The bias is real (+46% over the
    full-res bar) and this bar pins it: an upsampler regression FAILS CI
    instead of drifting a doc number. Headroom for the CI's 192-spp
    truth and 20-frame accumulation."""
    from benchmarks.quality import run

    stats = run(
        size=128, spp=192, frames=20, variance_guided=True,
        rr_start_bounce=2, max_bounces=8, indirect_split=1,
        indirect_stride=4, gbuffer_primary=True,
    )
    denoised = stats["rmse_denoised"]
    improvement = stats["rmse_noisy_1spp"] / max(denoised, 1e-12)
    assert denoised <= 0.25, f"denoised rMSE regressed: {denoised:.4f}"
    assert improvement >= 1.4, f"improvement regressed: {improvement:.2f}x"
