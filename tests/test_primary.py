"""G-buffer-seeded primary rays (cfg.gbuffer_primary, extension).

The visibility pass already ray-traces primary visibility with the
tracer's camera model (ops/gbuffer.py); gbuffer_primary replays bounce 0
off its committed hit and starts the trace at segment 1
(ops/pathtrace.primary_carry). The defining contract, tested here: the
output is bit-identical to a full trace with cfg.aa_sigma = 0 (primary
AA jitter is disabled; the jitter draws still advance the PCG stream).
Off by default; parity mode is bit-unchanged (golden tests).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    atrous,
    gbuffer,
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


@pytest.fixture(scope="module")
def large_td():
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )

    return precompute_triangle_data(
        Scene.from_arrays(*procedural.subdivided_cornell(6))
    )


def _primary_from_gbuf(td, gbuf):
    normal_img = td.lut_normals[gbuf.visibility.astype(jnp.int32)]
    return (
        gbuf.visibility,
        gbuf.world_pos,
        normal_img,
        atrous.albedo_image(td, gbuf.visibility),
    )


def _gbuf(td, cam, cfg):
    view, proj = frame_mod.camera_matrices(cam, cfg)
    return gbuffer.visibility_pass(
        td, cam.position, view, proj, cfg, rotation=cam.rotation
    )


def test_config_validation():
    RenderConfig(gbuffer_primary=True)  # valid alone
    # composes with nee since round 5 (dedicated bounce-0 shadow segment)
    RenderConfig(gbuffer_primary=True, nee=True, light_through_walls=False)


def test_xla_primary_equals_sigma0_trace(cornell_td):
    """The defining contract, parity quirks on: seeding bounce 0 from the
    G-buffer is bit-identical to the full dense trace at aa_sigma=0 (the
    G-buffer's nearest-hit record IS the tracer's segment-0 record for
    center rays)."""
    cam, light = Camera.default(), Light.default()
    prim = _primary_from_gbuf(cornell_td, _gbuf(cornell_td, cam, CFG))
    seeded = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3),
        dataclasses.replace(CFG, gbuffer_primary=True),
        rotation=cam.rotation, primary=prim,
    )
    full = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3),
        dataclasses.replace(CFG, aa_sigma=0.0),
        rotation=cam.rotation,
    )
    np.testing.assert_array_equal(np.asarray(seeded), np.asarray(full))


def test_xla_primary_with_rr_and_truncate(cornell_td):
    """The contract holds with the non-parity estimator levers the
    interactive configs use (RR consumes no draw at segment 0 because
    rr_start_bounce >= 1; truncate_radiance only changes the epilogue)."""
    cam, light = Camera.default(), Light.default()
    cfg = dataclasses.replace(
        CFG, rr_start_bounce=2, truncate_radiance=True
    )
    prim = _primary_from_gbuf(cornell_td, _gbuf(cornell_td, cam, cfg))
    seeded, thru_s = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(7),
        dataclasses.replace(cfg, gbuffer_primary=True),
        rotation=cam.rotation, primary=prim, emit_throughput=True,
    )
    full, thru_f = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(7),
        dataclasses.replace(cfg, aa_sigma=0.0),
        rotation=cam.rotation, emit_throughput=True,
    )
    np.testing.assert_array_equal(np.asarray(seeded), np.asarray(full))
    np.testing.assert_array_equal(np.asarray(thru_s), np.asarray(thru_f))


def test_xla_primary_light_ordering_mode(cornell_td):
    """light_through_walls=False (the non-parity light-vs-triangle
    ordering): primary_carry reconstructs rec.t as dot(world_pos - o, d),
    which can differ from the intersector's t in the last ulp, so the
    contract here is allclose rather than bit-equal (round-4 advisor
    finding -- the docstring caveat now has a test)."""
    cam, light = Camera.default(), Light.default()
    cfg = dataclasses.replace(CFG, light_through_walls=False)
    prim = _primary_from_gbuf(cornell_td, _gbuf(cornell_td, cam, cfg))
    seeded = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3),
        dataclasses.replace(cfg, gbuffer_primary=True),
        rotation=cam.rotation, primary=prim,
    )
    full = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3),
        dataclasses.replace(cfg, aa_sigma=0.0),
        rotation=cam.rotation,
    )
    np.testing.assert_allclose(
        np.asarray(seeded), np.asarray(full), rtol=0, atol=2e-5
    )


def test_xla_primary_spp_batches(cornell_td):
    """Multi-sample/multi-batch streams stay aligned (each sample's
    jitter draws advance the state exactly as at aa_sigma=0)."""
    cam, light = Camera.default(), Light.default()
    cfg = dataclasses.replace(CFG, spp=2, sample_batches=2, max_bounces=4)
    prim = _primary_from_gbuf(cornell_td, _gbuf(cornell_td, cam, cfg))
    seeded = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(2),
        dataclasses.replace(cfg, gbuffer_primary=True),
        rotation=cam.rotation, primary=prim,
    )
    full = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(2),
        dataclasses.replace(cfg, aa_sigma=0.0),
        rotation=cam.rotation,
    )
    np.testing.assert_array_equal(np.asarray(seeded), np.asarray(full))


def test_xla_primary_with_nee(cornell_td):
    """nee + gbuffer_primary on the XLA path: the bounce-0 vertex samples
    the light exactly like a full trace's segment 0 (primary_carry passes
    tri_data through for the dense shadow test). allclose, not bit-equal,
    with an rtol term: unlike the parity estimator (whose radiance is a
    product of discrete decisions), NEE's gain is a CONTINUOUS function
    of the hit position (light distance -> cone solid angle), so last-ulp
    differences between the G-buffer's interpolated world_pos and the
    intersector's o + t*d surface as ~1e-5 RELATIVE radiance diffs on the
    HDR direct-light term (measured: 5 of 3072 pixels, max 8e-5 on ~7.0)."""
    cam, light = Camera.default(), Light.default()
    cfg = dataclasses.replace(CFG, nee=True)
    prim = _primary_from_gbuf(cornell_td, _gbuf(cornell_td, cam, cfg))
    seeded = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3),
        dataclasses.replace(cfg, gbuffer_primary=True),
        rotation=cam.rotation, primary=prim,
    )
    full = pathtrace.path_trace_pass(
        cornell_td, cam.position, light, jnp.int32(3),
        dataclasses.replace(cfg, aa_sigma=0.0),
        rotation=cam.rotation,
    )
    np.testing.assert_allclose(
        np.asarray(seeded), np.asarray(full), rtol=5e-5, atol=2e-5
    )


def test_multires_primary_matches_sigma0(large_td):
    """The full multi-res estimate with G-buffer seeding equals the same
    estimate at aa_sigma=0 without it."""
    cfg = RenderConfig(
        width=48, height=32, max_bounces=4, wavelet_iterations=3,
        indirect_split=1, indirect_stride=2,
    )
    cam, light = Camera.default(), Light.default()
    gbuf = _gbuf(large_td, cam, cfg)
    normal_img = large_td.lut_normals[gbuf.visibility.astype(jnp.int32)]
    seeded = multires.multires_noisy_xla(
        large_td, cam.position, light, jnp.int32(6),
        dataclasses.replace(cfg, gbuffer_primary=True),
        normal_img, gbuf.depth, rotation=cam.rotation,
        primary=_primary_from_gbuf(large_td, gbuf),
    )
    full = multires.multires_noisy_xla(
        large_td, cam.position, light, jnp.int32(6),
        dataclasses.replace(cfg, aa_sigma=0.0),
        normal_img, gbuf.depth, rotation=cam.rotation,
    )
    np.testing.assert_allclose(
        np.asarray(seeded), np.asarray(full), rtol=0, atol=1e-5
    )


def test_frame_xla_primary_equals_sigma0(cornell_td):
    """Frame-level contract on the XLA path: a gbuffer_primary frame is
    bit-identical to an aa_sigma=0 frame (the trace is the only consumer
    of the flag; everything downstream sees identical noisy input)."""
    cam, light = Camera.default(), Light.default()
    cfg_p = dataclasses.replace(
        CFG, backend="xla", gbuffer_primary=True, max_bounces=4
    )
    cfg_0 = dataclasses.replace(
        CFG, backend="xla", aa_sigma=0.0, max_bounces=4
    )
    hist_p = frame_mod.init_history(cornell_td, cfg_p)
    hist_0 = frame_mod.init_history(cornell_td, cfg_0)
    for _ in range(2):
        rgb_p, hist_p = frame_mod.render_frame(
            cornell_td, cam, light, hist_p, cfg_p
        )
        rgb_0, hist_0 = frame_mod.render_frame(
            cornell_td, cam, light, hist_0, cfg_0
        )
    np.testing.assert_array_equal(np.asarray(rgb_p), np.asarray(rgb_0))


def test_frame_pallas_streamed_primary(large_td):
    """Kernel-route frame on a larger scene with gbuffer_primary +
    indirect_split: the noisy trace takes the XLA route (the kernel traces
    neither mode), runs, is finite, and is close to the aa_sigma=0 frame
    without the seed."""
    cam, light = Camera.default(), Light.default()
    base = RenderConfig(
        width=48, height=32, max_bounces=4, wavelet_iterations=3,
        backend="pallas", pallas_interpret=True, indirect_split=1,
        indirect_stride=2,
    )
    cfg_p = dataclasses.replace(base, gbuffer_primary=True)
    cfg_0 = dataclasses.replace(base, aa_sigma=0.0)
    hist_p = frame_mod.init_history(large_td, cfg_p)
    hist_0 = frame_mod.init_history(large_td, cfg_0)
    rgb_p, _ = frame_mod.render_frame(large_td, cam, light, hist_p, cfg_p)
    rgb_0, _ = frame_mod.render_frame(large_td, cam, light, hist_0, cfg_0)
    assert np.isfinite(np.asarray(rgb_p)).all()
    np.testing.assert_allclose(
        np.asarray(rgb_p), np.asarray(rgb_0), rtol=0, atol=1e-5
    )
