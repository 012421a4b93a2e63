"""Multi-chip sharding on a virtual 8-device CPU mesh.

The key invariant: a row-sharded render is numerically equivalent to the
single-chip render (global pixel coordinates drive seeds/rays/taps; halos
reproduce the filter's global edge clamp).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering.parallel import (
    frame_sharded,
    sharding,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)

CFG = RenderConfig(width=64, height=48, max_bounces=5, wavelet_iterations=3)

requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@requires_8
def test_halo_exchange_matches_edge_pad(rng_np):
    """Sharded halo exchange == global edge-pad + slice."""
    mesh = sharding.make_mesh(8)
    full = jnp.asarray(rng_np.uniform(0, 1, (48, 16)).astype(np.float32))
    halo = 3

    def shard_fn(x):
        return sharding.exchange_row_halo(x, halo)

    out = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=P("rows"), out_specs=P("rows")
    )(full)
    out = np.asarray(out)  # (48 + 8*2*halo, 16), per-shard padded stacks
    local = 48 // 8
    global_np = np.asarray(full)
    for d in range(8):
        shard = out[d * (local + 2 * halo) : (d + 1) * (local + 2 * halo)]
        lo = d * local
        rows = np.clip(np.arange(lo - halo, lo + local + halo), 0, 47)
        np.testing.assert_array_equal(shard, global_np[rows])


@requires_8
def test_atrous_halo_mode_matches_clamped(rng_np, small_cfg):
    """atrous_iteration(halo=k) on globally padded input == halo=0 on raw."""
    h, w = 24, 16
    color = jnp.asarray(rng_np.uniform(0, 1, (h, w, 3)).astype(np.float32))
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (h, w, 3))
    depth = jnp.asarray(rng_np.uniform(0, 1, (h, w)).astype(np.float32))
    for k in (1, 2, 3):
        ref = atrous.atrous_iteration(color, normal, depth, k, small_cfg)

        def pad(x):
            return jnp.concatenate(
                [jnp.repeat(x[:1], k, axis=0), x, jnp.repeat(x[-1:], k, axis=0)],
                axis=0,
            )

        padded = atrous.atrous_iteration(
            pad(color), pad(normal), pad(depth), k, small_cfg, halo=k
        )
        np.testing.assert_allclose(np.asarray(padded), np.asarray(ref), rtol=1e-6)


@requires_8
def test_sharded_frame_matches_single_chip(cornell_tri_data):
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(CFG, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, CFG, mesh)
    cam, light = Camera.default(), Light.default()

    hist_ref = frame_mod.init_history(cornell_tri_data, CFG)
    for _ in range(3):
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, CFG
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )
    assert int(jax.device_get(hist_s.frame)) == 3


@requires_8
def test_sharded_frame_with_motion(cornell_tri_data):
    """Camera + light motion across shard boundaries stays finite and
    matches the single-chip reprojection path."""
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(CFG, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, CFG, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, CFG)
    cam, light = Camera.default(), Light.default()
    for i in range(3):
        cam = dataclasses.replace(
            cam, position=cam.position + jnp.array([0.05, 0.0, -0.1])
        )
        light = dataclasses.replace(
            light, position=light.position + jnp.array([0.1, 0.0, 0.0])
        )
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, CFG
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


def test_mesh_validation():
    with pytest.raises(ValueError):
        frame_sharded.make_sharded_frame(
            RenderConfig(width=8, height=10, wavelet_iterations=3),
            sharding.make_mesh(min(4, len(jax.devices()))),
        )


@requires_8
def test_sharded_frame_nee_rr_matches_single_chip(cornell_tri_data):
    """The estimator extensions (NEE shadow rays + Russian roulette) are
    per-pixel against the replicated scene tables: row sharding must stay
    numerically identical to single-chip with both enabled."""
    cfg = dataclasses.replace(
        CFG, nee=True, rr_start_bounce=2, variance_guided=True
    )
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


@requires_8
def test_reproject_rows_sharded_branches(rng_np):
    """The windowed sharded history reprojection == full-plane gather on
    all three routes: identity (no gather), within the row window (halo
    exchange), beyond it (all-gather fallback, uniform across the mesh)."""
    mesh = sharding.make_mesh(8)
    H, W = 48, 16
    halo = sharding.REPROJ_HALO_ROWS
    plane = jnp.asarray(rng_np.uniform(0, 1, (H, W, 3)).astype(np.float32))
    own_y = np.broadcast_to(np.arange(H)[:, None], (H, W))
    own_x = np.broadcast_to(np.arange(W)[None, :], (H, W))
    cases = {
        "identity": (own_y, own_x),
        # any column delta is fine (columns are local to a row shard)
        "window": (
            np.clip(own_y + rng_np.integers(-halo, halo + 1, (H, W)), 0, H - 1),
            np.clip(own_x + rng_np.integers(-7, 8, (H, W)), 0, W - 1),
        ),
        "cut": (
            rng_np.integers(0, H, (H, W)),
            rng_np.integers(0, W, (H, W)),
        ),
    }
    assert np.abs(cases["cut"][0] - own_y).max() > halo  # really a cut
    local_h = H // 8

    def shard_fn(pl_, py, px):
        off = jax.lax.axis_index("rows") * local_h
        return sharding.reproject_rows_sharded(pl_, py, px, off)

    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("rows"), P("rows"), P("rows")),
        out_specs=P("rows"),
    )
    for name, (py, px) in cases.items():
        out = f(
            plane,
            jnp.asarray(py, jnp.int32),
            jnp.asarray(px, jnp.int32),
        )
        np.testing.assert_array_equal(
            np.asarray(out), np.asarray(plane)[py, px], err_msg=name
        )


@requires_8
def test_sharded_frame_orbit_then_cut(cornell_tri_data):
    """An orbiting camera's history gathers resolve through the bounded
    halo window; a hard camera cut exceeds it and takes the all-gather
    fallback. Both must match the single-chip frame exactly."""
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        gbuffer,
    )

    cfg = dataclasses.replace(CFG, adaptive_alpha=True, variance_guided=True)
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    light = Light.default()
    for angle in (0.0, 0.02, 0.04, 1.5):  # orbit steps, then a cut
        cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, angle, height=1.0)
        if angle == 1.5:
            # prove the cut really exceeds the row window on this scene
            view, proj = frame_mod.camera_matrices(cam, cfg)
            gbuf = gbuffer.visibility_pass(
                cornell_tri_data, cam.position, view, proj, cfg,
                rotation=cam.rotation,
            )
            py, _ = atrous.backproject_pixels(
                gbuf, hist_ref.lut, hist_ref.view, hist_ref.proj, cfg
            )
            own_y = np.arange(cfg.height)[:, None]
            assert np.abs(np.asarray(py) - own_y).max() > (
                sharding.REPROJ_HALO_ROWS
            )
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
        np.testing.assert_allclose(
            np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
        )


@requires_8
def test_sharded_frame_accumulation_ramp(cornell_tri_data):
    """The SVGF accumulation ramp's age plane reprojects through the same
    windowed halo exchange as the color history: sharded frames (with a
    moving light forcing gradient resets) must match single-chip, age
    plane included."""
    cfg = dataclasses.replace(
        CFG, variance_guided=True, accumulation_ramp=True
    )
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam = Camera.default()
    light = Light.default()
    for i in range(3):
        if i == 2:
            light = dataclasses.replace(
                light,
                position=np.asarray(light.position) + np.float32([0.5, 0, 0]),
            )
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_array_equal(
        np.asarray(hist_s.age), np.asarray(hist_ref.age)
    )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


def test_sharded_frame_demodulated(cornell_tri_data):
    """SVGF albedo demodulation is per-pixel: the sharded frame must stay
    numerically identical to single-chip with it enabled (display output
    is re-modulated; history is carried in irradiance space)."""
    cfg = dataclasses.replace(CFG, demodulate_albedo=True, variance_guided=True)
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


def test_sharded_frame_path_gradient(cornell_tri_data):
    """The A-SVGF path-space gradient shards by stratum rows: the re-trace
    is local compute and the two history gathers ride the windowed halo
    exchange, so a sharded frame (with a moving light making the gradient
    fire) must match single-chip (to fusion rounding: XLA fuses the
    luminance dot differently under shard_map, ~1 ULP)."""
    cfg = dataclasses.replace(
        CFG, variance_guided=True, adaptive_alpha=True, path_gradient=True
    )
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam = Camera.default()
    light = Light.default()
    for i in range(3):
        if i >= 1:
            light = dataclasses.replace(
                light,
                position=np.asarray(light.position) + np.float32([0.4, 0, 0]),
            )
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_allclose(
        np.asarray(hist_s.noisy_lum), np.asarray(hist_ref.noisy_lum),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


def test_sharded_path_gradient_stratum_validation():
    cfg = dataclasses.replace(
        CFG, height=40, adaptive_alpha=True, path_gradient=True
    )
    # 40 / 8 = 5 rows per shard, not divisible by stratum 3
    with pytest.raises(ValueError, match="gradient_stratum"):
        frame_sharded.make_sharded_frame(cfg, sharding.make_mesh(8))


@requires_8
def test_comm_ledger_steady_state_vs_cut(cornell_tri_data):
    """Collective byte accounting (sharding.CommLedger): steady-state frames move
    ZERO all-gather bytes (every history gather rides the bounded halo
    window), a camera cut moves exactly the fallback amount, and the halo
    traffic matches the trace-time static count frame for frame."""
    cfg = dataclasses.replace(CFG, adaptive_alpha=True, variance_guided=True)
    mesh = sharding.make_mesh(8)
    ledger = sharding.CommLedger()
    sharded = frame_sharded.make_sharded_frame(cfg, mesh, comm_ledger=ledger)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    light = Light.default()
    got = []
    for angle in (0.0, 0.02, 0.04, 1.5):  # orbit steps, then a cut
        cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, angle, height=1.0)
        _, hist_s, comm = sharded(cornell_tri_data, cam, light, hist_s)
        got.append({k: int(v) for k, v in comm.items()})
    # static counters populated at trace time
    assert ledger.halo_bytes > 0
    assert 0 < ledger.reproj_halo_bytes < ledger.halo_bytes
    assert ledger.gather_fallback_bytes > 0
    # orbit steps stay inside the row window: no all-gather bytes
    assert [g["gather_bytes"] for g in got[1:3]] == [0, 0]
    # the cut falls back on every reprojected plane at once
    assert got[3]["gather_bytes"] == ledger.gather_fallback_bytes
    # halo traffic is the same every frame (window collectives always run)
    assert {g["halo_bytes"] for g in got} == {ledger.halo_bytes}


@requires_8
def test_comm_ledger_1080p_ratio(cornell_tri_data):
    """The '~100x less steady-state traffic' claim for the windowed
    reprojection (sharding.reproject_rows_sharded), checked against the
    collectives actually traced at the headline config (1080p over 8
    chips, full A-SVGF) instead of modeled: the all-gather fallback the
    window replaces moves >= 50x more bytes per frame than the window."""
    cfg = RenderConfig(
        width=1920, height=1080, variance_guided=True,
        accumulation_ramp=True, path_gradient=True,
    )
    mesh = sharding.make_mesh(8)
    ledger = sharding.CommLedger()
    step = frame_sharded.make_sharded_frame(cfg, mesh, comm_ledger=ledger)
    hist = jax.eval_shape(
        lambda: frame_mod.init_history(cornell_tri_data, cfg)
    )
    cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.02, height=1.0)
    # trace only (no 1080p CPU execution): eval_shape populates the ledger
    jax.eval_shape(step, cornell_tri_data, cam, Light.default(), hist)
    assert ledger.gather_fallback_bytes >= 50 * ledger.reproj_halo_bytes
    # and the per-plane window is (2*halo)/(local_h*(n-1)/n... exact check:
    # every reproject call pays 2*halo rows vs (n-1)*local_h rows gathered
    per_call = (7 * (1080 // 8)) / (2 * sharding.REPROJ_HALO_ROWS)
    assert ledger.gather_fallback_bytes == int(
        per_call * ledger.reproj_halo_bytes
    )


@requires_8
def test_sharded_frame_multires_xla(cornell_tri_data):
    """cfg.indirect_split on the sharded XLA frame: the coarse grid rows
    shard with the slab and the upsampler's next-coarse-row shift rides a
    1-coarse-row halo exchange -- numerically equal to single-chip."""
    cfg = dataclasses.replace(CFG, indirect_split=2, indirect_stride=2)
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


@requires_8
def test_sharded_frame_multires_gprimary_interactive_stack(cornell_tri_data):
    """The full interactive estimator stack (indirect_split=1 stride 4 +
    gbuffer_primary + RR + adaptive alpha -- the suite's
    interactive_multires_gprimary row) sharded == single-chip on the XLA
    path."""
    cfg = dataclasses.replace(
        CFG, height=64, indirect_split=1, indirect_stride=4,
        gbuffer_primary=True, rr_start_bounce=2, adaptive_alpha=True,
    )
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


@requires_8
def test_sharded_frame_multires_streamed(rng_np):
    """Multi-res indirect on a 4608-triangle scene, kernel route selected:
    the trace takes the XLA route on both frames (the kernel does not
    trace the split) and the sharded frame (truncated full-res trace +
    sharded coarse tail) matches the single-chip one within a bounded
    measure-zero tie-break budget."""
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Scene,
        precompute_triangle_data,
    )

    cfg = RenderConfig(
        width=128, height=64, max_bounces=3, wavelet_iterations=3,
        backend="pallas", pallas_interpret=True, indirect_split=1,
        indirect_stride=2, gbuffer_primary=True,
    )
    td = precompute_triangle_data(
        Scene.from_arrays(*procedural.subdivided_cornell(12))
    )

    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(td, cfg, mesh)
    hist_ref = frame_mod.init_history(td, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = sharded(td, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            td, cam, light, hist_ref, cfg
        )
    a, b = np.asarray(rgb_s), np.asarray(rgb_ref)
    assert np.isfinite(a).all()
    mismatched = (np.abs(a - b) > 1e-6 + 1e-5 * np.abs(b)).any(axis=-1)
    assert mismatched.mean() <= 5e-4, f"{mismatched.sum()} pixels differ"


def test_sharded_multires_stride_validation():
    # 48 / 8 = 6 rows per shard, not divisible by stride 4
    cfg = dataclasses.replace(CFG, indirect_split=1, indirect_stride=4)
    with pytest.raises(ValueError, match="indirect_stride"):
        frame_sharded.make_sharded_frame(
            cfg, sharding.make_mesh(min(8, len(jax.devices())))
        )
@requires_8
def test_sharded_frame_multires_jitter(cornell_tri_data):
    """cfg.indirect_jitter on the sharded frame: the phased upsample's
    row-index -1 resolves through the halo exchange's TOP row (the
    previous device's last coarse row; edge clamp on device 0), so the
    jittered sharded estimate matches single-chip across frames with
    varying phases."""
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        multires,
    )

    cfg = dataclasses.replace(
        CFG, indirect_split=2, indirect_stride=2, indirect_jitter=True
    )
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    phases = set()
    for f in range(3):
        phases.add(tuple(map(int, multires.grid_phase(jnp.int32(f), 2))))
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    assert len(phases) > 1  # the frames exercised distinct phases
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )


@requires_8
def test_sharded_frame_gbuffer_primary(cornell_tri_data):
    """cfg.gbuffer_primary on the sharded frame: the per-slab G-buffer
    seed keeps the sharded render numerically equal to the single-chip
    one (and both equal the aa_sigma=0 render, tests/test_primary.py)."""
    cfg = dataclasses.replace(CFG, gbuffer_primary=True)
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = sharded(cornell_tri_data, cam, light, hist_s)
        rgb_ref, hist_ref = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_ref, cfg
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_ref), rtol=1e-5, atol=1e-6
    )
