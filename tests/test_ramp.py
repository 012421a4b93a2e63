"""SVGF accumulation ramp (cfg.accumulation_ramp, extension).

History carries a per-pixel consecutive-history length N (History.age,
reprojected like the color history); the temporal blend uses
alpha = max(ramp_alpha_min, 1/N) instead of the reference's fixed
alpha=0.3 (temporalFiltering.comp.glsl:243), and the A-SVGF temporal
gradient resets N where shading changed (SVGF Schied et al. 2017
section 4's "alpha = max(1/N, 0.2)" with the gradient playing the
history-rejection role). Off by default -- parity mode is bit-unchanged
(History.age is None; covered by the golden tests).
"""

import dataclasses

import numpy as np

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)

CFG = RenderConfig(
    width=64, height=48, max_bounces=6, wavelet_iterations=3,
    variance_guided=True, accumulation_ramp=True,
)


def _renderer(cfg):
    return ptsf.Renderer(ptsf.Scene.cornell_box(), cfg)


def test_ramp_off_has_no_age_plane():
    r = _renderer(dataclasses.replace(CFG, accumulation_ramp=False))
    r.step()
    assert r.history.age is None


def test_age_counts_static_frames():
    """Static scene, static camera: every pixel's age is the frame count
    (no gradient fires, the reprojection is the identity)."""
    r = _renderer(CFG)
    for _ in range(5):
        r.step()
    age = np.asarray(r.history.age)
    np.testing.assert_array_equal(age, np.full_like(age, 5.0))


def test_age_resets_on_light_cut():
    """A light jump makes the temporal gradient fire on lit pixels; their
    age must reset to 1 while unaffected pixels keep accumulating."""
    r = _renderer(CFG)
    for _ in range(6):
        r.step()
    r.move_light(dx=0.5)
    r.step()
    age = np.asarray(r.history.age)
    assert (age == 1.0).any(), "no pixel reset on a light cut"
    assert (age == 7.0).any(), "every pixel reset (gradient too eager)"
    assert age.min() >= 1.0 and age.max() <= 7.0


def test_age_survives_camera_orbit():
    """Age follows the reprojection: a small orbit step must NOT zero the
    age field wholesale (ghost-free motion is the ramp's whole point)."""
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
    )

    r = _renderer(CFG)
    for i in range(7):
        r.camera = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0)
        r.step()
    age = np.asarray(r.history.age)
    # most pixels keep deep history (reprojected age reaches the frame
    # count; the box edges may churn)
    assert (age >= 6.0).mean() > 0.5


def test_age_resets_on_camera_cut():
    """A camera cut is invisible to the temporal gradient (it Phong-shades
    the SAME world point under both lights -- camera-independent), so
    history rejection must come from the visibility-id mismatch: the
    backprojected history pixel saw a different primitive. After a large
    sideways jump, a substantial share of pixels must reset to age 1
    (the blend then REPLACES the stale history, alpha = 1/1), instead of
    ghosting it in at the ramp's 0.1 alpha floor."""
    r = _renderer(CFG)
    for _ in range(8):
        r.step()
    r.move_camera(dx=1.5)
    r.step()
    age = np.asarray(r.history.age)
    assert (age == 1.0).mean() > 0.1, (
        f"only {(age == 1.0).mean():.3f} of pixels rejected stale history "
        "after a camera cut"
    )


def test_ramp_converges_deeper_than_fixed_alpha():
    """Static scene: after enough frames the ramp's alpha floor (0.1)
    averages ~3x more effective history than the fixed alpha=0.3, so the
    steady-state output must be strictly smoother. Proxy: temporal
    variance of the last few outputs (ground truth-free, cheap)."""
    outs = {}
    for ramp in (False, True):
        cfg = dataclasses.replace(CFG, accumulation_ramp=ramp)
        r = _renderer(cfg)
        frames = []
        for i in range(24):
            out = np.asarray(r.step())
            if i >= 18:
                frames.append(out)
        outs[ramp] = np.stack(frames)
    # frame-to-frame fluctuation of the blended output
    flut_fixed = np.abs(np.diff(outs[False], axis=0)).mean()
    flut_ramp = np.abs(np.diff(outs[True], axis=0)).mean()
    assert flut_ramp < 0.6 * flut_fixed, (flut_ramp, flut_fixed)


def test_pallas_frame_ramp_matches_xla():
    """Full-frame parity with the ramp enabled on the kernel route
    (Pallas interpreter on CPU): light motion (gradient resets) + camera
    orbit (reprojection) must track the XLA frame, age plane included."""
    import jax.numpy as jnp
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
        Light,
        precompute_triangle_data,
    )
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf

    td = precompute_triangle_data(ptsf.Scene.cornell_box())
    cfg_x = dataclasses.replace(
        CFG, width=128, height=32, backend="xla", adaptive_alpha=True
    )
    cfg_p = dataclasses.replace(cfg_x, backend="pallas", pallas_interpret=True)
    light = Light.default()
    hist_x = frame_mod.init_history(td, cfg_x)
    hist_p = frame_mod.init_history(td, cfg_p)
    for i in range(4):
        cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.004 * i, 1.0)
        if i == 2:
            light = dataclasses.replace(
                light, position=light.position + jnp.array([0.3, 0.0, 0.0])
            )
        rgb_x, hist_x = frame_mod.render_frame_impl(td, cam, light, hist_x, cfg_x)
        rgb_p, hist_p = frame_mod.render_frame_impl(td, cam, light, hist_p, cfg_p)
    diff = np.abs(np.asarray(rgb_x) - np.asarray(rgb_p))
    age_diff = np.abs(np.asarray(hist_x.age) - np.asarray(hist_p.age))
    assert diff.max() < 1e-3, diff.max()
    # ages are integer counts; allow the same <1% boundary-pixel slack
    assert (age_diff > 0).mean() < 0.02, (age_diff > 0).mean()


def test_checkpoint_roundtrip_with_ramp(tmp_path):
    """The age plane rides the checkpoint like every other history leaf."""
    r = _renderer(CFG)
    for _ in range(4):
        r.step()
    p = str(tmp_path / "state.npz")
    r.save_state(p)
    r2 = _renderer(CFG)
    r2.load_state(p)
    np.testing.assert_array_equal(
        np.asarray(r.history.age), np.asarray(r2.history.age)
    )
    a = np.asarray(r.step())
    b = np.asarray(r2.step())
    np.testing.assert_array_equal(a, b)


def test_normal_class_keys():
    """atrous.normal_class: flat-surface sub-triangles (identical normals)
    share a key; perpendicular surfaces differ; background keys to 0."""
    import jax.numpy as jnp

    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        atrous,
    )

    n = jnp.array(
        [
            [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]],   # same flat surface
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],   # perpendicular walls
        ],
        jnp.float32,
    )
    vis = jnp.array([[3.0, 7.0], [9.0, 0.0]], jnp.float32)
    cls = np.asarray(atrous.normal_class(n, vis))
    assert cls[0, 0] == cls[0, 1]          # ids differ, surface agrees
    assert cls[1, 0] != cls[0, 0]
    assert cls[1, 1] == 0.0                # background sentinel
    # tuple-of-planes form (the Pallas frame) is identical
    cls2 = np.asarray(
        atrous.normal_class((n[..., 0], n[..., 1], n[..., 2]), vis)
    )
    np.testing.assert_array_equal(cls, cls2)


def test_normal_reset_mode_keeps_history_on_tessellated_orbit():
    """THE failure mode that motivated ramp_reset_mode (round 5): on a
    finely tessellated scene a moving camera lands nearly every
    backprojection on a different sub-triangle of the same flat wall, so
    exact-id consistency resets history every frame and accumulation
    dies. The quantized-normal test keeps it."""
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
    )

    scene = ptsf.Scene.from_arrays(*procedural.subdivided_cornell(8))
    ages = {}
    for mode in ("id", "normal"):
        cfg = dataclasses.replace(
            CFG, backend="xla", ramp_reset_mode=mode, max_bounces=3
        )
        r = ptsf.Renderer(scene, cfg)
        for i in range(4):
            # fast orbit: several pixels of reprojection shift per frame,
            # crossing sub-triangle boundaries nearly everywhere (the
            # regime the 1080p/32k-tri interactive rows live in)
            r.camera = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.08 * i, 1.0)
            out = r.step()
        assert np.isfinite(np.asarray(out)).all()
        ages[mode] = np.asarray(r.history.age)
    # id mode: ids shuffle under motion -> history resets across flat
    # walls; normal mode: identical wall normals keep it. Both modes
    # still reset at genuine disocclusions and gradient events, so pin
    # the FULL-HISTORY fraction (pixels that never reset) and the mean.
    full_id = (ages["id"] == 4.0).mean()
    full_nm = (ages["normal"] == 4.0).mean()
    assert full_nm > 1.5 * full_id, (full_nm, full_id)
    assert np.mean(ages["normal"]) > 1.2 * np.mean(ages["id"])


def test_normal_reset_sharded_matches_single_chip(cornell_tri_data):
    """ramp_reset_mode='normal' under the row-sharded frame: the class
    plane shards and reprojects like the other history planes."""
    import jax

    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
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

    cfg = dataclasses.replace(CFG, ramp_reset_mode="normal")
    mesh = sharding.make_mesh(8)
    sharded = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_ref = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for i in range(3):
        cam = dataclasses.replace(
            cam, position=np.asarray(cam.position) + np.float32([0.05, 0, 0])
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


def test_firefly_clamp_bounds_output():
    """cfg.firefly_clamp: the noisy estimate is channel-clamped before
    filtering/accumulation, so the (convex) filtered+blended output is
    bounded by the clamp; off by default (parity golden tests cover
    bit-identity). The unclamped render exceeds it at the HDR light."""
    cfg0 = dataclasses.replace(CFG, max_bounces=4)
    cfg1 = dataclasses.replace(cfg0, firefly_clamp=2.0)
    outs = {}
    for name, cfg in (("off", cfg0), ("on", cfg1)):
        r = _renderer(cfg)
        for _ in range(3):
            out = np.asarray(r.step())
        outs[name] = out
    assert outs["off"].max() > 2.0      # HDR light pixels
    assert outs["on"].max() <= 2.0 + 1e-5
    assert np.isfinite(outs["on"]).all()
