"""Extension points beyond the reference: albedo overrides, the sharded
kernel route, device info."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
    device_info,
)

CFG = RenderConfig(width=48, height=32, max_bounces=5, wavelet_iterations=3)


def test_albedo_override_changes_render(cornell_scene):
    cam, light = Camera.default(), Light.default()
    default_td = precompute_triangle_data(cornell_scene)
    blue = np.tile(np.array([0.2, 0.2, 0.9], np.float32), (cornell_scene.num_triangles, 1))
    blue_td = precompute_triangle_data(cornell_scene, albedo=blue)

    a = np.asarray(
        pathtrace.path_trace_pass(default_td, cam.position, light, jnp.int32(1), CFG)
    )
    b = np.asarray(
        pathtrace.path_trace_pass(blue_td, cam.position, light, jnp.int32(1), CFG)
    )
    assert not np.allclose(a, b)
    # blue scene: blue channel dominates the average surface response
    assert b[..., 2].mean() > b[..., 0].mean()


def test_albedo_override_shape_check(cornell_scene):
    with pytest.raises(ValueError):
        precompute_triangle_data(cornell_scene, albedo=np.ones((5, 3)))


def test_albedo_override_pallas_parity(cornell_scene):
    from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas.pathtrace import (
        path_trace_pass_pallas,
    )

    cam, light = Camera.default(), Light.default()
    rng = np.random.default_rng(0)
    albedo = rng.uniform(0.1, 0.9, (cornell_scene.num_triangles, 3)).astype(np.float32)
    td = precompute_triangle_data(cornell_scene, albedo=albedo)
    ref = np.asarray(
        pathtrace.path_trace_pass(td, cam.position, light, jnp.int32(3), CFG)
    )
    pal = np.asarray(
        path_trace_pass_pallas(
            td, cam.position, light, jnp.int32(3), CFG, interpret=True
        )
    )
    assert np.abs(ref - pal).max() < 1e-3


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 devices")
def test_sharded_pallas_matches_single(cornell_tri_data):
    """The sharded frame on the trace-kernel route (Pallas interpreter) must
    match the single-chip frame on the same route."""
    from real_time_path_tracing_with_spatiotemporal_filtering.parallel import (
        frame_sharded,
        sharding,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )

    cfg = dataclasses.replace(CFG, backend="pallas", pallas_interpret=True)
    mesh = sharding.make_mesh(2)
    step = frame_sharded.make_sharded_frame(cfg, mesh)
    hist_s = frame_sharded.init_sharded_history(cornell_tri_data, cfg, mesh)
    hist_r = frame_mod.init_history(cornell_tri_data, cfg)
    cam, light = Camera.default(), Light.default()
    for _ in range(2):
        rgb_s, hist_s = step(cornell_tri_data, cam, light, hist_s)
        rgb_r, hist_r = frame_mod.render_frame_impl(
            cornell_tri_data, cam, light, hist_r, cfg
        )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(rgb_r), rtol=1e-4, atol=1e-5
    )


def test_device_info():
    info = device_info()
    assert info["num_devices"] >= 1
    assert info["backend"] in ("cpu", "gpu")


def test_default_scene_loads_out_of_the_box(tmp_path, monkeypatch):
    """load_obj() with no arguments must work (the reference vendors the
    asset and loads it at main.cpp:417); ours is synthesized on first use."""
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        obj as obj_mod,
    )

    target = str(tmp_path / "assets" / "CornellBox-Original-Merged.obj")
    monkeypatch.setattr(obj_mod, "DEFAULT_SCENE", target)
    verts, idx = obj_mod.load_obj()
    assert verts.shape == (64, 3)
    assert idx.shape == (32, 3)
    # second call reuses the materialized asset
    verts2, idx2 = obj_mod.load_obj()
    np.testing.assert_array_equal(verts, verts2)
    np.testing.assert_array_equal(idx, idx2)
    # triangle-exact vs the procedural generator (itself verified against
    # the reference OBJ)
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )

    pv, pi = procedural.cornell_box()
    np.testing.assert_allclose(verts[idx], pv[pi], atol=1e-6)


def test_missing_obj_raises_file_not_found():
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        obj as obj_mod,
    )

    with pytest.raises(FileNotFoundError):
        obj_mod.load_obj("/nonexistent/scene.obj")


def test_empty_scene_renders_sky():
    """A zero-triangle scene must load and render (sky gradient only), not
    crash on an empty triangle table."""
    import numpy as np
    import jax.numpy as jnp

    from real_time_path_tracing_with_spatiotemporal_filtering.config import (
        RenderConfig,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.renderer import (
        Renderer,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Scene,
    )

    scene = Scene.from_arrays(
        np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    )
    cfg = RenderConfig(width=48, height=32, max_bounces=3,
                       wavelet_iterations=3)
    r = Renderer(scene, cfg)
    out = np.asarray(r.step())
    assert np.isfinite(out).all()
    assert out.max() > 0.0  # the sky gradient is visible
