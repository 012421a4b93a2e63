"""Input controller key semantics + utility coverage."""

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.input import (
    apply_keys,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)
from real_time_path_tracing_with_spatiotemporal_filtering.utils.image import (
    rmse,
    tonemap,
    write_png,
)
from real_time_path_tracing_with_spatiotemporal_filtering.utils.profiling import (
    FrameTimer,
    time_fn,
)

CFG = RenderConfig()


def test_camera_keys():
    cam, light = Camera.default(), Light.default()
    start = np.asarray(cam.position)
    cam2, _, moved = apply_keys(cam, light, {"w"}, CFG)
    assert moved
    np.testing.assert_allclose(
        np.asarray(cam2.position), start + [0, 0, -CFG.move_speed], atol=1e-6
    )
    cam3, _, _ = apply_keys(cam, light, {"d", "e", "s"}, CFG)
    np.testing.assert_allclose(
        np.asarray(cam3.position),
        start + [CFG.move_speed, CFG.move_speed, CFG.move_speed],
        atol=1e-6,
    )
    _, _, moved = apply_keys(cam, light, {"i"}, CFG)
    assert not moved  # light keys don't set cameraMoved


def test_opposing_keys_cancel():
    cam, light = Camera.default(), Light.default()
    cam2, light2, moved = apply_keys(cam, light, {"a", "d", "w", "s"}, CFG)
    assert not moved
    np.testing.assert_array_equal(
        np.asarray(cam2.position), np.asarray(cam.position)
    )


def test_light_keys_and_wrap():
    cam, light = Camera.default(), Light.default()
    _, light2, _ = apply_keys(cam, light, {"l"}, CFG)
    assert float(light2.position[0]) > float(light.position[0])

    # push past +2: wraps to -20 (main.cpp:1151-1153)
    import dataclasses

    near_edge = dataclasses.replace(
        light, position=jnp.array([1.95, 1.0, -0.4], jnp.float32)
    )
    _, wrapped, _ = apply_keys(cam, near_edge, {"l"}, CFG)
    assert float(wrapped.position[0]) == CFG.light_x_wrap_lo

    near_lo = dataclasses.replace(
        light, position=jnp.array([-19.95, 1.0, -0.4], jnp.float32)
    )
    _, wrapped2, _ = apply_keys(cam, near_lo, {"j"}, CFG)
    assert float(wrapped2.position[0]) == CFG.light_x_wrap_hi


def test_image_utils(tmp_path):
    img = np.random.default_rng(0).uniform(-0.5, 2.0, (8, 10, 3)).astype(np.float32)
    t = tonemap(img)
    assert t.dtype == np.uint8 and t.min() >= 0
    path = str(tmp_path / "x.png")
    write_png(path, img)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert rmse(img, img) == 0.0
    assert rmse(np.zeros(4), np.ones(4)) == 1.0


def test_time_fn_and_timer():
    import jax

    f = jax.jit(lambda x: x * 2.0)
    ms = time_fn(f, jnp.ones(128), iters=3, warmup=1)
    assert ms >= 0.0
    timer = FrameTimer(window=4)
    timer.tick()
    timer.tick()
    assert timer.ms_per_frame >= 0.0
    assert timer.fps > 0.0


def test_ansi_preview():
    from real_time_path_tracing_with_spatiotemporal_filtering.viewer import (
        ansi_preview,
    )

    img = np.random.default_rng(0).uniform(0, 1, (32, 48, 3)).astype(np.float32)
    s = ansi_preview(img, 40, 10)
    assert s.count("\n") + 1 <= 10
    assert "\x1b[38;2" in s and s.endswith("\x1b[0m")


def test_enable_validation_toggles():
    import jax

    from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
        enable_validation,
    )

    try:
        enable_validation(True)
        assert jax.config.jax_debug_nans
        # a clean computation passes under validation
        out = jax.jit(lambda x: x * 2.0)(jnp.ones(8))
        assert float(out.sum()) == 16.0
    finally:
        enable_validation(False)
    assert not jax.config.jax_debug_nans


def test_interaction_keeps_host_numpy_leaves():
    """move_camera/move_light/apply_keys must store numpy positions: a
    device-array leaf makes the NEXT mutation's np.asarray a device->host
    round trip per frame (pipeline stall)."""
    import numpy as np

    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.input import (
        apply_keys,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
    )

    cfg = ptsf.RenderConfig(width=32, height=16, max_bounces=2)
    r = ptsf.Renderer(ptsf.Scene.cornell_box(), cfg)
    r.move_light(dx=0.3)
    r.move_light(dx=0.3)  # second call exercises asarray on the stored leaf
    r.move_camera(dx=0.1)
    assert isinstance(r.light.position, np.ndarray)
    assert isinstance(r.camera.position, np.ndarray)
    cam, light, moved = apply_keys(r.camera, r.light, {"w", "l"}, cfg)
    assert moved
    assert isinstance(cam.position, np.ndarray)
    assert isinstance(light.position, np.ndarray)
    assert isinstance(Camera.orbit([0, 1, 0], 6.0, 0.1, 1.0).position, np.ndarray)
    r.step()  # numpy leaves must be accepted by the jitted frame
