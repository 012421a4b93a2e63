"""Which trace the frame takes (pipeline/frame.use_trace_kernel).

One decision serves the single-chip and the sharded frame: the per-pixel
kernel on a GPU under backend="auto", XLA elsewhere, and never the Pallas
interpreter unless the caller asked for it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas import (
    pathtrace as kernel,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
    frame as frame_mod,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)

CFG = RenderConfig(width=32, height=24, max_bounces=3, wavelet_iterations=3)


@pytest.mark.parametrize(
    "platform,overrides,expected",
    [
        ("cpu", {}, False),
        ("gpu", {}, True),
        ("gpu", {"backend": "xla"}, False),
        ("gpu", {"backend": "pallas"}, True),
        ("cpu", {"backend": "pallas", "pallas_interpret": True}, True),
        ("gpu", {"gbuffer_primary": True}, False),
        ("gpu", {"indirect_split": 1}, False),
        ("cpu", {"backend": "pallas", "pallas_interpret": True,
                 "gbuffer_primary": True}, False),
    ],
)
def test_use_trace_kernel(platform, overrides, expected, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = dataclasses.replace(CFG, **overrides)
    assert frame_mod.use_trace_kernel(cfg) is expected


def test_pallas_off_gpu_needs_interpret_opt_in():
    """No hidden fallback: forcing the kernel off the GPU raises instead of
    silently interpreting it."""
    with pytest.raises(ValueError, match="pallas_interpret"):
        frame_mod.use_trace_kernel(dataclasses.replace(CFG, backend="pallas"))


def _frame(td, cfg, frames=2):
    hist = frame_mod.init_history(td, cfg)
    rgb = None
    for _ in range(frames):
        rgb, hist = frame_mod.render_frame_impl(
            td, Camera.default(), Light.default(), hist, cfg
        )
    return np.asarray(rgb)


@pytest.mark.parametrize(
    "flag", [{"gbuffer_primary": True}, {"indirect_split": 1}]
)
def test_untraced_modes_take_xla_trace(flag, cornell_tri_data, monkeypatch):
    """gbuffer_primary and indirect_split route to the XLA trace on the
    kernel route: the kernel is never called and the frame equals the XLA
    frame exactly."""

    def refuse(*args, **kwargs):
        raise AssertionError("the trace kernel was called")

    monkeypatch.setattr(kernel, "path_trace_pass_pallas", refuse)
    cfg = dataclasses.replace(CFG, backend="pallas", **flag)
    np.testing.assert_array_equal(
        _frame(cornell_tri_data, cfg),
        _frame(cornell_tri_data, dataclasses.replace(cfg, backend="xla")),
    )


def test_noisy_trace_passes_interpret_opt_in(cornell_tri_data, monkeypatch):
    seen = {}

    def fake(td, camera_pos, light, frame_idx, cfg, row_offset=0, rows=None,
             rotation=None, interpret=False):
        seen.update(interpret=interpret, rows=rows)
        h = cfg.height if rows is None else rows
        return jnp.zeros((h, cfg.width, 3), jnp.float32)

    monkeypatch.setattr(kernel, "path_trace_pass_pallas", fake)
    cfg = dataclasses.replace(CFG, backend="pallas", pallas_interpret=True)
    frame_mod.noisy_trace(
        cornell_tri_data, Camera.default(), Light.default(), jnp.int32(0),
        cfg, None, None,
    )
    assert seen == {"interpret": True, "rows": None}
