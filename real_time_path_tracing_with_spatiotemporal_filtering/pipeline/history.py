"""Cross-frame history state.

The reference persists exactly this set between frames by blitting/copying
at end-of-frame (main.cpp:1361-1372, SURVEY.md section 3.5): previous output
image, previous visibility buffer, previous visibility LUT, previous
view/proj matrices, previous light position and color, and the frame
counter. Here it is one immutable pytree returned by the frame function;
``jax.jit(donate_argnums=...)`` recovers the in-place buffer reuse the
Vulkan blits provided.
"""

from __future__ import annotations

import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.utils.pytree import (
    pytree_dataclass,
)


@pytree_dataclass
class History:
    """Everything frame N+1 reads from frame N."""

    image: jnp.ndarray            # (H, W, 3) previous final (blended) output
    visibility: jnp.ndarray       # (H, W) previous primID+1 image. Carried
    #   for parity/extension: the reference copies it every frame
    #   (main.cpp:1365-1367) though no current kernel samples it.
    lut: jnp.ndarray              # (T+1, 3, 3) previous visibility LUT
    view: jnp.ndarray             # (4, 4) previous view matrix
    proj: jnp.ndarray             # (4, 4) previous projection matrix
    light_pos: jnp.ndarray        # (3,) previous light position
    light_color: jnp.ndarray     # (3,) previous light base color
    frame: jnp.ndarray            # () int32 frame counter
    # (H, W, 2) temporally accumulated luminance moments (mu1, mu2) for
    # variance-guided filtering; None unless cfg.variance_guided (the
    # reference has no equivalent -- SVGF extension, see config.py).
    moments: jnp.ndarray | None = None
    # (H, W) per-pixel consecutive-history length N for the SVGF
    # accumulation ramp; None unless cfg.accumulation_ramp (see config.py).
    age: jnp.ndarray | None = None
    # (H, W) quantized-surface-normal consistency key (atrous.normal_class)
    # for the ramp's history-rejection test; None unless
    # cfg.accumulation_ramp and cfg.ramp_reset_mode == "normal".
    vis_class: jnp.ndarray | None = None
    # A-SVGF path-space gradient state (None unless cfg.path_gradient):
    # the previous frame's raw (pre-demodulation) noisy trace luminance and
    # the camera it was traced with, so the gradient pass can re-trace the
    # exact same samples under the current light (ops/pathgrad.py).
    noisy_lum: jnp.ndarray | None = None   # (H, W)
    cam_pos: jnp.ndarray | None = None     # (3,)
    cam_rot: jnp.ndarray | None = None     # (3, 3) camera->world

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]
