"""Stateful convenience wrapper around the pure frame function.

Plays the role of the reference's PathTracingApplication main loop
(main.cpp:179-308) minus the window: owns the scene tables, the history
pytree and the frame counter, and exposes step()/checkpointing. All actual
rendering goes through the single jitted frame function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import frame as frame_mod
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.history import (
    History,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    precompute_triangle_data,
)


class Renderer:
    """Owns scene tables + history; one step() per frame.

    The reference has no checkpoint/resume (SURVEY.md section 5.4); here the
    history pytree is trivially serializable, so save_state/load_state give
    exact mid-sequence resume for free.
    """

    def __init__(
        self,
        scene: Scene,
        cfg: RenderConfig = RenderConfig(),
        camera: Optional[Camera] = None,
        light: Optional[Light] = None,
    ) -> None:
        self.cfg = cfg
        self.scene = scene
        self.tri_data = precompute_triangle_data(scene)
        self.camera = camera if camera is not None else Camera.default()
        self.light = light if light is not None else Light.default()
        self.model = None
        self.history = frame_mod.init_history(self.tri_data, cfg)

    def step(self) -> jnp.ndarray:
        """Render one frame with the current camera/light; returns (H, W, 3)."""
        rgb, self.history = frame_mod.render_frame(
            self.tri_data, self.camera, self.light, self.history, self.cfg,
            self.model,
        )
        return rgb

    def set_model(self, model) -> None:
        """Set the per-frame (4, 4) model matrix (None = identity, skipping
        the in-graph transform). The reference's UBO model slot
        (visibility.vert.glsl:22-24); reprojection under geometry motion
        works because History.lut carries last frame's transformed
        vertices (see frame.render_frame_impl)."""
        self.model = None if model is None else np.asarray(model, np.float32)

    def render(self, num_frames: int) -> jnp.ndarray:
        """Render ``num_frames`` and return the last frame."""
        rgb = None
        for _ in range(num_frames):
            rgb = self.step()
        assert rgb is not None
        return rgb

    @property
    def frame_count(self) -> int:
        return int(self.history.frame)

    def reset(self) -> None:
        """Restart temporal history (the reference's only equivalent is
        relaunching the app; frame 0 then skips blending again)."""
        self.history = frame_mod.init_history(self.tri_data, self.cfg)

    # --- checkpoint / resume -------------------------------------------
    _STATE_VERSION = 1

    def save_state(self, path: str) -> None:
        """Serialize history + camera/light to an .npz (exact resume)."""
        leaves = jax.tree_util.tree_leaves(
            (self.history, self.camera, self.light)
        )
        np.savez(
            path,
            *[np.asarray(leaf) for leaf in leaves],
            _num_leaves=len(leaves),
            _version=self._STATE_VERSION,
        )

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            version = int(data["_version"]) if "_version" in data else 0
            if version != self._STATE_VERSION:
                raise ValueError(
                    f"checkpoint version {version} != {self._STATE_VERSION}; "
                    "re-render or migrate the state file"
                )
            n = int(data["_num_leaves"])
            leaves = [jnp.asarray(data[f"arr_{i}"]) for i in range(n)]
        cur_leaves, treedef = jax.tree_util.tree_flatten(
            (self.history, self.camera, self.light)
        )
        if len(leaves) != treedef.num_leaves:
            raise ValueError(
                "checkpoint does not match this renderer's state structure "
                f"({len(leaves)} leaves vs {treedef.num_leaves}); was it "
                "saved with a different scene/config?"
            )
        for i, (got, cur) in enumerate(zip(leaves, cur_leaves)):
            # A checkpoint from a different resolution or scene has the same
            # leaf COUNT but different leaf shapes; loading it would corrupt
            # the next step() silently (clipped gather indices under jit).
            if got.shape != cur.shape or got.dtype != cur.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} has shape {got.shape} dtype "
                    f"{got.dtype}, renderer expects {cur.shape} {cur.dtype}; "
                    "was it saved with a different scene/resolution?"
                )
        self.history, self.camera, self.light = jax.tree_util.tree_unflatten(
            treedef, leaves
        )

    # --- interaction ----------------------------------------------------
    # Host-side numpy arithmetic only, and the result is STORED as numpy:
    # storing a device array here means the next frame's move does
    # np.asarray(device_array) -- a device->host round trip EVERY frame,
    # which stalls the pipelined dispatch queue. Tiny numpy leaves transfer
    # host->device asynchronously with the dispatch.
    def move_camera(self, dx: float = 0.0, dy: float = 0.0, dz: float = 0.0):
        pos = np.asarray(self.camera.position) + np.array([dx, dy, dz], np.float32)
        self.camera = dataclasses.replace(self.camera, position=pos)

    def move_light(self, dx: float = 0.0, dy: float = 0.0, dz: float = 0.0):
        """Light translation with the reference's x wraparound
        (main.cpp:1149-1160: x > 2 wraps to -20 and vice versa)."""
        pos = np.asarray(self.light.position) + np.array([dx, dy, dz], np.float32)
        if pos[0] > self.cfg.light_x_wrap_hi:
            pos[0] = self.cfg.light_x_wrap_lo
        elif pos[0] < self.cfg.light_x_wrap_lo:
            pos[0] = self.cfg.light_x_wrap_hi
        self.light = dataclasses.replace(self.light, position=pos)
