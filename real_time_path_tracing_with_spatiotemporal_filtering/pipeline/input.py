"""Input controller: the reference's key bindings as a pure host-side map.

updateScene (main.cpp:1119-1168) polls GLFW keys each frame and mutates the
camera/light. Here the same bindings transform (Camera, Light) pytrees from
a set of pressed key names, so interactive frontends (or scripted motion)
share one tested semantic:

    WASD        camera x/z        (W forward = -z, main.cpp:1131-1146)
    Q / E       camera down / up  (main.cpp:1147-1154 -- E up, Q down)
    I / K       light -z / +z
    J / L       light -x / +x, wrapping at [-20, 2] (main.cpp:1149-1160)
    U / O       light down / up
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import jax.numpy as jnp
import numpy as np

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
)


def apply_keys(
    camera: Camera,
    light: Light,
    keys: Iterable[str],
    cfg: RenderConfig = RenderConfig(),
) -> tuple[Camera, Light, bool]:
    """One frame of input. Returns (camera', light', camera_moved)."""
    keys = {k.lower() for k in keys}
    speed = cfg.move_speed

    # Host-side numpy arithmetic only, results STORED as numpy: keeping a
    # device array in the pytree makes next frame's np.asarray a
    # device->host round trip every frame (pipeline stall); numpy
    # leaves ship host->device asynchronously with the frame dispatch.
    cdx = speed * (("d" in keys) - ("a" in keys))
    cdy = speed * (("e" in keys) - ("q" in keys))
    cdz = speed * (("s" in keys) - ("w" in keys))
    camera_moved = bool(cdx or cdy or cdz)
    if camera_moved:
        pos = np.asarray(camera.position) + np.array([cdx, cdy, cdz], np.float32)
        camera = dataclasses.replace(camera, position=pos)

    ldx = speed * (("l" in keys) - ("j" in keys))
    ldy = speed * (("o" in keys) - ("u" in keys))
    ldz = speed * (("k" in keys) - ("i" in keys))
    if ldx or ldy or ldz:
        pos = np.asarray(light.position) + np.array([ldx, ldy, ldz], np.float32)
        # wrap exactly like main.cpp:1151-1160: crossing +2 going right
        # teleports to -20; crossing -20 going left teleports to +2
        if ldx > 0 and pos[0] > cfg.light_x_wrap_hi:
            pos[0] = cfg.light_x_wrap_lo
        elif ldx < 0 and pos[0] < cfg.light_x_wrap_lo:
            pos[0] = cfg.light_x_wrap_hi
        light = dataclasses.replace(light, position=pos)
    return camera, light, camera_moved
