"""Primary-ray visibility pass (G-buffer).

Replaces the reference's rasterized vert/geom/frag visibility pipeline
(shaders/visibility.{vert,geom,frag}.glsl + main.cpp:1408-1461), which exists
only to produce: per-pixel triangle ID (primID+1, 0 = background), world
position, raster depth, and the per-triangle world-vertex LUT. Here we cast
one primary ray per pixel through the *same* camera model as the path tracer
(pixel center, no jitter) and read the identical outputs off the nearest-hit
record -- no rasterizer, and the G-buffer is exactly pixel-aligned with the
traced image (the reference's raster camera used a subtly different FOV,
main.cpp:483 vs raytrace.comp.glsl:300; SURVEY.md section 7 directs unifying
on the tracer's model).

The LUT itself is geometry-only and lives in TriangleData (scene/scene.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    camera as cam_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import intersect


class GBuffer(NamedTuple):
    """Per-pixel geometry channels, all (H, W[, C])."""

    visibility: jnp.ndarray  # (H, W) float32: primID + 1, 0 = background
    world_pos: jnp.ndarray   # (H, W, 3) hit position (0 for background)
    depth: jnp.ndarray       # (H, W) raster-equivalent NDC depth (1 for bg)


def visibility_pass(tri_data, camera_pos, view, proj, cfg, row_offset=0, rows=None, rotation=None) -> GBuffer:
    """Trace one center ray per pixel and assemble the G-buffer.

    ``view``/``proj`` are only used to reproduce the raster depth channel
    (clip.z/clip.w) that feeds the filter's depth edge-stopping weight
    (temporalFiltering.comp.glsl:66-69, 123).

    ``row_offset``/``rows`` support row-sharded execution under shard_map:
    the pass renders ``rows`` rows starting at global row ``row_offset``
    (pixel seeds and ray directions are functions of GLOBAL pixel coords).
    """
    h = cfg.height if rows is None else rows
    w = cfg.width
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row_offset
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    dirs = cam_ops.pixel_rays(
        px, py, cfg.width, cfg.height, cfg.fov, rotation=rotation
    )
    origins = jnp.broadcast_to(camera_pos, (h, w, 3))

    rec = intersect.nearest_hit(
        tri_data.planes, origins, dirs, t_max=cfg.t_max, eps=cfg.intersect_eps
    )
    world_pos = intersect.hit_position(tri_data.planes, rec)
    world_pos = jnp.where(rec.hit[..., None], world_pos, 0.0)

    visibility = jnp.where(rec.hit, (rec.prim + 1).astype(jnp.float32), 0.0)
    depth = jnp.where(
        rec.hit,
        cam_ops.ndc_depth(world_pos, view, proj),
        jnp.float32(1.0),  # depth attachment clear value
    )
    return GBuffer(visibility=visibility, world_pos=world_pos, depth=depth)
