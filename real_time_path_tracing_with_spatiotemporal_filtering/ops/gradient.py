"""Temporal-gradient pass: per-pixel shading-change estimate lambda.

Behavioral port of temporalGradient.comp.glsl:104-171. For every surface
pixel, the world position is reprojected to its previous-frame position via
barycentrics against the previous visibility LUT, both positions are
Phong-shaded (current light vs previous light), and
lambda = min(1, |dL| / max(|L_c|, |L_p|)) in [0, 1] measures relative change.
Background pixels get 0 (the shader zeroes its output first,
temporalGradient.comp.glsl:119,131).

Reference quirks reproduced: the *current* normal is used for both shadings
(temporalGradient.comp.glsl:161 passes ``normal``, not ``normalPrev``), and
the current camera position is used for both specular terms.
"""

from __future__ import annotations

import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import shading
from real_time_path_tracing_with_spatiotemporal_filtering.ops.barycentric import (
    barycentric_coordinates,
)


def temporal_gradient_pass(
    gbuf,
    lut,
    lut_prev,
    camera_pos,
    light_pos,
    light_pos_prev,
    light_color,
    light_color_prev,
):
    """Compute the lambda image (H, W).

    ``lut``/``lut_prev``: (T+1, 3, 3) current and previous visibility LUTs
    (slot 0 = background). ``light_color*`` are the LDR colors
    (pushConstants.currentCameraColor, NOT the x30 HDR scale).
    """
    prim = gbuf.visibility.astype(jnp.int32)  # int(primitiveID), 0 = bg
    tri = lut[prim]        # (H, W, 3, 3)
    tri_prev = lut_prev[prim]

    v1, v2, v3 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    normal = jnp.cross(v2 - v1, v3 - v1)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-20
    )
    bary = barycentric_coordinates(gbuf.world_pos, v1, v2, v3)

    v1p, v2p, v3p = tri_prev[..., 0, :], tri_prev[..., 1, :], tri_prev[..., 2, :]
    world_pos_prev = (
        bary[..., 0:1] * v1p + bary[..., 1:2] * v2p + bary[..., 2:3] * v3p
    )

    current = shading.phong(gbuf.world_pos, normal, camera_pos, light_pos, light_color)
    previous = shading.phong(
        world_pos_prev, normal, camera_pos, light_pos_prev, light_color_prev
    )

    diff = jnp.linalg.norm(current - previous, axis=-1)
    delta = jnp.maximum(
        jnp.linalg.norm(current, axis=-1), jnp.linalg.norm(previous, axis=-1)
    )
    lam = jnp.minimum(1.0, diff / jnp.maximum(delta, 1e-20))
    return jnp.where(gbuf.visibility > 0.0, lam, 0.0)
