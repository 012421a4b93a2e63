"""Camera math: pinhole primary rays, view/projection matrices, reprojection.

The reference uses two subtly different camera models: the path tracer's
slope-tan(FOV) pinhole with a fixed -z forward (raytrace.comp.glsl:300,
314-320) and the raster pass's glm::perspective(2*FOV) (main.cpp:483, 1471).
We unify the *image-forming* camera on the tracer's model (the G-buffer must
be pixel-aligned with the traced image -- fixing a reference quirk noted in
SURVEY.md section 7) while reproducing the raster matrices exactly for the
depth channel and for worldToPixel reprojection
(temporalFiltering.comp.glsl:178-189).

Matrices are row-major: ``clip = proj @ view @ [p, 1]``.

All matrix products here run at HIGHEST precision: at default precision an
f32 matmul/einsum may run at reduced precision (TF32 on a GPU, with a
10-bit mantissa), which corrupts even a 4x4 projection matrix by ~0.1% --
enough to shift reprojections by a pixel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST
_einsum = functools.partial(jnp.einsum, precision=_HI)
_matmul = functools.partial(jnp.matmul, precision=_HI)


def pixel_rays(px, py, width, height, fov, jitter_x=None, jitter_y=None, rotation=None):
    """Ray directions for pixel coordinates (raytrace.comp.glsl:314-320).

    ``px``/``py`` float or int arrays of pixel indices (column, row). The
    sample point is the pixel center plus an optional jitter offset. Returns
    normalized (..., 3) directions in world space (camera never rotates in
    the reference: forward is -z, raytrace.comp.glsl:319; pass a (3, 3)
    camera->world ``rotation`` to orbit/look around -- extension).
    """
    fx = px.astype(jnp.float32) + jnp.float32(0.5)
    fy = py.astype(jnp.float32) + jnp.float32(0.5)
    if jitter_x is not None:
        fx = fx + jitter_x
    if jitter_y is not None:
        fy = fy + jitter_y
    w = jnp.float32(width)
    h = jnp.float32(height)
    # screenUV with y flip (raytrace.comp.glsl:315-316); both axes divide by
    # height so x carries the aspect ratio.
    u = (jnp.float32(2.0) * fx - w) / h
    v = -(jnp.float32(2.0) * fy - h) / h
    slope = jnp.float32(jnp.tan(fov))
    d = jnp.stack(
        [slope * u, slope * v, -jnp.ones_like(u)],
        axis=-1,
    )
    if rotation is not None:
        d = _einsum("ij,...j->...i", rotation, d)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def look_at(eye, center, up):
    """glm::lookAt, right-handed (used at main.cpp:1471)."""
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = center - eye
    f = f / jnp.linalg.norm(f)
    s = jnp.cross(f, up)
    s = s / jnp.linalg.norm(s)
    u = jnp.cross(s, f)
    return jnp.stack(
        [
            jnp.concatenate([s, -jnp.dot(s, eye)[None]]),
            jnp.concatenate([u, -jnp.dot(u, eye)[None]]),
            jnp.concatenate([-f, jnp.dot(f, eye)[None]]),
            jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
        ]
    )


def perspective(fovy, aspect, near, far):
    """glm::perspective, right-handed, GL depth convention (main.cpp:483).

    The reference does not define GLM_FORCE_DEPTH_ZERO_TO_ONE, so glm emits
    the OpenGL-style matrix with NDC z in [-1, 1]; Vulkan then consumes
    clip.z/clip.w directly as the depth value. We reproduce that matrix
    bit-for-bit, including the Vulkan y flip (proj[1][1] *= -1,
    main.cpp:484/1472) applied by the caller via :func:`vulkan_perspective`.
    """
    t = jnp.float32(jnp.tan(fovy / 2.0))
    return jnp.array(
        [
            [1.0 / (aspect * t), 0.0, 0.0, 0.0],
            [0.0, 1.0 / t, 0.0, 0.0],
            [0.0, 0.0, -(far + near) / (far - near), -2.0 * far * near / (far - near)],
            [0.0, 0.0, -1.0, 0.0],
        ],
        jnp.float32,
    )


def vulkan_perspective(fovy, aspect, near, far):
    """perspective() with the reference's y flip (main.cpp:1472)."""
    p = perspective(fovy, aspect, near, far)
    return p.at[1, 1].multiply(-1.0)


def camera_view(position, rotation):
    """World->camera view matrix from a camera->world basis:
    [[R^T, -R^T p], [0, 1]]. With identity rotation this equals the
    reference's translate-only lookAt (main.cpp:1471)."""
    p = jnp.asarray(position, jnp.float32)
    rt = jnp.asarray(rotation, jnp.float32).T
    top = jnp.concatenate([rt, (-_matmul(rt, p))[:, None]], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)
    return jnp.concatenate([top, bottom], axis=0)


def reference_view(camera_pos):
    """The per-frame view matrix: translate-only lookAt (main.cpp:1471).

    The reference looks at (x, y, z-6): a pure translation (the camera never
    rotates). Frame 0's *previous* matrices were built once with center
    (0, 1, 0) (main.cpp:483) -- a <=2e-4 rad divergence we deliberately drop
    (documented deviation; see tests/test_camera.py).
    """
    eye = jnp.asarray(camera_pos, jnp.float32)
    center = eye + jnp.array([0.0, 0.0, -6.0], jnp.float32)
    return look_at(eye, center, jnp.array([0.0, 1.0, 0.0], jnp.float32))


def world_to_clip(world_pos, view, proj):
    """clip = proj @ view @ [p, 1] for (..., 3) points."""
    p = jnp.concatenate(
        [world_pos, jnp.ones_like(world_pos[..., :1])], axis=-1
    )
    return _einsum("ij,...j->...i", _matmul(proj, view), p)


def world_to_pixel(world_pos, view, proj, width, height):
    """worldToPixel (temporalFiltering.comp.glsl:178-189).

    Returns float (..., 2) screen coordinates (x, y).
    """
    clip = world_to_clip(world_pos, view, proj)
    ndc = clip[..., :3] / clip[..., 3:4]
    res = jnp.array([width, height], jnp.float32)
    return (ndc[..., :2] * jnp.float32(0.5) + jnp.float32(0.5)) * res


def ndc_depth(world_pos, view, proj):
    """Raster-equivalent depth: clip.z / clip.w.

    This is exactly what the fixed-function pipeline writes into the D32
    attachment that temporalFiltering.comp.glsl:123 reads (GL-convention
    matrix through Vulkan's pass-through depth mapping).
    """
    clip = world_to_clip(world_pos, view, proj)
    return clip[..., 2] / clip[..., 3]
