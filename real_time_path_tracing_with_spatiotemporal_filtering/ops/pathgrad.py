"""A-SVGF path-space temporal gradient (non-parity extension).

The reference estimates shading change by Phong-shading the same world point
under the previous and current light (temporalGradient.comp.glsl:104-171) --
an analytic DIRECT-light proxy that is dense (every pixel) but blind to
shadows, indirect bounces and anything the path tracer actually samples.
A-SVGF (Schied et al. 2018, "Gradient Estimation for Real-Time Adaptive
Temporal Filtering") instead measures the change of the *sampled estimator
itself*: re-trace a sparse subset of the previous frame's samples -- same
pixel, same camera, same PCG seed, same frame index, so the path geometry
reproduces bit-exactly -- under the CURRENT light, and compare the new
luminance against the stored previous-frame noisy luminance. Any difference
is a true path-space shading change, including moved shadows and indirect
color bleeding; when nothing changed the difference is exactly zero.

Layout follows the paper: one gradient sample per GRAD_STRATUM x GRAD_STRATUM
pixel stratum (1/9 of the rays at the default 3), chosen by a per-stratum
per-frame PCG draw; the sparse normalized gradient is box-filtered at stratum
resolution and nearest-upsampled to the full frame. The paper forward-projects
previous samples into the current frame; we equivalently BACK-project the
chosen current-frame stratum pixel with the backprojection map the filter
already computes (ops/atrous.py:backproject_pixels), which lands the gradient
directly in current-frame screen space. Where the backprojected pixel saw a
different primitive (disocclusion/cut) the gradient is zeroed -- the ramp's
visibility test owns those resets.

The result AUGMENTS the reference's Phong lambda (lam = max(phong, path))
rather than replacing it: the two signals have disjoint blind spots. The
Phong proxy is dense and exact for unshadowed direct lighting; the path
gradient sees everything the estimator sees but is 1/9-sparse, and at 1 spp
a pixel whose path never crossed the light sphere carries no direct-light
information for it to compare. Both lie in [0, 1] and both feed the same
consumers (adaptive alpha, accumulation-ramp reset).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    atrous,
    pathtrace,
    rng as rng_ops,
)

# Decorrelates the stratum-offset PCG stream from the path-tracing streams
# (seed_per_pixel folds the batch index in with a Knuth-style multiply;
# pixel seeds use batch indices 0..sample_batches-1).
_OFFSET_BATCH = np.uint32(0x9E3779B9)


def stratum_pixels(h, w, frame_idx, stratum: int, sr_offset=0, sr_rows=None):
    """Per-stratum gradient pixel for this frame.

    Returns int32 (gh, gw) arrays (gy, gx) with one pixel chosen uniformly
    inside each stratum x stratum cell (clamped at the ragged image edge).

    ``sr_offset``/``sr_rows``: compute only stratum rows [sr_offset,
    sr_offset + sr_rows) of the GLOBAL stratum grid -- the PCG draw is a
    function of the global stratum coordinates, so a row-sharded grid is
    bitwise identical to the same rows of the full one (the same property
    the sharded path trace relies on).
    """
    gh = -(-h // stratum) if sr_rows is None else sr_rows
    gw = -(-w // stratum)
    sy = (
        jnp.broadcast_to(jnp.arange(gh, dtype=jnp.int32)[:, None], (gh, gw))
        + sr_offset
    )
    sx = jnp.broadcast_to(jnp.arange(gw, dtype=jnp.int32)[None, :], (gh, gw))
    state = rng_ops.seed_per_pixel(sx, sy, frame_idx, _OFFSET_BATCH)
    state, u1 = rng_ops.pcg_step(state)
    _, u2 = rng_ops.pcg_step(state)
    s = jnp.int32(stratum)
    oy = jnp.minimum((u1 * stratum).astype(jnp.int32), s - 1)
    ox = jnp.minimum((u2 * stratum).astype(jnp.int32), s - 1)
    gy = jnp.minimum(sy * s + oy, jnp.int32(h - 1))
    gx = jnp.minimum(sx * s + ox, jnp.int32(w - 1))
    return gy, gx


def upsample_nearest(img, stratum: int, h: int, w: int):
    """(gh, gw) stratum-resolution plane -> (h, w) by pixel replication."""
    up = jnp.repeat(jnp.repeat(img, stratum, axis=0), stratum, axis=1)
    return up[:h, :w]


def retrace_lambda(
    tri_data,
    light,
    frame_idx,
    cfg,
    l_old,
    pyg,
    pxg,
    vis_here,
    vis_then,
    cam_pos_prev,
    cam_rot_prev,
):
    """The sparse normalized gradient at the chosen stratum pixels.

    Re-traces the previous frame's sample at global pixels (``pyg``,
    ``pxg``) -- same seed (frame_idx - 1), same camera, same spp/batch loop
    (trace_pixels is the one shared implementation) -- under the CURRENT
    light, and compares against the stored previous luminance ``l_old``.
    Gathers (``l_old``, ``vis_*``) are the caller's job: the single-chip
    pass indexes history planes directly; the sharded frame resolves them
    through its windowed halo exchange.
    """
    if cfg.gbuffer_primary:
        # The stored frame traced bounce 0 off the CURRENT G-buffer; the
        # previous frame's G-buffer is gone, so re-trace the full path
        # with aa_sigma=0 instead -- by the mode's contract (config.py:
        # the jitter draws still advance the PCG stream) this is
        # bit-identical to the seeded trace, keeping lambda exactly 0 on
        # static scenes.
        cfg = dataclasses.replace(cfg, aa_sigma=0.0, gbuffer_primary=False)
    rgb_new = pathtrace.trace_pixels(
        tri_data,
        cam_pos_prev,
        light,
        frame_idx - 1,
        pxg,
        pyg,
        cfg,
        rotation=cam_rot_prev,
    )
    l_new = atrous.luminance(rgb_new)

    # Normalized gradient (the paper's lambda): relative luminance change.
    diff = jnp.abs(l_new - l_old)
    denom = jnp.maximum(jnp.maximum(l_new, l_old), jnp.float32(1e-20))
    lam = jnp.minimum(diff / denom, 1.0)

    # Valid only where the backprojected pixel saw the same primitive this
    # stratum sees now (and not background): misattributed gradients would
    # otherwise leak resets across disocclusions the ramp already handles.
    valid = (vis_here == vis_then) & (vis_here > 0.0) & (frame_idx > 0)
    return jnp.where(valid, lam, 0.0)


def path_gradient_pass(
    tri_data,
    light,
    frame_idx,
    cfg,
    noisy_lum_prev,
    cam_pos_prev,
    cam_rot_prev,
    prev_y,
    prev_x,
    cur_vis,
    prev_vis,
):
    """The dense path-space lambda image (H, W) in [0, 1].

    ``noisy_lum_prev``: previous frame's raw (pre-demodulation) noisy trace
    luminance. ``cam_pos_prev``/``cam_rot_prev``: the camera the previous
    frame traced with. ``prev_y``/``prev_x``: this frame's dense
    backprojection map (atrous.backproject_pixels). ``light``: the CURRENT
    light -- the re-trace holds everything else fixed so the luminance
    difference isolates the shading change.
    """
    h, w = cur_vis.shape
    stratum = cfg.gradient_stratum
    gy, gx = stratum_pixels(h, w, frame_idx, stratum)

    # Where did this stratum's surface live last frame?
    pyg = prev_y[gy, gx]
    pxg = prev_x[gy, gx]

    lam = retrace_lambda(
        tri_data, light, frame_idx, cfg,
        noisy_lum_prev[pyg, pxg], pyg, pxg,
        cur_vis[gy, gx], prev_vis[pyg, pxg],
        cam_pos_prev, cam_rot_prev,
    )

    # Sparse-gradient reconstruction: box-filter at stratum resolution
    # (the paper runs a small a-trous over the gradient image), then
    # replicate up to full resolution.
    for _ in range(cfg.gradient_filter_iters):
        lam = box3_filter(lam)
    return upsample_nearest(lam, stratum, h, w)


def box3_filter(lam, padded=None):
    """One edge-clamped 3x3 box pass over the stratum grid.

    ``padded``: optionally the grid with a 1-row halo on each side (the
    sharded frame passes a globally-edge-clamped halo exchange);
    rows then shift within the padded slab -- bitwise identical to the
    single-chip clamp -- while columns stay locally clamped (sharding is
    rows-only).
    """
    acc = jnp.zeros_like(lam)
    n = lam.shape[0]
    for dy in (-1, 0, 1):
        rows = (
            atrous.shift_clamped(lam, dy, 0)
            if padded is None
            else padded[1 + dy : 1 + dy + n]
        )
        for dx in (-1, 0, 1):
            acc = acc + atrous.shift_clamped(rows, 0, dx)
    return acc * jnp.float32(1.0 / 9.0)
