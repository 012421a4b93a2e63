"""Multi-resolution indirect illumination (config.indirect_split).

The reference traces every bounce segment of every pixel at full
resolution (raytrace.comp.glsl:204: one thread loops all 32 segments).
Trace cost scales with the ray count, so the classic real-time
decomposition applies:
direct lighting is high-frequency (trace it per pixel), indirect
lighting is low-frequency (trace it on a subsampled grid and upsample
with G-buffer guidance).

The split is exact at coarse pixels by PCG-prefix identity: seeds and
draws are pure functions of the GLOBAL pixel coordinate and draw order
(ops/rng.py), so the first ``indirect_split`` segments of the coarse
full-length trace are bit-identical to the full-resolution truncated
trace at the same pixels. The residual

    resid = full_length(coarse px) - truncated(coarse px)

is therefore exactly the radiance carried by segments >= split -- each
term scaled by the path throughput at the truncation point. Dividing by
that throughput (emitted by the truncated trace) removes the full-res
albedo texture from the low-res signal before upsampling; re-modulating
by the full-res throughput restores it, so albedo edges stay crisp (the
same argument as SVGF's albedo demodulation, Schied et al. 2017 sec. 3).

The upsampler is a joint-bilateral 2x2 tent: bilinear weights times a
depth edge stop exp(-|dz|/sigma) and a normal edge stop max(0, n.n')^p,
guided by the (already computed) G-buffer planes. Everything is static
shifts and repeats -- no gathers.

Biased (indirect is low-passed at the stride scale) and config-gated off
for reference parity; quality impact measured in benchmarks/quality.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    pathtrace,
    rng as rng_ops,
)

# Throughput demodulation guard. Channels with |thru| below this carry a
# residual of at most thru * L_max ~ 1e-5 (the light's HDR intensity
# bounds the tail radiance), so the clamped division stays harmless.
_THRU_EPS = 1e-6

# Decorrelates the per-frame grid-phase PCG stream from the pixel streams
# (which key on pixel coordinates) and from pathgrad's stratum offsets
# (batch 0x9E3779B9).
_JITTER_BATCH = np.uint32(0x85EBCA6B)


def grid_phase(frame_idx, stride: int):
    """Per-frame coarse-grid phase (oy, ox) in [0, stride)^2
    (cfg.indirect_jitter): a deterministic PCG hash of the frame index.

    With a fixed phase the multi-res split low-passes indirect light at
    the stride scale everywhere, permanently. Rotating the phase each
    frame turns that static bias into zero-mean temporal variation: each
    pixel is an exact-residual coarse sample every ~stride^2 frames in
    expectation, and the temporal EMA downstream integrates over phases
    -- the classic interleaved-sampling argument (Keller/Heidrich 2001),
    applied to the residual grid. Bit-deterministic (pure function of the
    frame index; no wall-clock inputs)."""
    z = jnp.zeros((), jnp.int32)
    state = rng_ops.seed_per_pixel(z, z, frame_idx, _JITTER_BATCH)
    state, u1 = rng_ops.pcg_step(state)
    _, u2 = rng_ops.pcg_step(state)
    s = jnp.int32(stride)
    oy = jnp.minimum((u1 * stride).astype(jnp.int32), s - 1)
    ox = jnp.minimum((u2 * stride).astype(jnp.int32), s - 1)
    return oy, ox


def _subsample(t, s: int, phase):
    """``t[oy::s, ox::s]`` for a traced phase with a static output shape
    (requires s | H and s | W, validated by the config). Trailing axes
    (e.g. the XLA path's (H, W, 3) attribute arrays) pass through."""
    if phase is None:
        return t[::s, ::s]
    oy, ox = phase
    h, w = t.shape[0], t.shape[1]
    t4 = t.reshape((h // s, s, w // s, s) + t.shape[2:])
    t4 = jax.lax.dynamic_index_in_dim(t4, oy, axis=1, keepdims=False)
    return jax.lax.dynamic_index_in_dim(t4, ox, axis=2, keepdims=False)


def coarse_grid(height: int, width: int, stride: int):
    """Global pixel coordinates of the coarse trace grid: every
    ``stride``-th pixel starting at (0, 0). Returns (py, px), each
    (ceil(H/s), ceil(W/s)) int32 -- exactly the pixels ``img[::s, ::s]``
    selects, which is what makes the residual slice-exact."""
    hc = -(-height // stride)
    wc = -(-width // stride)
    py = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0) * stride
    px = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1) * stride
    return py, px


def _shift_next(c, axis):
    """c[i+1] along ``axis`` with edge clamp (static slices only)."""
    nxt = jax.lax.slice_in_dim(c, 1, c.shape[axis], axis=axis)
    last = jax.lax.slice_in_dim(c, c.shape[axis] - 1, c.shape[axis], axis=axis)
    return jnp.concatenate([nxt, last], axis=axis)


def _expand(c, stride, out_h, out_w, phase=None, top_row=None):
    """Nearest (hold) expansion of a coarse plane: out[y, x] =
    c[floor((y - oy) / s), floor((x - ox) / s)], with the row index -1
    resolved to ``top_row`` (default: edge clamp to c[0]; the sharded
    frame passes the previous device's last coarse row) and the column
    index -1 edge-clamped locally (columns are never sharded). Phase
    (0, 0) reduces to c[y // s, x // s]. jnp.repeat of a static count
    lowers to broadcast + reshape -- no gather; the traced phase shift is
    one static-size dynamic slice of the padded plane."""
    if stride > 1:
        if phase is not None:
            oy, ox = phase
            top = c[:1] if top_row is None else top_row
            c = jnp.concatenate([top, c], axis=0)
            c = jnp.concatenate([c[:, :1], c], axis=1)
            c = jnp.repeat(c, stride, axis=0)
            c = jnp.repeat(c, stride, axis=1)
            return jax.lax.dynamic_slice(
                c, (stride - oy, stride - ox), (out_h, out_w)
            )
        c = jnp.repeat(c, stride, axis=0)
        c = jnp.repeat(c, stride, axis=1)
    return c[:out_h, :out_w]


def _int_pow(x, p: int):
    """x**p by repeated squaring (static integer exponent)."""
    if p == 0:
        return jnp.ones_like(x)
    acc = None
    base = x
    while p:
        if p & 1:
            acc = base if acc is None else acc * base
        p >>= 1
        if p:
            base = base * base
    return acc


def bilateral_upsample(coarse_planes, guide_coarse, guide_full, cfg,
                       row_pad=None, phase=None):
    """Joint-bilateral 2x2 tent upsample of coarse planes to full res.

    ``coarse_planes``: tuple of (Hc, Wc) planes (the demodulated residual
    channels). ``guide_coarse`` / ``guide_full``: (nx, ny, nz, depth)
    plane tuples at coarse / full resolution. Returns the upsampled
    full-res plane tuple. At exact coarse pixels the nearest neighbor's
    weight is 1 and the others 0, so the coarse values pass through
    unchanged.

    ``row_pad``: optional callable c -> (Hc+2, Wc) plane padded with one
    neighbor row on each side, edge-clamped at the global top/bottom.
    Default is the local clamp pad; the row-sharded frame passes a
    1-coarse-row halo exchange (parallel.sharding.exchange_row_halo),
    which makes the sharded upsample bitwise identical to the single-chip
    one at any phase -- the top halo row is exactly the row index -1 the
    phased expansion needs. Note ``fy`` below uses the LOCAL row index
    mod stride -- valid under sharding because shard offsets are
    validated to be multiples of the stride.

    ``phase``: traced (oy, ox) coarse-grid offset (cfg.indirect_jitter).
    Pixels above/left of the first coarse sample read equal neighbor
    rows/cols (edge clamp on device 0; the true previous-device row
    elsewhere), so coarse pixels stay exact pass-throughs at any
    phase."""
    if row_pad is None:
        row_pad = lambda c: jnp.concatenate(  # noqa: E731
            [c[:1], c, c[-1:]], axis=0
        )
    s = cfg.indirect_stride
    h, w = guide_full[0].shape
    if phase is None:
        ys = jnp.arange(h, dtype=jnp.int32)
        xs = jnp.arange(w, dtype=jnp.int32)
    else:
        ys = (jnp.arange(h, dtype=jnp.int32) - phase[0]) % s
        xs = (jnp.arange(w, dtype=jnp.int32) - phase[1]) % s
    fy = ((ys % s).astype(jnp.float32) / jnp.float32(s))[:, None]
    fx = ((xs % s).astype(jnp.float32) / jnp.float32(s))[None, :]
    bilin = (
        (1.0 - fy) * (1.0 - fx),
        (1.0 - fy) * fx,
        fy * (1.0 - fx),
        fy * fx,
    )

    def four_neighbors(c):
        padded = row_pad(c)
        top = padded[0:1]
        c10 = padded[2:]
        c01 = _shift_next(c, 1)
        c11 = _shift_next(c10, 1)
        if phase is None:
            return tuple(
                _expand(v, s, h, w) for v in (c, c01, c10, c11)
            )
        # row index -1 of the base/east planes is the top halo row; for
        # the south planes it is the base plane's own first row (c10[-1]
        # = c[0] globally, on every device)
        return (
            _expand(c, s, h, w, phase, top_row=top),
            _expand(c01, s, h, w, phase, top_row=_shift_next(top, 1)),
            _expand(c10, s, h, w, phase, top_row=c[:1]),
            _expand(c11, s, h, w, phase, top_row=_shift_next(c[:1], 1)),
        )

    nxf, nyf, nzf, zf = guide_full
    guide_n = [four_neighbors(g) for g in guide_coarse]  # 4 x (4 planes)
    inv_sz = jnp.float32(1.0 / cfg.indirect_sigma_z)

    weights = []
    for k in range(4):
        ndot = (
            nxf * guide_n[0][k] + nyf * guide_n[1][k] + nzf * guide_n[2][k]
        )
        w_n = _int_pow(jnp.maximum(ndot, 0.0), cfg.indirect_normal_pow)
        w_z = jnp.exp(-jnp.abs(zf - guide_n[3][k]) * inv_sz)
        weights.append(bilin[k] * w_n * w_z)
    den = weights[0] + weights[1] + weights[2] + weights[3]
    ok = den > jnp.float32(1e-8)
    inv_den = jnp.float32(1.0) / jnp.maximum(den, jnp.float32(1e-20))

    out = []
    for c in coarse_planes:
        vals = four_neighbors(c)
        num = (
            weights[0] * vals[0]
            + weights[1] * vals[1]
            + weights[2] * vals[2]
            + weights[3] * vals[3]
        )
        # all edge stops rejected (depth/normal discontinuity on every
        # neighbor): fall back to the plain bilinear tent
        num_b = (
            bilin[0] * vals[0]
            + bilin[1] * vals[1]
            + bilin[2] * vals[2]
            + bilin[3] * vals[3]
        )
        out.append(jnp.where(ok, num * inv_den, num_b))
    return tuple(out)


def combine_planes(trunc_pl, thru_pl, full_c_pl, guide_full, cfg,
                   row_pad=None, phase=None):
    """Assemble the multi-res estimate from per-channel planes.

    trunc_pl / thru_pl: full-res (H, W) plane triples from the truncated
    trace; full_c_pl: coarse (Hc, Wc) plane triple of the full-length
    trace. Returns the (r, g, b) noisy planes. ``row_pad``: see
    :func:`bilateral_upsample` (the sharded frame's coarse-row halo).
    ``phase``: the traced (oy, ox) grid offset the coarse trace used
    (cfg.indirect_jitter)."""
    s = cfg.indirect_stride
    thru_c = tuple(_subsample(t, s, phase) for t in thru_pl)
    resid = tuple(
        (fc - _subsample(t, s, phase)) / jnp.maximum(tc, jnp.float32(_THRU_EPS))
        for fc, t, tc in zip(full_c_pl, trunc_pl, thru_c)
    )
    guide_coarse = tuple(_subsample(g, s, phase) for g in guide_full)
    up = bilateral_upsample(
        resid, guide_coarse, guide_full, cfg, row_pad=row_pad,
        phase=phase,
    )
    return tuple(t + u * th for t, u, th in zip(trunc_pl, up, thru_pl))


def _split_cfgs(cfg):
    split_cfg = dataclasses.replace(
        cfg,
        max_bounces=cfg.indirect_split,
        truncate_radiance=True,
        indirect_split=0,
        indirect_jitter=False,
    )
    tail_cfg = dataclasses.replace(
        cfg, indirect_split=0, indirect_jitter=False
    )
    return split_cfg, tail_cfg


def multires_noisy_xla(
    tri_data, camera_pos, light, frame_idx, cfg, normal_img, depth,
    rotation=None, primary=None, row_offset=0, rows=None, row_pad=None,
):
    """XLA-path multi-res noisy estimate: full-res truncated trace +
    coarse full-length trace, combined per combine_planes. ``normal_img``
    (H, W, 3) and ``depth`` (H, W) are the G-buffer guide planes.
    Returns (H, W, 3) radiance.

    ``primary``: full-res (vis, world_pos, n_geo, albedo) G-buffer
    attribute arrays (cfg.gbuffer_primary); both the truncated full-res
    trace and the coarse tail seed bounce 0 from them (the coarse trace
    subsamples them on the coarse grid, which keeps the residual
    slice-exact).

    ``row_offset``/``rows``/``row_pad``: row-sharded slab rendering
    (parallel/frame_sharded.py). ``row_offset`` must be a multiple of the
    stride (validated by make_sharded_frame), so the local coarse slab is
    exactly this shard's rows of the global coarse grid and every PCG
    draw keys on the same global pixel coordinates -- the sharded
    estimate is bitwise identical to the single-chip one."""
    split_cfg, tail_cfg = _split_cfgs(cfg)
    s = cfg.indirect_stride
    h = cfg.height if rows is None else rows
    phase = grid_phase(frame_idx, s) if cfg.indirect_jitter else None
    prim_c = None
    if primary is not None:
        prim_c = tuple(_subsample(p, s, phase) for p in primary)
    trunc, thru = pathtrace.path_trace_pass(
        tri_data, camera_pos, light, frame_idx, split_cfg,
        rotation=rotation, emit_throughput=True, primary=primary,
        row_offset=row_offset, rows=rows,
    )
    py_c, px_c = coarse_grid(h, cfg.width, cfg.indirect_stride)
    py_c = py_c + row_offset
    if phase is not None:
        py_c = py_c + phase[0]
        px_c = px_c + phase[1]
    full_c = pathtrace.trace_pixels(
        tri_data, camera_pos, light, frame_idx, px_c, py_c, tail_cfg,
        rotation=rotation, primary=prim_c,
    )
    guide_full = (
        normal_img[..., 0], normal_img[..., 1], normal_img[..., 2], depth
    )
    noisy = combine_planes(
        tuple(trunc[..., i] for i in range(3)),
        tuple(thru[..., i] for i in range(3)),
        tuple(full_c[..., i] for i in range(3)),
        guide_full,
        cfg,
        row_pad=row_pad,
        phase=phase,
    )
    return jnp.stack(noisy, axis=-1)

