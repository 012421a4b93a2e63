"""Per-pixel path-trace kernel (Pallas, Triton route).

The reference traces each pixel in one thread of a compute shader that owns
the whole bounce loop (raytrace.comp.glsl:200-344). This kernel keeps that
shape: one lane per pixel, blocks of ``BLOCK`` pixels, and inside each
block the sample loop, the bounce loop and the triangle loop, with the PCG
state, throughput and radiance held in registers. Per-triangle constants
come from one flat f32 table in device memory (``TRI_STRIDE`` floats per
triangle); every lane of a block reads the same row in the triangle loop,
so for Cornell-class scenes the table stays in L1/L2. The nearest hit is
the same plane-equation test as ops/intersect.py, fused into the loop, so
no (rays x triangles) plane is ever written to memory; the hit record's
attributes are gathered once per segment by the winning row.

A block leaves its bounce loop as soon as none of its lanes is alive; dead
lanes of a live block idle within their warp.

The arithmetic follows the XLA reference (ops/pathtrace.py) step by step:
same PCG stream and draw order, same quirks. Results agree with it up to
floating-point contraction: a grazing edge hit can flip when a product is
fused differently, which changes that one path (tests bound the share of
such pixels). ``gbuffer_primary`` and ``indirect_split`` are not traced
here; pipeline/frame.use_trace_kernel sends them to the XLA trace.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    rng as rng_ops,
)

# Pixels per block: one lane per pixel, one pixel per thread at 4 warps.
BLOCK = 128
NUM_WARPS = 4

# Row layout of the per-triangle table. The twelve plane constants the
# intersection loop reads come first, the hit attributes after them.
TRI_STRIDE = 32
_N, _D0, _N1, _D1, _N2, _D2 = 0, 3, 4, 7, 8, 11
_V0, _E1, _E2, _NORMAL, _ALBEDO = 12, 15, 18, 21, 24

# Layout of the f32 scalar table.
_SCAL_SIZE = 32
_CAM, _ROT, _LPOS, _LCOL, _SLOPE = 0, 3, 12, 15, 18


def pack_triangle_table(tri_data) -> jnp.ndarray:
    """(T * TRI_STRIDE,) f32 table of per-triangle constants."""
    p = tri_data.planes
    cols = [
        p.n, p.d0[:, None], p.n1, p.d1[:, None], p.n2, p.d2[:, None],
        p.v0, p.e1, p.e2, tri_data.normals, tri_data.albedo,
    ]
    table = jnp.concatenate(
        [jnp.asarray(c, jnp.float32) for c in cols], axis=1
    )
    table = jnp.pad(table, ((0, 0), (0, TRI_STRIDE - table.shape[1])))
    return table.reshape(-1)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _normalize(a, floor=None):
    n = jnp.sqrt(_dot(a, a))
    if floor is not None:
        n = jnp.maximum(n, floor)
    return tuple(c / n for c in a)


def _select(mask, a, b):
    return tuple(jnp.where(mask, x, y) for x, y in zip(a, b))


def _ray_sphere(o, d, center, radius):
    """intersect.ray_sphere on component tuples."""
    oc = tuple(x - c for x, c in zip(o, center))
    a = _dot(d, d)
    b = 2.0 * _dot(oc, d)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sqrt_d) / (2.0 * a)
    t2 = (-b + sqrt_d) / (2.0 * a)
    t = jnp.where(t1 > 0.0, t1, t2)
    hit = (disc >= 0.0) & (t > 0.0)
    return hit, jnp.where(hit, t, 0.0)


def _trace_kernel(ints_ref, scal_ref, tri_ref, r_ref, g_ref, b_ref, *,
                  cfg: RenderConfig, num_tris: int, width: int):
    f32 = jnp.float32
    t_max = f32(cfg.t_max)
    t_far = t_max * 2.0
    eps = f32(cfg.intersect_eps)
    radius = f32(cfg.light_radius)

    frame = ints_ref[0]
    row_offset = ints_ref[1]
    lin = pl.program_id(0) * BLOCK + jax.lax.broadcasted_iota(
        jnp.int32, (BLOCK,), 0
    )
    py = lin // width + row_offset
    px = lin % width

    cam = tuple(scal_ref[_CAM + i] for i in range(3))
    rot = [[scal_ref[_ROT + 3 * i + j] for j in range(3)] for i in range(3)]
    light_pos = tuple(scal_ref[_LPOS + i] for i in range(3))
    light_col = tuple(scal_ref[_LCOL + i] for i in range(3))
    slope = scal_ref[_SLOPE]
    zeros = jnp.zeros((BLOCK,), f32)

    def nearest(o, d):
        """(hit, t, prim, u, v) of the closest triangle; the loop keeps the
        first index among equal distances, like argmin."""

        def body(i, best):
            bt, bp, bu, bv = best
            base = i * TRI_STRIDE
            row = [tri_ref[base + k] for k in range(12)]
            n, d0 = row[_N:_N + 3], row[_D0]
            n1, d1 = row[_N1:_N1 + 3], row[_D1]
            n2, d2 = row[_N2:_N2 + 3], row[_D2]
            no, nd = _dot(o, n), _dot(d, n)
            n1o, n1d = _dot(o, n1), _dot(d, n1)
            n2o, n2d = _dot(o, n2), _dot(d, n2)
            safe_nd = jnp.where(jnp.abs(nd) < eps, eps, nd)
            t = (d0 - no) / safe_nd
            u = n1o + t * n1d + d1
            v = n2o + t * n2d + d2
            valid = (
                (jnp.abs(nd) >= eps) & (u >= 0.0) & (v >= 0.0)
                & (u + v <= 1.0) & (t > 0.0) & (t <= t_max)
            )
            better = valid & (t < bt)
            return (
                jnp.where(better, t, bt),
                jnp.where(better, i, bp),
                jnp.where(better, u, bu),
                jnp.where(better, v, bv),
            )

        init = (zeros + t_far, jnp.zeros((BLOCK,), jnp.int32), zeros, zeros)
        bt, bp, bu, bv = jax.lax.fori_loop(0, num_tris, body, init)
        hit = bt <= t_max
        return (
            hit,
            jnp.where(hit, bt, t_max),
            jnp.where(hit, bp, 0),
            jnp.where(hit, bu, 0.0),
            jnp.where(hit, bv, 0.0),
        )

    def attr(prim, off):
        base = prim * TRI_STRIDE + off
        return tuple(tri_ref[base + k] for k in range(3))

    def unit_sphere(state):
        state, a = rng_ops.pcg_step(state)
        state, b = rng_ops.pcg_step(state)
        theta = rng_ops.TWO_PI * a
        u = f32(2.0) * b - f32(1.0)
        r = jnp.sqrt(jnp.maximum(f32(0.0), f32(1.0) - u * u))
        return state, (r * jnp.cos(theta), r * jnp.sin(theta), u)

    def nee_sample(state, new_o, n_ff, accum, tri_hit):
        """Next-event estimation (pathtrace.bounce_step, cfg.nee)."""
        to_l = tuple(lp - x for lp, x in zip(light_pos, new_o))
        dist = jnp.sqrt(_dot(to_l, to_l))
        wc = tuple(c / jnp.maximum(dist, 1e-20) for c in to_l)
        sin_max = jnp.clip(radius / jnp.maximum(dist, 1e-20), 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_max * sin_max))
        nee_state, u1 = rng_ops.pcg_step(state)
        nee_state, u2 = rng_ops.pcg_step(nee_state)
        state = jnp.where(tri_hit, nee_state, state)
        cos_t = 1.0 - u1 * (1.0 - cos_max)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        phi = rng_ops.TWO_PI * u2
        pick = jnp.abs(wc[0]) > 0.9
        a_vec = (
            jnp.where(pick, 0.0, 1.0), jnp.where(pick, 1.0, 0.0), zeros
        )
        tang = _normalize(_cross(a_vec, wc), floor=1e-20)
        bitang = _cross(wc, tang)
        sc, ss = sin_t * jnp.cos(phi), sin_t * jnp.sin(phi)
        w_l = tuple(
            cos_t * w + sc * t + ss * b for w, t, b in zip(wc, tang, bitang)
        )
        cos_x = _dot(n_ff, w_l)
        s_hit, s_t = _ray_sphere(new_o, w_l, light_pos, radius)
        omega = rng_ops.TWO_PI * (1.0 - cos_max)
        gain = cos_x * omega * f32(1.0 / 3.14159265)
        occ_hit, occ_t, _, _, _ = nearest(new_o, w_l)
        lit = tri_hit & (cos_x > 0.0) & s_hit & (~occ_hit | (s_t < occ_t))
        bank = tuple(
            jnp.where(lit, a * lc * gain, 0.0)
            for a, lc in zip(accum, light_col)
        )
        return state, bank

    def bounce(carry):
        seg, o, d, accum, result, alive, state = carry
        rec_hit, rec_t, prim, bu, bv = nearest(o, d)
        v0, e1, e2 = attr(prim, _V0), attr(prim, _E1), attr(prim, _E2)
        hit_pos = tuple(
            p + bu * a + bv * b for p, a, b in zip(v0, e1, e2)
        )
        n_geo, albedo = attr(prim, _NORMAL), attr(prim, _ALBEDO)

        light_hit, light_t = _ray_sphere(o, d, light_pos, radius)
        if not cfg.light_through_walls or cfg.nee:
            light_hit = light_hit & (~rec_hit | (light_t < rec_t))
        is_first = seg == 0
        dim = jnp.where(is_first, f32(1.0 / cfg.first_hit_light_dim), 1.0)
        light_term = alive & light_hit
        emit = light_term & is_first if cfg.nee else light_term
        result = _select(
            emit, tuple(a * lc * dim for a, lc in zip(accum, light_col)),
            result,
        )

        tri_hit = alive & ~light_hit & rec_hit
        accum = _select(
            tri_hit, tuple(a * b for a, b in zip(accum, albedo)), accum
        )
        flip = _dot(d, n_geo) < 0.0
        n_ff = tuple(jnp.where(flip, n, -n) for n in n_geo)
        new_o = tuple(
            p + f32(cfg.ray_offset_eps) * n for p, n in zip(hit_pos, n_ff)
        )
        new_state, sphere = unit_sphere(state)
        new_d = _normalize(tuple(n + s for n, s in zip(n_ff, sphere)))
        o = _select(tri_hit, new_o, o)
        d = _select(tri_hit, new_d, d)
        state = jnp.where(tri_hit, new_state, state)

        if cfg.nee:
            state, bank = nee_sample(state, new_o, n_ff, accum, tri_hit)
            result = tuple(r + b for r, b in zip(result, bank))

        sky_term = alive & ~light_hit & ~rec_hit
        y = d[1]
        sky = tuple(
            jnp.where(y > 0.0, (1.0 - y) * 1.0 + y * c, f32(0.03))
            for c in (0.25, 0.5, 1.0)
        )
        sky_rad = tuple(a * s for a, s in zip(accum, sky))
        if cfg.nee:
            result = tuple(
                r + jnp.where(sky_term, s, 0.0)
                for r, s in zip(result, sky_rad)
            )
        else:
            result = _select(sky_term, sky_rad, result)

        if cfg.rr_start_bounce:
            gamble = tri_hit & (seg >= cfg.rr_start_bounce)
            rr_state, u = rng_ops.pcg_step(state)
            p = jnp.clip(
                jnp.maximum(jnp.maximum(accum[0], accum[1]), accum[2]),
                f32(cfg.rr_min_prob),
                f32(cfg.rr_max_prob),
            )
            state = jnp.where(gamble, rr_state, state)
            survive = ~gamble | (u < p)
            accum = _select(
                gamble & survive, tuple(a / p for a in accum), accum
            )
            tri_hit = tri_hit & survive
        return seg + 1, o, d, accum, result, tri_hit, state

    def any_alive(carry):
        seg, alive = carry[0], carry[5]
        return (seg < cfg.max_bounces) & (
            jnp.max(alive.astype(jnp.int32)) > 0
        )

    def trace(o, d, state):
        ones = (zeros + 1.0,) * 3
        carry = (
            jnp.int32(0), o, d, ones, (zeros,) * 3,
            jnp.ones((BLOCK,), jnp.bool_), state,
        )
        _, _, _, accum, result, alive, _ = jax.lax.while_loop(
            any_alive, bounce, carry
        )
        if cfg.nee or cfg.truncate_radiance:
            return result
        return _select(alive, accum, result)

    fpx = px.astype(f32) + f32(0.5)
    fpy = py.astype(f32) + f32(0.5)
    w, h = f32(cfg.width), f32(cfg.height)

    def one_sample(_, inner):
        summed, state = inner
        state, gx, gy = rng_ops.random_gaussian(state)
        fx = fpx + f32(cfg.aa_sigma) * gx
        fy = fpy + f32(cfg.aa_sigma) * gy
        u = (f32(2.0) * fx - w) / h
        v = -(f32(2.0) * fy - h) / h
        d_cam = (slope * u, slope * v, -(zeros + 1.0))
        d = _normalize(tuple(_dot(rot[i], d_cam) for i in range(3)))
        o = tuple(zeros + c for c in cam)
        color = trace(o, d, state)
        return tuple(s + c for s, c in zip(summed, color)), state

    def one_batch(batch, total):
        state = rng_ops.seed_per_pixel(px, py, frame, batch)
        summed, _ = jax.lax.fori_loop(
            0, cfg.spp, one_sample, ((zeros,) * 3, state)
        )
        return tuple(t + s / f32(cfg.spp) for t, s in zip(total, summed))

    total = jax.lax.fori_loop(0, cfg.sample_batches, one_batch, (zeros,) * 3)
    for ref, c in zip((r_ref, g_ref, b_ref), total):
        ref[...] = c / f32(cfg.sample_batches)


def path_trace_pass_pallas(tri_data, camera_pos, light, frame_idx,
                           cfg: RenderConfig, row_offset=0, rows=None,
                           rotation=None, interpret: bool = False):
    """Noisy radiance (rows, W, 3) of the pixel rows [row_offset,
    row_offset + rows) -- the kernel twin of pathtrace.path_trace_pass.

    Seeds and rays are functions of GLOBAL pixel coordinates, so a row slab
    equals the same rows of the full frame. ``interpret`` runs the kernel
    in the Pallas interpreter (CPU tests); it is never chosen implicitly.
    """
    if cfg.gbuffer_primary or cfg.indirect_split:
        raise ValueError(
            "the trace kernel does not implement gbuffer_primary or "
            "indirect_split; those configurations take the XLA trace"
        )
    h = cfg.height if rows is None else rows
    w = cfg.width
    num_pixels = h * w
    num_blocks = -(-num_pixels // BLOCK)
    num_tris = tri_data.planes.n.shape[0]
    if rotation is None:
        rotation = jnp.eye(3, dtype=jnp.float32)

    scal = jnp.concatenate([
        jnp.asarray(camera_pos, jnp.float32).reshape(3),
        jnp.asarray(rotation, jnp.float32).reshape(9),
        jnp.asarray(light.position, jnp.float32).reshape(3),
        (light.color * jnp.float32(cfg.light_intensity)).reshape(3),
        jnp.float32(jnp.tan(cfg.fov)).reshape(1),
    ])
    scal = jnp.pad(scal, (0, _SCAL_SIZE - scal.shape[0]))
    ints = jnp.stack([
        jnp.asarray(frame_idx, jnp.int32), jnp.asarray(row_offset, jnp.int32)
    ])
    plane = jax.ShapeDtypeStruct((num_blocks * BLOCK,), jnp.float32)
    out_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    r, g, b = pl.pallas_call(
        functools.partial(
            _trace_kernel, cfg=cfg, num_tris=num_tris, width=w
        ),
        out_shape=(plane, plane, plane),
        grid=(num_blocks,),
        out_specs=(out_spec, out_spec, out_spec),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="path_trace",
    )(ints, scal, pack_triangle_table(tri_data))
    return jnp.stack(
        [c[:num_pixels].reshape(h, w) for c in (r, g, b)], axis=-1
    )
