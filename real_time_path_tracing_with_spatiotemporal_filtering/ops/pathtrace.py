"""1-spp diffuse path tracer.

Behavioral re-derivation of the reference's path-trace shader
(raytrace.comp.glsl:200-344) as a vectorized bounce loop: instead of one GPU
thread looping over <=32 ray segments, every pixel's ray advances in lockstep
through a ``lax.fori_loop`` with an alive mask, and each bounce's
ray/scene query is the dense nearest-hit test (ops/intersect.py). Dead lanes
are masked, not compacted. This is the plain XLA reference; on a GPU the
frame traces with the per-pixel kernel (ops/pallas/pathtrace.py), which keeps
the reference's one-thread-per-pixel loop and is tested against this one.

Reference quirks reproduced deliberately (cfg-gated where noted):
  * the sphere light is tested against the raw ray, ignoring occluders, so
    it shines through walls (raytrace.comp.glsl:226-235; cfg.light_through_walls)
  * a first-segment light hit is dimmed by 5 ("eye safety", raytrace:229)
  * rays that survive all 32 segments return their albedo product with no
    emission (loop fall-through, raytrace:270)
  * albedo is keyed on the UNflipped geometric normal (raytrace:155-163)
  * RNG draw order: 2 Gaussians for AA jitter, then (theta, u) per diffuse
    bounce (raytrace:314, 256-257) -- bit-exact PCG streams (ops/rng.py)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    camera as cam_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    intersect,
    rng as rng_ops,
    shading,
)


def bounce_step(segment, o, d, accum, result, alive, state,
                rec_hit, rec_t, hit_pos, n_geo, albedo,
                light_pos, light_color_hdr, cfg, tri_data=None,
                defer_nee_shadow=False):
    """One bounce's light/shading/termination given the nearest-hit record.

    Pure code motion out of :func:`trace_paths`'s loop body so the same
    shading math can run on hit attributes that come from somewhere other
    than the dense intersector -- specifically the G-buffer
    (cfg.gbuffer_primary, :func:`primary_carry`). ``rec_hit``/``rec_t``/
    ``hit_pos``/``n_geo``/``albedo`` are the per-lane committed-hit
    attributes; ``tri_data`` is only required for cfg.nee (the shadow ray
    needs the scene). Returns the next (o, d, accum, result, alive, state)
    carry.

    ``defer_nee_shadow`` (cfg.nee only): skip the dense shadow-occlusion
    test and instead return the sampled shadow ray as a 7th carry element
    ``(w_l, s_t, bank, mask)`` -- direction, sphere-entry distance, the
    banked contribution if unoccluded, and the lanes that sampled -- for a
    caller that resolves occlusion itself.
    """
    light_hit, light_t = intersect.ray_sphere(
        o, d, light_pos, cfg.light_radius
    )
    if not cfg.light_through_walls or cfg.nee:
        # Non-parity modes: the light only terminates the path if it is
        # closer than the committed triangle hit. (NEE always uses the
        # occlusion-aware geometry -- its shadow rays respect walls, so
        # its termination must too.)
        light_hit = light_hit & (~rec_hit | (light_t < rec_t))

    # --- light termination (checked first, raytrace.comp.glsl:226-235)
    is_first = segment == 0
    dim = jnp.where(is_first, 1.0 / cfg.first_hit_light_dim, 1.0)
    light_term = alive & light_hit
    if cfg.nee:
        # The sphere still blocks-and-terminates (it is a blocker in
        # the reference's transport), but only the camera segment adds
        # its emission: deeper crossings were already accounted by the
        # previous vertex's NEE shadow ray.
        emit = light_term & is_first
    else:
        emit = light_term
    result = jnp.where(
        emit[..., None], accum * light_color_hdr * dim, result
    )

    # --- triangle bounce (raytrace.comp.glsl:238-262)
    tri_hit = alive & ~light_hit & rec_hit
    accum = jnp.where(tri_hit[..., None], accum * albedo, accum)
    n_ff = shading.faceforward(n_geo, d)
    new_o = hit_pos + cfg.ray_offset_eps * n_ff
    new_state, sphere_vec = rng_ops.random_unit_sphere(state)
    new_d = n_ff + sphere_vec
    new_d = new_d / jnp.linalg.norm(new_d, axis=-1, keepdims=True)
    o = jnp.where(tri_hit[..., None], new_o, o)
    d = jnp.where(tri_hit[..., None], new_d, d)
    # Only lanes that actually bounced consumed randoms (raytrace:256-257).
    state = jnp.where(tri_hit, new_state, state)

    if cfg.nee:
        # --- next-event estimation (non-parity; cfg.nee) ---
        # Sample the sphere light's solid-angle cone from the offset
        # hit point, shadow-test, and bank the direct contribution:
        #   f = albedo/pi (already folded into accum), pdf = 1/Omega
        #   -> accum * L_e * cos_x * Omega / pi.
        # The two cone draws come AFTER the bounce draws so the path
        # trajectory is identical to the parity estimator's.
        to_l = light_pos - new_o
        dist = jnp.linalg.norm(to_l, axis=-1)
        wc = to_l / jnp.maximum(dist, 1e-20)[..., None]
        sin_max = jnp.clip(
            jnp.float32(cfg.light_radius) / jnp.maximum(dist, 1e-20),
            0.0,
            1.0,
        )
        cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_max * sin_max))
        nee_state, u1 = rng_ops.pcg_step(state)
        nee_state, u2 = rng_ops.pcg_step(nee_state)
        state = jnp.where(tri_hit, nee_state, state)
        cos_t = 1.0 - u1 * (1.0 - cos_max)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        phi = rng_ops.TWO_PI * u2
        # branchless orthonormal basis around wc
        pick = jnp.abs(wc[..., 0]) > 0.9
        a_vec = jnp.where(
            pick[..., None],
            jnp.array([0.0, 1.0, 0.0], jnp.float32),
            jnp.array([1.0, 0.0, 0.0], jnp.float32),
        )
        tang = jnp.cross(a_vec, wc)
        tang = tang / jnp.maximum(
            jnp.linalg.norm(tang, axis=-1, keepdims=True), 1e-20
        )
        bitang = jnp.cross(wc, tang)
        w_l = (
            cos_t[..., None] * wc
            + (sin_t * jnp.cos(phi))[..., None] * tang
            + (sin_t * jnp.sin(phi))[..., None] * bitang
        )
        cos_x = jnp.sum(n_ff * w_l, axis=-1)
        s_hit, s_t = intersect.ray_sphere(
            new_o, w_l, light_pos, cfg.light_radius
        )
        omega = rng_ops.TWO_PI * (1.0 - cos_max)
        gain = cos_x * omega * jnp.float32(1.0 / 3.14159265)
        if defer_nee_shadow:
            nee_mask = tri_hit & (cos_x > 0.0) & s_hit
            nee_bank = jnp.where(
                nee_mask[..., None],
                accum * light_color_hdr * gain[..., None],
                0.0,
            )
            nee_info = (w_l, s_t, nee_bank, nee_mask)
        else:
            rec_s = intersect.nearest_hit(
                tri_data.planes, new_o, w_l, t_max=cfg.t_max,
                eps=cfg.intersect_eps,
            )
            lit = (
                tri_hit
                & (cos_x > 0.0)
                & s_hit
                & (~rec_s.hit | (s_t < rec_s.t))
            )
            result = result + jnp.where(
                lit[..., None],
                accum * light_color_hdr * gain[..., None],
                0.0,
            )

    # --- sky termination (raytrace.comp.glsl:263-268)
    sky_term = alive & ~light_hit & ~rec_hit
    if cfg.nee:
        # result may already hold banked NEE sums: add, don't replace
        # (identical when zero, which is the parity-mode invariant).
        result = result + jnp.where(
            sky_term[..., None], accum * shading.sky_color(d), 0.0
        )
    else:
        result = jnp.where(
            sky_term[..., None], accum * shading.sky_color(d), result
        )

    if cfg.rr_start_bounce:
        # --- Russian roulette (non-parity; cfg.rr_start_bounce) ---
        # One extra uniform per bounced lane once segment >= start;
        # survivors' throughput is divided by p (unbiased estimator).
        # Killed lanes keep result as-is (their paths carried no
        # emission) and do NOT take the fall-through below.
        gamble = tri_hit & (segment >= cfg.rr_start_bounce)
        rr_state, u = rng_ops.pcg_step(state)
        p = jnp.clip(
            jnp.max(accum, axis=-1),
            jnp.float32(cfg.rr_min_prob),
            jnp.float32(cfg.rr_max_prob),
        )
        state = jnp.where(gamble, rr_state, state)
        survive = ~gamble | (u < p)
        accum = jnp.where(
            (gamble & survive)[..., None], accum / p[..., None], accum
        )
        tri_hit = tri_hit & survive

    alive = tri_hit
    if cfg.nee and defer_nee_shadow:
        return o, d, accum, result, alive, state, nee_info
    return o, d, accum, result, alive, state


def trace_paths(tri_data, light_pos, light_color_hdr, origins, dirs, rng_state, cfg,
                emit_throughput=False, start_segment=0, initial_carry=None):
    """Trace one path per lane to termination.

    ``origins``/``dirs``: (..., 3); ``rng_state``: (...,) uint32 (already
    advanced past the AA jitter draws). ``light_color_hdr`` is the HDR light
    color (base * cfg.light_intensity, raytrace.comp.glsl:281). Returns the
    per-lane radiance (..., 3); with ``emit_throughput`` also the
    truncation-point path throughput (accum for lanes still alive after
    max_bounces, zero for terminated lanes) -- the multi-res indirect
    residual demodulator (ops/multires.py).

    ``start_segment``/``initial_carry``: resume the bounce loop from a
    precomputed carry (cfg.gbuffer_primary: bounce 0 is replayed off the
    G-buffer by :func:`primary_carry`, so the loop starts at segment 1 and
    never runs the dense segment-0 intersection).
    """

    def body(segment, carry):
        o, d, accum, result, alive, state = carry
        rec = intersect.nearest_hit(
            tri_data.planes, o, d, t_max=cfg.t_max, eps=cfg.intersect_eps
        )
        n_geo = tri_data.normals[rec.prim]              # unflipped (T,3) gather
        albedo = tri_data.albedo[rec.prim]
        hit_pos = intersect.hit_position(tri_data.planes, rec)
        return bounce_step(
            segment, o, d, accum, result, alive, state,
            rec.hit, rec.t, hit_pos, n_geo, albedo,
            light_pos, light_color_hdr, cfg, tri_data=tri_data,
        )

    if initial_carry is None:
        carry0 = (
            origins,
            dirs,
            jnp.ones(origins.shape, jnp.float32),
            jnp.zeros(origins.shape, jnp.float32),
            jnp.ones(origins.shape[:-1], bool),
            rng_state,
        )
    else:
        carry0 = initial_carry
    o, d, accum, result, alive, _ = jax.lax.fori_loop(
        start_segment, cfg.max_bounces, body, carry0
    )
    # Loop fall-through: surviving paths return the bare albedo product
    # (raytrace.comp.glsl:270). With NEE the result accumulates along the
    # path instead, so survivors keep their banked direct light and the
    # quirk is dropped; truncate_radiance drops it too (survivors return
    # only what they banked -- see config.py).
    if cfg.nee or cfg.truncate_radiance:
        out = result
    else:
        out = jnp.where(alive[..., None], accum, result)
    if emit_throughput:
        return out, jnp.where(alive[..., None], accum, jnp.zeros_like(accum))
    return out


def primary_carry(origins, dirs, state, vis, world_pos, n_geo, albedo,
                  light_pos, light_color_hdr, cfg, tri_data=None,
                  defer_nee_shadow=False):
    """Bounce-0 carry from G-buffer attributes (cfg.gbuffer_primary).

    The visibility pass already ray-traced primary visibility with the
    tracer's own camera model (ops/gbuffer.py), so the first path segment's
    nearest-hit is a lookup, not a traversal: ``vis`` (primID + 1, 0 =
    background), ``world_pos`` the hit position, ``n_geo`` the unflipped
    triangle normal, ``albedo`` the hit albedo (values at miss lanes are
    ignored). ``state`` must already be advanced past the AA jitter draws
    and ``dirs`` must be the CENTER rays (this mode disables primary AA
    jitter -- raster-G-buffer semantics; the result is bit-identical to a
    full trace with cfg.aa_sigma = 0). rec.t is reconstructed as
    dot(world_pos - o, d) (d unit), which only feeds the light-ordering
    test of non-parity modes (light_through_walls=False) and can differ
    from the intersector's t in the last ulp.

    Returns the (o, d, accum, result, alive, state) carry after bounce 0,
    to be fed to :func:`trace_paths` with start_segment=1.

    With cfg.nee the bounce-0 vertex samples the light like every other
    vertex: pass ``tri_data`` for the dense shadow-occlusion test (the
    XLA path) or ``defer_nee_shadow=True`` to get the sampled shadow ray
    back as a 7th carry element for a streamed occlusion walk (the
    wavefront path) -- see :func:`bounce_step`.
    """
    rec_hit = vis > 0
    rec_t = jnp.sum((world_pos - origins) * dirs, axis=-1)
    return bounce_step(
        0, origins, dirs,
        jnp.ones(origins.shape, jnp.float32),
        jnp.zeros(origins.shape, jnp.float32),
        jnp.ones(origins.shape[:-1], bool),
        state,
        rec_hit, rec_t, world_pos, n_geo, albedo,
        light_pos, light_color_hdr, cfg, tri_data=tri_data,
        defer_nee_shadow=defer_nee_shadow,
    )


def trace_pixels(tri_data, camera_pos, light, frame_idx, px, py, cfg, rotation=None,
                 emit_throughput=False, primary=None):
    """Per-pixel seeds, AA jitter, spp loop, average
    (raytrace.comp.glsl:273-344) for EXPLICIT pixel-coordinate arrays.

    ``px``/``py``: int32 GLOBAL pixel coordinates of any (matching) shape;
    the output radiance has shape ``px.shape + (3,)``. Because seeds and
    rays are pure functions of the global coordinates, tracing any subset
    of pixels is bitwise identical to the same pixels of a full-frame
    trace -- the property both the sharded row slabs and the A-SVGF
    path-space gradient re-trace (ops/pathgrad.py) rely on.

    ``emit_throughput``: also return the spp-averaged truncation-point
    throughput (see trace_paths).

    ``primary``: (vis, world_pos, n_geo, albedo) G-buffer attribute arrays
    aligned with ``px``/``py`` (cfg.gbuffer_primary): bounce 0 is replayed
    off them via :func:`primary_carry` instead of intersecting the scene,
    and primary AA jitter is disabled (the jitter draws still advance the
    PCG stream, so the result is bit-identical to a full trace with
    cfg.aa_sigma = 0).
    """
    light_color_hdr = light.color * jnp.float32(cfg.light_intensity)
    shape = px.shape
    zero_img = jnp.zeros(shape + (3,), jnp.float32)

    def one_batch(batch_idx, acc):
        state = rng_ops.seed_per_pixel(px, py, frame_idx, batch_idx)

        def one_sample(_, inner):
            acc_s, thru_s, state_s = inner
            state_s, gx, gy = rng_ops.random_gaussian(state_s)
            zero_j = jnp.float32(0.0) if primary is not None else None
            dirs = cam_ops.pixel_rays(
                px,
                py,
                cfg.width,
                cfg.height,
                cfg.fov,
                jitter_x=(jnp.float32(cfg.aa_sigma) * gx
                          if primary is None else zero_j * gx),
                jitter_y=(jnp.float32(cfg.aa_sigma) * gy
                          if primary is None else zero_j * gy),
                rotation=rotation,
            )
            origins = jnp.broadcast_to(camera_pos, shape + (3,))
            if primary is not None:
                vis, world_pos, n_geo, albedo = primary
                carry = primary_carry(
                    origins, dirs, state_s, vis, world_pos, n_geo, albedo,
                    light.position, light_color_hdr, cfg, tri_data=tri_data,
                )
                traced = trace_paths(
                    tri_data, light.position, light_color_hdr, origins,
                    dirs, state_s, cfg, emit_throughput=emit_throughput,
                    start_segment=1, initial_carry=carry,
                )
            else:
                traced = trace_paths(
                    tri_data, light.position, light_color_hdr, origins, dirs,
                    state_s, cfg, emit_throughput=emit_throughput,
                )
            if emit_throughput:
                color, thru = traced
                thru_s = thru_s + thru
            else:
                color = traced
            # GLSL passes rngState by value into the path loop
            # (raytrace.comp.glsl:200): the next sample continues from the
            # post-jitter state, exactly as reproduced here.
            return acc_s + color, thru_s, state_s

        summed, thru_sum, _ = jax.lax.fori_loop(
            0, cfg.spp, one_sample, (zero_img, zero_img, state)
        )
        spp_f = jnp.float32(cfg.spp)
        return acc[0] + summed / spp_f, acc[1] + thru_sum / spp_f

    total, thru_total = jax.lax.fori_loop(
        0, cfg.sample_batches, one_batch, (zero_img, zero_img)
    )
    batches_f = jnp.float32(cfg.sample_batches)
    if emit_throughput:
        return total / batches_f, thru_total / batches_f
    return total / batches_f


def path_trace_pass(tri_data, camera_pos, light, frame_idx, cfg, row_offset=0, rows=None, rotation=None, emit_throughput=False, primary=None):
    """Full path-trace pass over the pixel grid: :func:`trace_pixels` at
    every (row_offset.., 0..W) coordinate. Returns the noisy radiance
    (H, W, 3) (plus the (H, W, 3) truncation-point throughput when
    ``emit_throughput``).

    ``row_offset``/``rows``: render a row slab for sharded execution; seeds
    and rays are functions of GLOBAL pixel coordinates, so a sharded render
    is bitwise identical to the single-chip one.
    """
    h = cfg.height if rows is None else rows
    w = cfg.width
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row_offset
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return trace_pixels(
        tri_data, camera_pos, light, frame_idx, px, py, cfg, rotation=rotation,
        emit_throughput=emit_throughput, primary=primary,
    )
