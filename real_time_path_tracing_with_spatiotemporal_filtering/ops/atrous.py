"""A-trous wavelet filter with edge-stopping weights + temporal EMA.

Behavioral port of temporalFiltering.comp.glsl re-architected for XLA: the
reference runs 9 separate dispatches ping-ponging two images with per-
iteration descriptor rewrites (main.cpp:1255-1306); here the 9 iterations are
a single unrolled loop inside the frame jit -- pure dataflow, no buffers.

Per iteration k (1..9 -- note the reference uses LINEAR stride k, not the
classic 2^k, temporalFiltering.comp.glsl:135):
    3x3 taps at stride k, edge-clamped (temporalFiltering.comp.glsl:132-136)
    weight = dot(np, nq)^sigma_n            (normals, :61-63)
           * exp(-|dp - dq| / sigma_z)      (depth, :66-69)
           * exp(-||cp - cq|| / sigma_l)    (color, :72-74)
    out = sum(h w cq) / sum(h w), h = 1/9 box

After the last iteration the result is EMA-blended (alpha = 0.3 current)
against the previous frame's output, gathered at the backprojected pixel
(temporalFiltering.comp.glsl:213-263). Reference quirk kept: backprojection
barycentrics are computed against the PREVIOUS LUT vertices (:221-229),
unlike the gradient pass which uses current ones.

Each 3x3 tap is a whole-image shifted add: 9 vectorized passes over (H, W)
arrays that XLA fuses into one elementwise loop per iteration.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    camera as cam_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops.barycentric import (
    barycentric_coordinates,
)


def shift_clamped(img, dy: int, dx: int):
    """img[clamp(y+dy), clamp(x+dx)] -- the shader's pixel clamp
    (temporalFiltering.comp.glsl:136) as an edge-padded slice."""
    if dy == 0 and dx == 0:
        return img
    h, w = img.shape[0], img.shape[1]
    pad = [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    pad += [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad, mode="edge")
    y0 = max(dy, 0)
    x0 = max(dx, 0)
    return padded[y0 : y0 + h, x0 : x0 + w]


def _tap(img, j: int, i: int, k: int, halo: int):
    """Neighbor sample at offset (j*k rows, i*k cols).

    halo == 0: edge-clamped in both axes (single-chip semantics).
    halo > 0: rows are pre-padded by ``halo`` (>= k) rows top and bottom
    (globally edge-clamped halos exchanged by the caller); columns
    stay locally clamped since sharding is rows-only.
    """
    if halo == 0:
        return shift_clamped(img, j * k, i * k)
    h = img.shape[0] - 2 * halo
    rows = img[halo + j * k : halo + j * k + h]
    return shift_clamped(rows, 0, i * k)


def atrous_iteration(color, normal_img, depth, k: int, cfg, halo: int = 0):
    """One wavelet iteration at stride k (waveletTransformOddIteration,
    temporalFiltering.comp.glsl:118-155).

    With ``halo`` > 0 the inputs carry ``halo`` pre-exchanged extra rows on
    each side and the output drops them (sharded mode; see parallel/).
    """
    if halo:
        center = slice(halo, color.shape[0] - halo)
        cp, np_, dp = color[center], normal_img[center], depth[center]
    else:
        cp, np_, dp = color, normal_img, depth
    num = jnp.zeros_like(cp)
    den = jnp.zeros_like(dp)
    h_box = jnp.float32(1.0 / 9.0)
    # GLSL loops i (x offset) outer, j (y offset) inner -- same accumulation
    # order keeps fp summation comparable.
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            cq = _tap(color, j, i, k, halo)
            nq = _tap(normal_img, j, i, k, halo)
            dq = _tap(depth, j, i, k, halo)
            w_n = jnp.power(
                jnp.maximum(jnp.sum(np_ * nq, axis=-1), 0.0),
                jnp.float32(cfg.sigma_n),
            )
            w_z = jnp.exp(-jnp.abs(dp - dq) / jnp.float32(cfg.sigma_z))
            w_l = jnp.exp(
                -jnp.linalg.norm(cp - cq, axis=-1) / jnp.float32(cfg.sigma_l)
            )
            w = w_n * w_z * w_l
            num = num + (h_box * w)[..., None] * cq
            den = den + h_box * w
    # den >= h_box always (the center tap has weight 1), so no guard needed.
    return num / den[..., None]


def atrous_filter(color, normal_img, depth, cfg):
    """All cfg.wavelet_iterations iterations (strides 1..n, main.cpp:1259)."""
    out = color
    for k in range(1, cfg.wavelet_iterations + 1):
        out = atrous_iteration(out, normal_img, depth, k, cfg)
    return out


# --- variance-guided filtering (full-SVGF extension; cfg.variance_guided) --
#
# The reference's luminance weight has no variance normalization
# (temporalFiltering.comp.glsl:72-74); these functions implement the SVGF
# estimator (Schied et al. 2017, section 4) the north-star target names:
# temporally accumulated luminance moments -> per-pixel variance -> a
# stddev-normalized w_l, with the variance filtered alongside the color.

# Rec.709 luma coefficients (the SVGF paper's luminance).
_LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb):
    """(..., 3) -> (...) Rec.709 luminance."""
    return (
        jnp.float32(_LUMA[0]) * rgb[..., 0]
        + jnp.float32(_LUMA[1]) * rgb[..., 1]
        + jnp.float32(_LUMA[2]) * rgb[..., 2]
    )


def luminance_planes(r, g, b):
    """Planar-channel twin of :func:`luminance`."""
    return (
        jnp.float32(_LUMA[0]) * r
        + jnp.float32(_LUMA[1]) * g
        + jnp.float32(_LUMA[2]) * b
    )


def _box5(x, halo: int = 0):
    """5x5 edge-clamped box filter (spatial moment estimate for young
    history, SVGF section 4.2 -- the paper uses a 7x7 bilateral; a plain
    5x5 box is the deliberate cheap stand-in, documented extension).
    ``halo`` >= 2: rows pre-padded by the caller (sharded mode)."""
    shape = x[halo : x.shape[0] - halo].shape if halo else x.shape
    acc = jnp.zeros(shape, x.dtype)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            acc = acc + _tap(x, dy, dx, 1, halo)
    return acc * jnp.float32(1.0 / 25.0)


def spatial_variance(lum, halo: int = 0):
    """5x5 spatial luminance variance estimate (young-history fallback).
    With ``halo`` the input rows are pre-padded (globally exchanged) and
    the output drops them."""
    s1 = _box5(lum, halo)
    s2 = _box5(lum * lum, halo)
    return jnp.maximum(s2 - s1 * s1, 0.0)


def albedo_image(tri_data, visibility):
    """Primary-hit albedo per pixel from the visibility plane (primID+1,
    0 = background -> 1.0); used for SVGF albedo demodulation
    (cfg.demodulate_albedo) and the G-buffer-seeded primaries."""
    lut = jnp.concatenate(
        [
            jnp.ones((1, 3), jnp.float32),
            jnp.asarray(tri_data.albedo, jnp.float32),
        ]
    )
    return lut[visibility.astype(jnp.int32)]


def demod_scale(albedo, cfg):
    """Scalar demodulation factor per pixel: max(luminance(albedo), eps).

    SVGF (Schied et al. 2017 section 3) divides albedo out before
    filtering. Done per CHANNEL that explodes here: the parity albedos
    have exact-zero channels (red wall = (r, 0, 0), raytrace.comp.glsl:
    155-163), so channel-wise division turns unmodulated radiance (the
    sphere-light glow, which is added with pre-albedo throughput) into
    1/eps-scale values and re-modulation then tints it by the wall color.
    Dividing by the albedo's LUMINANCE instead normalizes the brightness
    variation (the thing the filter's w_l cares about) while preserving
    chroma exactly -- (c / s) * s round-trips bit-tight for every albedo.
    ``albedo``: (H, W, 3) stacked or a 3-tuple of planes."""
    if isinstance(albedo, tuple):
        lum = luminance_planes(*albedo)
    else:
        lum = luminance(albedo)
    return jnp.maximum(lum, jnp.float32(cfg.demod_eps))


def demodulate(color, scale):
    """color / demod_scale (broadcast over channels for stacked color)."""
    if color.ndim == scale.ndim + 1:
        scale = scale[..., None]
    return color / scale


def modulate(color, scale):
    """Inverse of :func:`demodulate`: restore display radiance."""
    if color.ndim == scale.ndim + 1:
        scale = scale[..., None]
    return color * scale


def _gather_aligned(img, prev_y, prev_x):
    """``img[prev_y, prev_x]`` with the identity-map fast path (see
    temporal_accumulate_at): a runtime lax.cond skips the expensive random
    gather when the backprojection is the identity (static view). In
    sharded mode ``img`` is the all-gathered full-height plane while the
    indices cover a local slab -- the fast path does not apply there."""
    h, w = prev_y.shape
    if img.shape[:2] != (h, w):
        return img[prev_y, prev_x]
    own_y = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    own_x = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    aligned = jnp.all((prev_y == own_y) & (prev_x == own_x))
    return jax.lax.cond(
        aligned, lambda im: im, lambda im: im[prev_y, prev_x], img
    )


def accumulate_moments(
    lum, prev_moments, prev_y, prev_x, frame_idx, cfg, var_spatial=None,
    reproj=None,
):
    """Temporal EMA of the (mu1, mu2) luminance moments at the backprojected
    pixel; ``lum`` is the current frame's luminance plane. Returns
    (new_moments (H, W, 2), variance (H, W)).

    Variance = max(0, mu2 - mu1^2) from the accumulated moments; for the
    first cfg.variance_boost_frames frames a 5x5 spatial estimate of the
    current frame's moments substitutes (not enough temporal history).
    ``var_spatial``: precomputed :func:`spatial_variance` (sharded mode
    passes a halo-exchanged one; the local default clamps at shard
    edges). ``reproj``: pre-gathered previous moments at (prev_y, prev_x)
    (sharded mode passes parallel.sharding.reproject_rows_sharded's
    result); defaults to gathering from ``prev_moments`` here."""
    m_now = jnp.stack([lum, lum * lum], axis=-1)
    if reproj is None:
        reproj = _gather_aligned(prev_moments, prev_y, prev_x)
    a = jnp.float32(cfg.moments_alpha)
    m = reproj * (1.0 - a) + m_now * a
    m = jnp.where(frame_idx > 0, m, m_now)
    var_t = jnp.maximum(m[..., 1] - m[..., 0] * m[..., 0], 0.0)
    var_s = spatial_variance(lum) if var_spatial is None else var_spatial
    var = jnp.where(frame_idx >= cfg.variance_boost_frames, var_t, var_s)
    return m, var


def normal_class(normal, vis):
    """Surface-consistency key from the quantized geometric normal
    (cfg.ramp_reset_mode == "normal").

    Exact primitive-id equality over-rejects on tessellated geometry: a
    moving camera backprojects almost every pixel onto a DIFFERENT
    sub-triangle of the same flat surface, so the ramp resets every frame
    and temporal accumulation dies. This key instead bands each normal
    component into 31 bins (~3.7 degrees) and packs them -- every
    sub-triangle of a flat surface shares the exact normal, hence the
    exact key, while differently-oriented surfaces (the disocclusion case
    the id test exists for) still differ. Same-normal disocclusions fall
    through to the temporal-gradient reset, as in the reference (which
    has no consistency test at all). Pure elementwise math on planes the
    geometry pass already produces -- no per-pixel table gathers.

    ``normal``: (H, W, 3) array or (nx, ny, nz) plane tuple; ``vis``:
    (H, W) visibility ids (primID + 1; 0 = background, which keys to the
    distinct class 0). Returns an (H, W) float32 key plane (exact: keys
    < 2^15 << 2^24)."""
    if isinstance(normal, tuple):
        nx, ny, nz = normal
    else:
        nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]

    def q(c):
        return jnp.clip(
            ((c + jnp.float32(1.0)) * jnp.float32(15.5)).astype(jnp.int32),
            0, 30,
        )

    key = (q(nx) * 31 + q(ny)) * 31 + q(nz)
    return jnp.where(
        vis > 0, (key + 1).astype(jnp.float32), jnp.float32(0.0)
    )


def accumulate_age(
    prev_age, prev_y, prev_x, lam, frame_idx, cfg, reproj=None,
    prev_vis=None, cur_vis=None, reproj_vis=None,
):
    """Per-pixel consecutive-history length N for the SVGF accumulation
    ramp (cfg.accumulation_ramp; Schied et al. 2017 section 4). N follows
    the reprojected history pixel, increments every frame, clamps at
    cfg.ramp_age_cap, and resets to 1 where history is rejected or on
    frame 0. Two rejection signals, each covering the other's blind spot:

    - the A-SVGF temporal gradient (lam > cfg.ramp_reset_lam): shading
      changes (light motion). Blind to camera cuts -- it Phong-shades the
      SAME world point under both lights, which is camera-independent.
    - visibility-id mismatch (``prev_vis``/``cur_vis``): the backprojected
      history pixel saw a DIFFERENT primitive than this pixel sees now
      (disocclusion, off-screen clip, camera cut). This is SVGF's
      G-buffer consistency test, fed by the previous visibility buffer
      the reference allocates and blits but never binds
      (main.cpp:1361-1372 vs the filter's descriptor set) -- here it
      finally earns its keep. Blind to pure shading change on the same
      surface, which the gradient covers.

    ``reproj``/``reproj_vis``: pre-gathered previous age / previous
    visibility at (prev_y, prev_x) (sharded mode passes the halo-exchanged
    gathers)."""
    if reproj is None:
        reproj = _gather_aligned(prev_age, prev_y, prev_x)
    n = jnp.minimum(reproj + 1.0, jnp.float32(cfg.ramp_age_cap))
    reset = lam > jnp.float32(cfg.ramp_reset_lam)
    if cur_vis is not None:
        if reproj_vis is None:
            reproj_vis = _gather_aligned(prev_vis, prev_y, prev_x)
        reset = reset | (reproj_vis != cur_vis)
    n = jnp.where(reset, jnp.float32(1.0), n)
    return jnp.where(frame_idx > 0, n, jnp.float32(1.0))


def ramp_alpha(age, lam, cfg):
    """Blend weight of the CURRENT frame under the accumulation ramp:
    alpha = max(ramp_alpha_min, 1/N) (fresh history replaces, deep history
    averages ~1/alpha_min frames), composed with adaptive_alpha's gradient
    blend when both are enabled. Returns (H, W, 1) for broadcasting."""
    alpha = jnp.maximum(jnp.float32(cfg.ramp_alpha_min), 1.0 / age)
    if cfg.adaptive_alpha:
        alpha = (1.0 - lam) * alpha + lam
    return alpha[..., None]


def _gauss3(x, halo: int = 0):
    """3x3 [1/4, 1/2, 1/4]^2 gaussian, edge-clamped (the variance prefilter
    of SVGF eq. 5). Direct 9-tap sum -- the same accumulation order as the
    sharded halo path, so both stay bit-equal."""
    shape = x[halo : x.shape[0] - halo].shape if halo else x.shape
    g = jnp.zeros(shape, x.dtype)
    w3 = (jnp.float32(0.25), jnp.float32(0.5), jnp.float32(0.25))
    for gy, wy in zip((-1, 0, 1), w3):
        for gx, wx in zip((-1, 0, 1), w3):
            g = g + wy * wx * _tap(x, gy, gx, 1, halo)
    return g


def atrous_iteration_var(color, var, normal_img, depth, k: int, cfg, halo: int = 0):
    """One variance-guided wavelet iteration at stride k.

    Same taps/normal/depth weights as :func:`atrous_iteration`; the
    luminance weight is |l_p - l_q| normalized by the gaussian-prefiltered
    stddev (SVGF eq. 5), and the variance is propagated through the filter
    as var' = sum(h w)^2 var_q / (sum h w)^2. ``halo`` as in
    :func:`atrous_iteration` (sharded mode row halos)."""
    if halo:
        center = slice(halo, color.shape[0] - halo)
        cp, np_, dp = color[center], normal_img[center], depth[center]
    else:
        cp, np_, dp = color, normal_img, depth
    g = _gauss3(var, halo)
    lp = luminance(cp)
    denom_l = jnp.float32(cfg.sigma_l) * jnp.sqrt(g) + jnp.float32(
        cfg.variance_eps
    )
    num = jnp.zeros_like(cp)
    vnum = jnp.zeros_like(g)
    den = jnp.zeros_like(dp)
    h_box = jnp.float32(1.0 / 9.0)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            cq = _tap(color, j, i, k, halo)
            nq = _tap(normal_img, j, i, k, halo)
            dq = _tap(depth, j, i, k, halo)
            vq = _tap(var, j, i, k, halo)
            w_n = jnp.power(
                jnp.maximum(jnp.sum(np_ * nq, axis=-1), 0.0),
                jnp.float32(cfg.sigma_n),
            )
            w_z = jnp.exp(-jnp.abs(dp - dq) / jnp.float32(cfg.sigma_z))
            w_l = jnp.exp(-jnp.abs(lp - luminance(cq)) / denom_l)
            hw = h_box * w_n * w_z * w_l
            num = num + hw[..., None] * cq
            vnum = vnum + hw * hw * vq
            den = den + hw
    return num / den[..., None], vnum / (den * den)


def atrous_filter_var(color, var, normal_img, depth, cfg):
    """All iterations of the variance-guided filter; returns (color', var')."""
    out, v = color, var
    for k in range(1, cfg.wavelet_iterations + 1):
        out, v = atrous_iteration_var(out, v, normal_img, depth, k, cfg)
    return out, v


def backproject_pixels(gbuf, lut_prev, view_prev, proj_prev, cfg, row_offset=0):
    """Previous-frame integer pixel of each surface pixel
    (temporalFiltering.comp.glsl:213-239). Background keeps its own pixel.
    Returned coordinates are GLOBAL image coordinates; ``row_offset`` maps a
    local row slab to its global rows."""
    h, w = gbuf.visibility.shape
    prim = gbuf.visibility.astype(jnp.int32)
    tri_prev = lut_prev[prim]
    v1p, v2p, v3p = (
        tri_prev[..., 0, :],
        tri_prev[..., 1, :],
        tri_prev[..., 2, :],
    )
    # Quirk: barycentrics of the CURRENT position against the PREVIOUS
    # vertices (temporalFiltering.comp.glsl:221-229).
    bary = barycentric_coordinates(gbuf.world_pos, v1p, v2p, v3p)
    world_prev = (
        bary[..., 0:1] * v1p + bary[..., 1:2] * v2p + bary[..., 2:3] * v3p
    )
    screen = cam_ops.world_to_pixel(
        world_prev, view_prev, proj_prev, cfg.width, cfg.height
    )
    # ivec2 cast truncates toward zero (GLSL int()).
    px = screen[..., 0].astype(jnp.int32)
    py = screen[..., 1].astype(jnp.int32)

    own_x = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    own_y = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row_offset
    background = gbuf.visibility < 1.0
    px = jnp.where(background, own_x, px)
    py = jnp.where(background, own_y, py)
    # The reference relies on robust image access for out-of-view gathers;
    # we clamp instead (documented deviation: border pixels during fast
    # motion read the edge texel rather than black).
    px = jnp.clip(px, 0, cfg.width - 1)
    py = jnp.clip(py, 0, cfg.height - 1)
    return py, px


def temporal_accumulate_at(
    filtered, prev_image, prev_y, prev_x, frame_idx, lam, cfg,
    reprojected=None, age=None,
):
    """EMA blend with precomputed backprojection coordinates
    (:func:`backproject_pixels`); only the image gather + blend remain.

    Static-view fast path: when the backprojection is the identity map
    (camera and geometry unchanged -- the common interactive case), the
    random gather collapses to an aligned read, chosen by a runtime
    lax.cond on the index planes.

    ``reprojected``: pre-gathered history at (prev_y, prev_x) -- sharded
    mode passes parallel.sharding.reproject_rows_sharded's result and
    ``prev_image`` is ignored.

    ``age``: the CURRENT frame's accumulated history length
    (:func:`accumulate_age`) when cfg.accumulation_ramp -- the blend then
    uses alpha = max(ramp_alpha_min, 1/N) instead of the fixed ema_alpha.
    """
    h, w = prev_y.shape
    if reprojected is not None:
        pass
    elif prev_image.shape[:2] == (h, w):
        own_y = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        own_x = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        aligned = jnp.all((prev_y == own_y) & (prev_x == own_x))
        reprojected = jax.lax.cond(
            aligned,
            lambda img: img,
            lambda img: img[prev_y, prev_x],
            prev_image,
        )
    else:
        # sharded mode: prev_image is the all-gathered full-height frame
        # while the index planes are this shard's rows; plain gather.
        reprojected = prev_image[prev_y, prev_x]
    if cfg.accumulation_ramp and age is not None:
        alpha = ramp_alpha(age, lam, cfg)
    else:
        alpha = jnp.float32(cfg.ema_alpha)
        if cfg.adaptive_alpha:
            alpha = (1.0 - lam) * alpha + lam
            alpha = alpha[..., None]
    blended = reprojected * (1.0 - alpha) + filtered * alpha
    return jnp.where(frame_idx > 0, blended, filtered)


def temporal_accumulate(
    filtered, prev_image, gbuf, lut_prev, view_prev, proj_prev, frame_idx,
    lam, cfg, row_offset=0,
):
    """EMA blend against the reprojected history
    (temporalFiltering.comp.glsl:242-263). ``lam`` drives adaptive alpha when
    cfg.adaptive_alpha (the reference's commented-out :246-248 wired up).

    ``prev_image`` is always the FULL-height previous frame (reprojection
    gathers are global); in sharded mode the caller all-gathers it and
    passes the local slab's ``row_offset``."""
    py, px = backproject_pixels(
        gbuf, lut_prev, view_prev, proj_prev, cfg, row_offset=row_offset
    )
    reprojected = prev_image[py, px]
    alpha = jnp.float32(cfg.ema_alpha)
    if cfg.adaptive_alpha:
        alpha = (1.0 - lam) * alpha + lam
        alpha = alpha[..., None]
    blended = reprojected * (1.0 - alpha) + filtered * alpha
    return jnp.where(frame_idx > 0, blended, filtered)
