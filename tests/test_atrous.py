"""A-trous filter properties + NumPy golden oracle."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import atrous


def numpy_atrous_oracle(color, normal, depth, k, sigma_n, sigma_z, sigma_l):
    """Literal per-pixel port of waveletTransformOddIteration
    (temporalFiltering.comp.glsl:118-155)."""
    h, w, _ = color.shape
    out = np.zeros_like(color)
    for y in range(h):
        for x in range(w):
            cp, np_, dp = color[y, x], normal[y, x], depth[y, x]
            num = np.zeros(3)
            den = 0.0
            for i in (-1, 0, 1):
                for j in (-1, 0, 1):
                    qx = min(max(x + i * k, 0), w - 1)
                    qy = min(max(y + j * k, 0), h - 1)
                    cq, nq, dq = color[qy, qx], normal[qy, qx], depth[qy, qx]
                    w_n = max(0.0, float(np_ @ nq)) ** sigma_n
                    w_z = np.exp(-abs(dp - dq) / sigma_z)
                    w_l = np.exp(-np.linalg.norm(cp - cq) / sigma_l)
                    wgt = w_n * w_z * w_l / 9.0
                    num += wgt * cq
                    den += wgt
            out[y, x] = num / den
    return out


def random_inputs(rng, h=12, w=14):
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    return color, normal, depth


def test_matches_numpy_oracle(rng_np, small_cfg):
    color, normal, depth = random_inputs(rng_np)
    for k in (1, 2, 3):
        ours = np.asarray(
            atrous.atrous_iteration(
                jnp.asarray(color), jnp.asarray(normal), jnp.asarray(depth), k, small_cfg
            )
        )
        oracle = numpy_atrous_oracle(
            color, normal, depth, k,
            small_cfg.sigma_n, small_cfg.sigma_z, small_cfg.sigma_l,
        )
        np.testing.assert_allclose(ours, oracle, rtol=2e-4, atol=2e-5)


def test_constant_image_is_fixed_point(small_cfg):
    """Energy preservation: with uniform weights the box filter must leave a
    constant image unchanged (SURVEY.md section 4 property test)."""
    color = jnp.full((16, 16, 3), 0.37)
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (16, 16, 3))
    depth = jnp.full((16, 16), 0.5)
    out = atrous.atrous_filter(color, normal, depth, small_cfg)
    np.testing.assert_allclose(np.asarray(out), 0.37, rtol=1e-5)


def test_smooths_noise_on_flat_geometry(rng_np, small_cfg):
    noise = rng_np.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (32, 32, 3))
    depth = jnp.full((32, 32), 0.5)
    out = np.asarray(atrous.atrous_filter(jnp.asarray(noise), normal, depth, small_cfg))
    assert out.std() < 0.3 * noise.std()
    # mean energy approximately preserved on flat geometry
    np.testing.assert_allclose(out.mean(), noise.mean(), rtol=0.05)


def test_respects_normal_edges(small_cfg):
    """Two half-images with opposing normals must not bleed into each other
    (the normal weight is 0 across the edge: dot < 0 -> max(0,.)^128 = 0)."""
    h, w = 16, 16
    color = np.zeros((h, w, 3), np.float32)
    color[:, : w // 2] = 1.0
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2 :, 2] = -1.0
    depth = np.full((h, w), 0.5, np.float32)
    out = np.asarray(
        atrous.atrous_filter(
            jnp.asarray(color), jnp.asarray(normal), jnp.asarray(depth), small_cfg
        )
    )
    np.testing.assert_allclose(out[:, : w // 2], 1.0, atol=1e-5)
    np.testing.assert_allclose(out[:, w // 2 :], 0.0, atol=1e-5)


def test_shift_clamped_semantics():
    img = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    # shift down-right by (1, 2): out[y, x] = img[clamp(y+1), clamp(x+2)]
    out = np.asarray(atrous.shift_clamped(img, 1, 2))
    expect = np.empty((3, 4), np.float32)
    base = np.asarray(img)
    for y in range(3):
        for x in range(4):
            expect[y, x] = base[min(y + 1, 2), min(x + 2, 3)]
    np.testing.assert_array_equal(out, expect)
    out2 = np.asarray(atrous.shift_clamped(img, -2, -1))
    for y in range(3):
        for x in range(4):
            expect[y, x] = base[max(y - 2, 0), max(x - 1, 0)]
    np.testing.assert_array_equal(out2, expect)


def test_temporal_accumulate_at_blend_math():
    """EMA blend weights, fixed and gradient-driven adaptive alpha
    (temporalFiltering.comp.glsl:243-254 and the wired :246-248)."""
    import jax.numpy as jnp

    h, w = 8, 8
    filtered = jnp.full((h, w, 3), 1.0)
    prev = jnp.zeros((h, w, 3))
    own_y = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w)).astype(jnp.int32)
    own_x = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w)).astype(jnp.int32)
    lam = jnp.full((h, w), 0.5)

    cfg = dataclasses.replace(RenderConfig(width=w, height=h), adaptive_alpha=False)
    out = atrous.temporal_accumulate_at(
        filtered, prev, own_y, own_x, jnp.int32(1), lam, cfg
    )
    # fixed alpha: 0.3 * filtered + 0.7 * prev = 0.3
    np.testing.assert_allclose(np.asarray(out), 0.3, rtol=1e-6)

    cfg_a = dataclasses.replace(cfg, adaptive_alpha=True)
    out_a = atrous.temporal_accumulate_at(
        filtered, prev, own_y, own_x, jnp.int32(1), lam, cfg_a
    )
    # adaptive: alpha' = (1 - 0.5)*0.3 + 0.5 = 0.65
    np.testing.assert_allclose(np.asarray(out_a), 0.65, rtol=1e-6)

    # frame 0 skips blending entirely
    out0 = atrous.temporal_accumulate_at(
        filtered, prev, own_y, own_x, jnp.int32(0), lam, cfg
    )
    np.testing.assert_allclose(np.asarray(out0), 1.0, rtol=1e-6)

    # misaligned indices take the gather branch: prev pixel (0,0) everywhere
    py = jnp.zeros((h, w), jnp.int32)
    px = jnp.zeros((h, w), jnp.int32)
    prev2 = prev.at[0, 0].set(jnp.array([1.0, 0.0, 0.0]))
    out_g = atrous.temporal_accumulate_at(
        filtered, prev2, py, px, jnp.int32(1), lam, cfg
    )
    np.testing.assert_allclose(
        np.asarray(out_g)[3, 3], [0.3 + 0.7, 0.3, 0.3], rtol=1e-6
    )
