"""PCG RNG parity vs a NumPy oracle of the GLSL code (raytrace:71-92, 297)."""

import numpy as np
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.ops import rng


def glsl_pcg_oracle(state: int) -> tuple[int, float]:
    """Literal uint32 re-implementation of stepAndOutputRNGFloat."""
    state = (state * 747796405 + 1) & 0xFFFFFFFF
    shift = ((state >> 28) + 4) & 0xFFFFFFFF
    word = (((state >> shift) ^ state) * 277803737) & 0xFFFFFFFF
    word = ((word >> 22) ^ word) & 0xFFFFFFFF
    return state, np.float32(word) / np.float32(4294967295.0)


def glsl_seed_oracle(px, py, frame, batch) -> int:
    s = (px * 3266489917 + py * 668265263) & 0xFFFFFFFF
    return s ^ ((frame * 374761393) & 0xFFFFFFFF) ^ ((batch * 2654435761) & 0xFFFFFFFF)


def test_seed_matches_oracle():
    px = jnp.array([[0, 1, 999], [17, 500, 123]], jnp.int32)
    py = jnp.array([[0, 2, 799], [44, 600, 321]], jnp.int32)
    seeds = rng.seed_per_pixel(px, py, 7, 3)
    for i in range(2):
        for j in range(3):
            expect = glsl_seed_oracle(int(px[i, j]), int(py[i, j]), 7, 3)
            assert int(seeds[i, j]) == expect


def test_pcg_stream_matches_oracle():
    state = jnp.asarray(
        [glsl_seed_oracle(10, 20, 0, 0), glsl_seed_oracle(500, 300, 5, 1)],
        jnp.uint32,
    )
    oracle_states = [int(s) for s in state]
    for _ in range(32):
        state, val = rng.pcg_step(state)
        for lane in range(2):
            oracle_states[lane], expect = glsl_pcg_oracle(oracle_states[lane])
            assert int(state[lane]) == oracle_states[lane]
            assert np.float32(val[lane]) == np.float32(expect)


def test_uniform_range_and_distribution():
    state = rng.seed_per_pixel(
        jnp.arange(10000, dtype=jnp.int32),
        jnp.zeros(10000, jnp.int32),
        0,
        0,
    )
    _, vals = rng.pcg_step(state)
    vals = np.asarray(vals)
    assert vals.min() >= 0.0 and vals.max() <= 1.0
    assert abs(vals.mean() - 0.5) < 0.02


def test_gaussian_moments():
    state = rng.seed_per_pixel(
        jnp.arange(20000, dtype=jnp.int32),
        jnp.ones(20000, jnp.int32),
        3,
        0,
    )
    _, gx, gy = rng.random_gaussian(state)
    g = np.concatenate([np.asarray(gx), np.asarray(gy)])
    assert abs(g.mean()) < 0.02
    assert abs(g.std() - 1.0) < 0.02


def test_unit_sphere_is_unit_and_uniform():
    state = rng.seed_per_pixel(
        jnp.arange(20000, dtype=jnp.int32),
        jnp.full(20000, 7, jnp.int32),
        1,
        0,
    )
    _, vec = rng.random_unit_sphere(state)
    vec = np.asarray(vec)
    norms = np.linalg.norm(vec, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    # each component should average to ~0 on the sphere
    assert np.abs(vec.mean(axis=0)).max() < 0.02
