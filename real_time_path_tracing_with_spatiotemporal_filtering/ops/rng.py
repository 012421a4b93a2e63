"""Counter-based per-pixel PRNG, bit-exact with the reference.

The reference seeds one PCG-style hash stream per pixel from
(pixel, frameNumber, sample_batch) and steps it sequentially along the path
(raytrace.comp.glsl:71-92, 297). We keep the identical generator so sample
sequences (and therefore rendered noise) are reproducible and comparable,
but vectorize it: the state is a uint32 array of any shape and every step
advances all lanes at once -- no cross-lane dependence, order-independent
across pixels, and the same functions run inside the per-pixel trace kernel.

All arithmetic wraps mod 2**32 exactly as in GLSL.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U = jnp.uint32

# GLSL float(word) / 4294967295.0f (raytrace.comp.glsl:77). numpy scalars,
# not device arrays: kernels that call these functions may not capture
# array constants.
_INV_U32_MAX = np.float32(1.0 / 4294967295.0)
TWO_PI = np.float32(2.0 * 3.14159265)  # k_pi (raytrace.comp.glsl:80)


def seed_per_pixel(px, py, frame, batch):
    """Per-pixel stream seed (raytrace.comp.glsl:297).

    ``px``/``py`` are integer pixel coordinates (any broadcastable shape);
    ``frame``/``batch`` integer scalars. Returns uint32 states.
    """
    px = px.astype(_U)
    py = py.astype(_U)
    frame = jnp.asarray(frame).astype(_U)
    batch = jnp.asarray(batch).astype(_U)
    s = px * _U(3266489917) + py * _U(668265263)
    return s ^ (frame * _U(374761393)) ^ (batch * _U(2654435761))


def pcg_step(state):
    """One pcg_output_rxs_m_xs_32_32 step (raytrace.comp.glsl:71-78).

    Returns (new_state, uniform float32 in [0, 1]).
    """
    state = state * _U(747796405) + _U(1)
    word = ((state >> ((state >> _U(28)) + _U(4))) ^ state) * _U(277803737)
    word = (word >> _U(22)) ^ word
    return state, word.astype(jnp.float32) * _INV_U32_MAX


def random_gaussian(state):
    """Box-Muller 2D standard normal (raytrace.comp.glsl:84-92).

    Returns (new_state, gx, gy). Draw order (u1 then u2) matches the
    reference so sequences stay aligned.
    """
    state, u1 = pcg_step(state)
    state, u2 = pcg_step(state)
    u1 = jnp.maximum(jnp.float32(1e-38), u1)
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))
    theta = TWO_PI * u2
    return state, r * jnp.cos(theta), r * jnp.sin(theta)


def random_unit_sphere(state):
    """Uniform point on the unit sphere via (theta, u) (raytrace:256-259).

    Draw order (theta first, then u) matches the reference bounce sampler.
    Returns (new_state, (..., 3) vector).
    """
    state, a = pcg_step(state)
    state, b = pcg_step(state)
    theta = TWO_PI * a
    u = jnp.float32(2.0) * b - jnp.float32(1.0)
    r = jnp.sqrt(jnp.maximum(jnp.float32(0.0), jnp.float32(1.0) - u * u))
    vec = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), u], axis=-1)
    return state, vec
