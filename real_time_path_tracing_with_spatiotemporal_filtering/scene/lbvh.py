"""LBVH construction in pure JAX (Karras 2012 style) + batched traversal.

The reference delegates acceleration structures to the Vulkan driver
(nvvk::RaytracingBuilderKHR BLAS/TLAS, main.cpp:687-742). Here we build a
linear BVH from data-parallel primitives only, so construction is jittable
and runs on-device:

    1. Triangle centroid Morton codes (30-bit, scene-AABB normalized).
    2. ``jax.lax.sort_key_val`` orders leaves along the Z-curve. Codes are
       made unique by appending the leaf index (64-bit keys), which is
       exactly Karras's duplicate-handling trick.
    3. Internal-node topology by vmapped binary searches over common-prefix
       lengths (Karras 2012, "Maximizing Parallelism in the Construction of
       BVHs..."): every internal node covers a contiguous range of sorted
       leaves.
    4. Node AABBs via a sparse-table range-min/max query over the sorted
       leaf AABBs (contiguous ranges make RMQ exact) -- no bottom-up
       atomics, O(T log T) work, all vectorized.

Traversal here is the *reference* implementation: a lockstep stack-based
closest-hit over a batch of rays (correct on any backend; used as the
oracle and for moderate scenes). The dense brute-force intersector
(ops/intersect.py) remains the fast path for Cornell-class scenes; a
per-ray BVH traversal kernel for the GPU is future work (ROADMAP Reach 1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LBVH(NamedTuple):
    """2T-1 node tree: internal nodes [0, T-1), leaves [T-1, 2T-1).

    Node i's children are ``left[i]``/``right[i]`` (node ids). Leaf node
    T-1+k holds sorted-order leaf k, whose original triangle index is
    ``leaf_prim[k]``. ``aabb_min/max`` are (2T-1, 3).
    """

    left: jnp.ndarray       # (T-1,) int32 child node ids
    right: jnp.ndarray      # (T-1,) int32
    leaf_prim: jnp.ndarray  # (T,) int32 original triangle ids, Z-order
    aabb_min: jnp.ndarray   # (2T-1, 3)
    aabb_max: jnp.ndarray   # (2T-1, 3)

    @property
    def num_leaves(self) -> int:
        return self.leaf_prim.shape[0]


def morton_codes(centroids: jnp.ndarray) -> jnp.ndarray:
    """30-bit Morton codes of points normalized to the centroid AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    x = (centroids - lo) / jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((x * 1024.0).astype(jnp.uint32), 0, 1023)

    def expand_bits(v):
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v

    return (
        (expand_bits(q[:, 0]) << 2)
        | (expand_bits(q[:, 1]) << 1)
        | expand_bits(q[:, 2])
    )


def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.clz(x.astype(jnp.int32)).astype(jnp.int32)


def build_lbvh(triangles: jnp.ndarray) -> LBVH:
    """Build from (T, 3, 3) triangles. T must be >= 2."""
    num = triangles.shape[0]
    if num < 2:
        raise ValueError("LBVH needs at least 2 triangles")

    leaf_min = triangles.min(axis=1)
    leaf_max = triangles.max(axis=1)
    centroids = (leaf_min + leaf_max) * 0.5

    codes = morton_codes(centroids)
    order = jnp.argsort(codes)
    codes = codes[order]
    leaf_prim = order.astype(jnp.int32)
    smin = leaf_min[order]
    smax = leaf_max[order]

    # Karras duplicate handling: the conceptual key is (code << 32) | index.
    # JAX without x64 truncates uint64, so compute the common-prefix length
    # on the (code, index) pair directly: if the codes differ, clz of their
    # xor; else 32 + clz of the index xor (indices always differ).
    leaf_index = jnp.arange(num, dtype=jnp.uint32)

    def delta(i, j):
        """Common-prefix length of keys i and j; -1 outside [0, num)."""
        valid = (j >= 0) & (j < num)
        j_safe = jnp.clip(j, 0, num - 1)
        code_xor = codes[i] ^ codes[j_safe]
        idx_xor = leaf_index[i] ^ leaf_index[j_safe]
        d = jnp.where(
            code_xor == 0, 32 + _clz32(idx_xor), _clz32(code_xor)
        )
        return jnp.where(valid, d, -1)

    max_steps = 64  # covers any num <= 2**63

    def node_range(i):
        """Karras: (first, last, split) of internal node i."""
        d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
        d = jnp.where(d == 0, 1, d)
        delta_min = delta(i, i - d)

        # exponential search for the range length upper bound
        def grow(carry):
            lmax = carry
            return lmax * 2

        def grow_cond(lmax):
            return delta(i, i + lmax * d) > delta_min

        lmax = jax.lax.while_loop(grow_cond, grow, jnp.int32(2))

        # binary search the exact other end
        def shrink(step, carry):
            l, t = carry
            t = t // 2
            cond = delta(i, i + (l + t) * d) > delta_min
            return jnp.where(cond, l + t, l), t

        l, _ = jax.lax.fori_loop(
            0, max_steps, lambda s, c: shrink(s, c), (jnp.int32(0), lmax)
        )
        j = i + l * d
        first = jnp.minimum(i, j)
        last = jnp.maximum(i, j)

        # binary search the split position (highest differing bit)
        delta_node = delta(i, j)

        def split_body(step, carry):
            s, t = carry
            t = (t + 1) // 2
            cond = (s + t < l) & (delta(i, i + (s + t) * d) > delta_node)
            return jnp.where(cond, s + t, s), t

        s, _ = jax.lax.fori_loop(
            0, max_steps, split_body, (jnp.int32(0), l)
        )
        gamma = i + s * d + jnp.minimum(d, 0)
        return first, last, gamma

    idx = jnp.arange(num - 1, dtype=jnp.int32)
    first, last, gamma = jax.vmap(node_range)(idx)

    # child node ids: leaf k -> node (num-1) + k
    left = jnp.where(first == gamma, (num - 1) + gamma, gamma)
    right = jnp.where(last == gamma + 1, (num - 1) + gamma + 1, gamma + 1)

    # --- node AABBs: RMQ sparse tables over sorted leaf boxes ---
    levels = (num - 1).bit_length()  # num is a static shape
    positions = jnp.arange(num)
    min_tables = [smin]
    max_tables = [smax]
    for level in range(1, levels + 1):
        half = 1 << (level - 1)
        prev_min, prev_max = min_tables[-1], max_tables[-1]
        idx2 = jnp.minimum(positions + half, num - 1)
        min_tables.append(jnp.minimum(prev_min, prev_min[idx2]))
        max_tables.append(jnp.maximum(prev_max, prev_max[idx2]))

    def range_aabb(lo_i, hi_i):
        """AABB over sorted leaves [lo_i, hi_i] via two overlapping blocks."""
        length = hi_i - lo_i + 1
        # exact floor(log2(length)) via count-leading-zeros
        k = 31 - jax.lax.clz(length.astype(jnp.int32))
        rmin = jnp.full((3,), jnp.inf, smin.dtype)
        rmax = jnp.full((3,), -jnp.inf, smax.dtype)
        for lev in range(levels + 1):
            blk = 1 << lev
            second = jnp.clip(hi_i - blk + 1, 0, num - 1)
            m = k == lev
            cand_min = jnp.minimum(min_tables[lev][lo_i], min_tables[lev][second])
            cand_max = jnp.maximum(max_tables[lev][lo_i], max_tables[lev][second])
            rmin = jnp.where(m, cand_min, rmin)
            rmax = jnp.where(m, cand_max, rmax)
        return rmin, rmax

    internal_min, internal_max = jax.vmap(range_aabb)(first, last)
    aabb_min = jnp.concatenate([internal_min, smin], axis=0)
    aabb_max = jnp.concatenate([internal_max, smax], axis=0)

    return LBVH(
        left=left.astype(jnp.int32),
        right=right.astype(jnp.int32),
        leaf_prim=leaf_prim,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
    )


def _ray_aabb(o, inv_d, bmin, bmax, t_best):
    """Slab test: does the box intersect [0, t_best) along the ray?"""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tmin = jnp.minimum(t0, t1).max(axis=-1)
    tmax = jnp.maximum(t0, t1).min(axis=-1)
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_best)


def traverse(
    bvh: LBVH,
    planes,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_max: float = 10000.0,
    eps: float = 1e-9,
    max_stack: int = 64,
):
    """Batched stack-based closest-hit through the LBVH.

    Returns a HitRecord like ops.intersect.nearest_hit. This is the
    correctness-first formulation: every ray walks its own stack in
    lockstep (per-ray gathers of node data), so it is gather-bound; use
    the dense intersector for small scenes.
    """
    from real_time_path_tracing_with_spatiotemporal_filtering.ops.intersect import (
        HitRecord,
    )

    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    num_leaves = bvh.num_leaves
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)

    tris_n = planes.n[bvh.leaf_prim]
    tris_d0 = planes.d0[bvh.leaf_prim]
    tris_n1 = planes.n1[bvh.leaf_prim]
    tris_d1 = planes.d1[bvh.leaf_prim]
    tris_n2 = planes.n2[bvh.leaf_prim]
    tris_d2 = planes.d2[bvh.leaf_prim]

    def intersect_leaf(leaf_k, o_i, d_i):
        nd = jnp.dot(d_i, tris_n[leaf_k])
        no = jnp.dot(o_i, tris_n[leaf_k])
        safe_nd = jnp.where(jnp.abs(nd) < eps, eps, nd)
        t = (tris_d0[leaf_k] - no) / safe_nd
        u = jnp.dot(tris_n1[leaf_k], o_i + t * d_i) + tris_d1[leaf_k]
        v = jnp.dot(tris_n2[leaf_k], o_i + t * d_i) + tris_d2[leaf_k]
        ok = (
            (jnp.abs(nd) >= eps)
            & (u >= 0)
            & (v >= 0)
            & (u + v <= 1)
            & (t > 0)
            & (t <= t_max)
        )
        return ok, t, u, v

    def one_ray(o_i, d_i, inv_i):
        stack = jnp.zeros((max_stack,), jnp.int32)
        # root is node 0 (internal) unless T == 1 (disallowed by build)
        state = dict(
            sp=jnp.int32(1),
            stack=stack,
            best_t=jnp.float32(t_max),
            best_leaf=jnp.int32(-1),
            best_u=jnp.float32(0),
            best_v=jnp.float32(0),
        )

        def cond(s):
            return s["sp"] > 0

        def body(s):
            sp = s["sp"] - 1
            node = s["stack"][sp]
            s = {**s, "sp": sp}
            is_leaf = node >= (num_leaves - 1)

            def leaf_case(s):
                leaf_k = node - (num_leaves - 1)
                ok, t, u, v = intersect_leaf(leaf_k, o_i, d_i)
                better = ok & (t < s["best_t"])
                return {
                    **s,
                    "best_t": jnp.where(better, t, s["best_t"]),
                    "best_leaf": jnp.where(better, leaf_k, s["best_leaf"]),
                    "best_u": jnp.where(better, u, s["best_u"]),
                    "best_v": jnp.where(better, v, s["best_v"]),
                }

            def internal_case(s):
                l = bvh.left[node]
                r = bvh.right[node]
                hit_l = _ray_aabb(
                    o_i, inv_i, bvh.aabb_min[l], bvh.aabb_max[l], s["best_t"]
                )
                hit_r = _ray_aabb(
                    o_i, inv_i, bvh.aabb_min[r], bvh.aabb_max[r], s["best_t"]
                )
                sp = s["sp"]
                stack = s["stack"]
                stack = stack.at[sp].set(jnp.where(hit_l, l, stack[sp]))
                sp = sp + hit_l.astype(jnp.int32)
                stack = stack.at[sp].set(jnp.where(hit_r, r, stack[sp]))
                sp = sp + hit_r.astype(jnp.int32)
                return {**s, "sp": sp, "stack": stack}

            return jax.lax.cond(is_leaf, leaf_case, internal_case, s)

        out = jax.lax.while_loop(cond, body, state)
        hit = out["best_leaf"] >= 0
        prim = jnp.where(hit, bvh.leaf_prim[jnp.maximum(out["best_leaf"], 0)], 0)
        return (
            jnp.where(hit, out["best_t"], jnp.float32(t_max)),
            prim.astype(jnp.int32),
            hit,
            out["best_u"],
            out["best_v"],
        )

    t, prim, hit, u, v = jax.vmap(one_ray)(o, d, inv_d)
    return HitRecord(
        t=t.reshape(batch_shape),
        prim=prim.reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        bary_u=jnp.where(hit, u, 0.0).reshape(batch_shape),
        bary_v=jnp.where(hit, v, 0.0).reshape(batch_shape),
    )
