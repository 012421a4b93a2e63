"""Mesh construction, halo-exchange collectives and collective byte
accounting."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

ROW_AXIS = "rows"

# Row half-window for the sharded reprojection fast path (orbit deltas
# |dy| <= 2): consecutive-frame motion moves a surface point at most a few
# rows, so the history gather only needs this many neighbor rows per side.
REPROJ_HALO_ROWS = 4


def make_mesh(n_devices: int | None = None, axis: str = ROW_AXIS) -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} available"
        )
    import numpy as np

    return Mesh(np.asarray(devices[:n_devices]), (axis,))


class CommLedger:
    """Per-frame collective byte accounting for the row-sharded frame.

    The "~100x less steady-state traffic" claim of the windowed
    halo-exchange reprojection (:func:`reproject_rows_sharded`) is turned
    into a checked invariant here: every collective in this module reports
    the bytes it moves per interior device per frame. Three static counters
    accumulate at TRACE time (collective shapes are static under jit) and
    one traced counter records what actually moved at runtime:

    - ``halo_bytes`` (static int): bytes ppermute'd per device per frame --
      all halo windows (a-trous halos + reprojection windows). This is the
      steady-state collective traffic.
    - ``reproj_halo_bytes`` (static int): the subset of ``halo_bytes``
      moved by reproject_rows_sharded's windows (the term the all-gather
      fallback replaces).
    - ``gather_fallback_bytes`` (static int): bytes each device would
      receive if every reprojection fell back to an all-gather -- the
      round-2 design's per-frame cost, and the denominator of the ratio.
    - ``gather_bytes`` (traced int32): bytes the all-gather fallback
      actually moved this frame (0 in the steady state; the full fallback
      amount on a camera cut). Returned from the jitted step when
      make_sharded_frame is built with a ledger.

    Byte counts are per INTERIOR device (edge devices have one neighbor);
    the all-gather count is receive-side: (n-1)/n of the global plane.
    """

    def __init__(self):
        self.reset_static()
        self.gather_bytes = 0

    def reset_static(self):
        self.halo_bytes = 0
        self.reproj_halo_bytes = 0
        self.gather_fallback_bytes = 0

    def _add_halo(self, x, halo: int, reproj: bool):
        nbytes = 2 * halo * math.prod(x.shape[1:]) * x.dtype.itemsize
        self.halo_bytes += nbytes
        if reproj:
            self.reproj_halo_bytes += nbytes

    def _add_gather(self, x, n: int, small):
        nbytes = (n - 1) * math.prod(x.shape) * x.dtype.itemsize
        self.gather_fallback_bytes += nbytes
        self.gather_bytes = self.gather_bytes + jnp.where(
            small, jnp.int32(0), jnp.int32(nbytes)
        )


def exchange_row_halo(
    x: jnp.ndarray, halo: int, axis_name: str = ROW_AXIS, ledger=None,
    _reproj=False,
):
    """Pad a row-sharded array with ``halo`` rows from each row-neighbor.

    Neighbor rows travel via ``ppermute``; at the global top/bottom
    the halo is edge-clamped (repeat of the boundary row), which reproduces
    the single-chip filter's pixel clamp (temporalFiltering.comp.glsl:136)
    exactly: a tap that would read global row < 0 reads row 0.

    This is the moral analogue of ring/context-parallel halo exchange in
    sequence-parallel attention (SURVEY.md section 5.7), applied to the
    pixel axis.

    Local rows must be >= halo.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if x.shape[0] < halo:
        raise ValueError(
            f"shard has {x.shape[0]} rows < halo {halo}; use fewer devices"
        )
    if ledger is not None:
        ledger._add_halo(x, halo, _reproj)
    down = [(i, i + 1) for i in range(n - 1)]   # i's bottom rows -> i+1's top halo
    up = [(i + 1, i) for i in range(n - 1)]     # i+1's top rows -> i's bottom halo
    from_above = jax.lax.ppermute(x[-halo:], axis_name, down)
    from_below = jax.lax.ppermute(x[:halo], axis_name, up)
    edge_top = jnp.repeat(x[:1], halo, axis=0)
    edge_bot = jnp.repeat(x[-1:], halo, axis=0)
    top = jnp.where(idx == 0, edge_top, from_above)
    bot = jnp.where(idx == n - 1, edge_bot, from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def reproject_rows_sharded(
    plane: jnp.ndarray,
    prev_y: jnp.ndarray,
    prev_x: jnp.ndarray,
    row_offset: jnp.ndarray,
    halo: int = REPROJ_HALO_ROWS,
    axis_name: str = ROW_AXIS,
    ledger: CommLedger | None = None,
):
    """``plane_global[prev_y, prev_x]`` for a row-sharded history plane.

    ``prev_y``/``prev_x`` are GLOBAL backprojected pixel coordinates of this
    shard's rows (ops.atrous.backproject_pixels). Instead of all-gathering
    the full-height plane every frame (the reference reads its history
    image globally, temporalFiltering.comp.glsl:250-254), exchange a
    ``halo``-row neighbor window -- consecutive-frame motion is a few rows
    at most (orbit deltas |dy| <= 2) -- and gather locally. Per frame that
    is 2*halo rows per neighbor pair instead of the whole image: ~100x less
    traffic at 1080p over 8 devices (bytes from shapes, CommLedger).

    Row deltas beyond the window (camera cuts, teleports) fall back to one
    all-gather. Both branches contain collectives, so the branch predicate
    is reduced over the mesh axis (lax.pmin) -- every device takes the same
    branch. Inside the windowed branch, an identity backprojection (static
    view) skips the gather entirely, matching the single-chip fast path
    (ops.atrous._gather_aligned).

    Results are bit-identical to gathering from the all-gathered plane
    (tests/test_sharding.py).
    """
    local_h, w = prev_y.shape
    own_y = jax.lax.broadcasted_iota(jnp.int32, (local_h, w), 0) + row_offset
    own_x = jax.lax.broadcasted_iota(jnp.int32, (local_h, w), 1)
    dy = prev_y - own_y
    small_local = jnp.all(jnp.abs(dy) <= halo).astype(jnp.int32)
    small = jax.lax.pmin(small_local, axis_name) > 0

    # The exchange itself is collective, so it runs unconditionally (both
    # cond branches must issue identical collectives per device); it is
    # cheap -- 2*halo rows per neighbor.
    padded = exchange_row_halo(plane, halo, axis_name, ledger, _reproj=True)
    if ledger is not None:
        n_dev = jax.lax.axis_size(axis_name)
        ledger._add_gather(plane, n_dev, small)

    def windowed(_):
        aligned = jnp.all((dy == 0) & (prev_x == own_x))
        local_py = jnp.clip(prev_y - row_offset + halo, 0, local_h + 2 * halo - 1)
        return jax.lax.cond(
            aligned,
            lambda: plane,
            lambda: padded[local_py, prev_x],
        )

    def fallback(_):
        full = jax.lax.all_gather(plane, axis_name, axis=0, tiled=True)
        return full[prev_y, prev_x]

    return jax.lax.cond(small, windowed, fallback, None)
