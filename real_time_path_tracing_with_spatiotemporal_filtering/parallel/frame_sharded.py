"""Row-sharded frame function: the full pipeline under shard_map.

Design (SURVEY.md sections 2, 5.7-5.8): the pixel grid's rows are sharded
across a 1-D mesh. G-buffer, gradient and path tracing are embarrassingly
parallel per pixel with the (tiny) scene replicated -- zero communication.
The a-trous filter at stride k needs a k-row halo per side per iteration,
exchanged with neighbor shards (ppermute). Temporal reprojection
reads previous-frame pixels, but consecutive-frame motion is bounded (a
few rows), so the history gathers also resolve through a small ppermute
row-halo exchange (sharding.reproject_rows_sharded); only motion beyond
the window (camera cuts) falls back to an all-gather, decided uniformly
across the mesh. Everything stays sharded in the steady state.

Because pixel seeds, ray directions and filter taps are all functions of
GLOBAL pixel coordinates, the sharded render is numerically identical to
the single-chip one (tested on a virtual CPU mesh, tests/test_sharding.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    atrous,
    gbuffer,
    gradient,
)
from real_time_path_tracing_with_spatiotemporal_filtering.parallel.sharding import (
    ROW_AXIS,
    exchange_row_halo,
    reproject_rows_sharded,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.frame import (
    camera_matrices,
    init_history,
    noisy_trace,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.history import (
    History,
)


def _history_spec(
    axis: str,
    variance_guided: bool = False,
    accumulation_ramp: bool = False,
    path_gradient: bool = False,
    normal_reset: bool = False,
) -> History:
    """PartitionSpec pytree for History: image planes row-sharded, scene/
    camera state replicated."""
    return History(
        image=P(axis),
        visibility=P(axis),
        lut=P(),
        view=P(),
        proj=P(),
        light_pos=P(),
        light_color=P(),
        frame=P(),
        moments=P(axis) if variance_guided else None,
        age=P(axis) if accumulation_ramp else None,
        vis_class=P(axis) if accumulation_ramp and normal_reset else None,
        noisy_lum=P(axis) if path_gradient else None,
        cam_pos=P() if path_gradient else None,
        cam_rot=P() if path_gradient else None,
    )


def _path_gradient_shard(
    tri_data, light, frame_idx, cfg, history_local, py, px, visibility,
    reproj_vis, row_offset, local_h, axis, ledger=None,
):
    """This shard's rows of the A-SVGF path-space gradient (ops/pathgrad.py).

    The stratum grid is global and stratum_pixels draws from global stratum
    coordinates, so each shard computes exactly its own stratum rows
    (make_sharded_frame validates local_h % gradient_stratum == 0) and the
    result is bitwise identical to the single-chip pass. The two history
    gathers (previous luminance, previous visibility) resolve through the
    same windowed halo exchange as the color history; the re-trace itself
    is local compute (rays are pure functions of global pixel coords). The
    stratum-resolution box filter exchanges a 1-stratum-row halo per pass.
    """
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        pathgrad,
    )

    s = cfg.gradient_stratum
    w = cfg.width
    sr_rows = local_h // s
    gy, gx = pathgrad.stratum_pixels(
        cfg.height, w, frame_idx, s,
        sr_offset=row_offset // s, sr_rows=sr_rows,
    )
    gy_loc = gy - row_offset
    pyg = py[gy_loc, gx]
    pxg = px[gy_loc, gx]
    reproj_lum = reproject_rows_sharded(
        history_local.noisy_lum, py, px, row_offset, axis_name=axis,
        ledger=ledger,
    )
    lam = pathgrad.retrace_lambda(
        tri_data, light, frame_idx, cfg,
        reproj_lum[gy_loc, gx], pyg, pxg,
        visibility[gy_loc, gx], reproj_vis[gy_loc, gx],
        history_local.cam_pos, history_local.cam_rot,
    )
    for _ in range(cfg.gradient_filter_iters):
        lam = pathgrad.box3_filter(
            lam, exchange_row_halo(lam, 1, axis, ledger)
        )
    return pathgrad.upsample_nearest(lam, s, local_h, w)


def _frame_shard(
    tri_data, camera, light, history_local, cfg: RenderConfig, axis: str,
    ledger=None,
):
    """Per-device slab of the frame. ``history_local`` carries this shard's
    rows of image/visibility and replicated everything-else.

    The per-pixel passes are the single-chip ones at a traced
    ``row_offset``, and the noisy trace takes the same route
    (frame.noisy_trace); the a-trous halo exchange and the reprojection
    gathers are collectives around them.
    """
    if ledger is not None:
        # fresh counts per trace (jit retraces reuse the ledger instance)
        ledger.reset_static()
        ledger.gather_bytes = 0

    n = jax.lax.axis_size(axis)
    local_h = cfg.height // n
    row_offset = jax.lax.axis_index(axis) * local_h

    frame_idx = history_local.frame
    view, proj = camera_matrices(camera, cfg)
    lut = tri_data.lut

    gbuf = gbuffer.visibility_pass(
        tri_data, camera.position, view, proj, cfg,
        row_offset=row_offset, rows=local_h, rotation=camera.rotation,
    )
    visibility = gbuf.visibility
    depth = gbuf.depth
    normal_img = tri_data.lut_normals[gbuf.visibility.astype(jnp.int32)]
    lam = gradient.temporal_gradient_pass(
        gbuf, lut, history_local.lut, camera.position,
        light.position, history_local.light_pos,
        light.color, history_local.light_color,
    )
    primary = None
    if cfg.gbuffer_primary:
        primary = (
            gbuf.visibility,
            gbuf.world_pos,
            normal_img,
            atrous.albedo_image(tri_data, gbuf.visibility),
        )
    noisy = noisy_trace(
        tri_data, camera, light, frame_idx, cfg, normal_img, depth,
        primary=primary, row_offset=row_offset, rows=local_h,
        row_pad=lambda c: exchange_row_halo(c, 1, axis, ledger),
    )

    # Raw (pre-demodulation) trace luminance for next frame's gradient
    # re-trace (single-chip ordering: frame.py computes it before demod).
    noisy_lum = atrous.luminance(noisy) if cfg.path_gradient else None
    if cfg.firefly_clamp:
        noisy = jnp.minimum(noisy, jnp.float32(cfg.firefly_clamp))

    if cfg.demodulate_albedo:
        # SVGF albedo demodulation (config.py): per-pixel, so the sharded
        # path is identical to single-chip -- no communication
        demod_s = atrous.demod_scale(
            atrous.albedo_image(tri_data, visibility), cfg
        )
        noisy = atrous.demodulate(noisy, demod_s)

    # Backprojected coordinates are GLOBAL; history gathers resolve through
    # the windowed halo exchange (all-gather only beyond the motion window,
    # parallel.sharding.reproject_rows_sharded).
    py, px = atrous.backproject_pixels(
        gbuf, history_local.lut, history_local.view,
        history_local.proj, cfg, row_offset=row_offset,
    )
    reproj_vis = None
    if cfg.path_gradient or (
        cfg.accumulation_ramp and cfg.ramp_reset_mode != "normal"
    ):
        reproj_vis = reproject_rows_sharded(
            history_local.visibility, py, px, row_offset, axis_name=axis,
            ledger=ledger,
        )
    if cfg.path_gradient:
        lam = jnp.maximum(
            lam,
            _path_gradient_shard(
                tri_data, light, frame_idx, cfg, history_local,
                py, px, visibility, reproj_vis, row_offset, local_h,
                axis, ledger=ledger,
            ),
        )
    age = None
    cls_cur = None
    if cfg.accumulation_ramp:
        # SVGF accumulation ramp: the age and previous-consistency planes
        # reproject through the same windowed halo exchange as the color
        # history (consistency mismatch = disocclusion/camera-cut reset;
        # raw ids or quantized-normal classes per cfg.ramp_reset_mode).
        reproj_age = reproject_rows_sharded(
            history_local.age, py, px, row_offset, axis_name=axis,
            ledger=ledger,
        )
        if cfg.ramp_reset_mode == "normal":
            cls_cur = atrous.normal_class(normal_img, visibility)
            reproj_cons = reproject_rows_sharded(
                history_local.vis_class, py, px, row_offset,
                axis_name=axis, ledger=ledger,
            )
            cur_cons = cls_cur
        else:
            reproj_cons, cur_cons = reproj_vis, visibility
        age = atrous.accumulate_age(
            history_local.age, py, px, lam, frame_idx, cfg,
            reproj=reproj_age, cur_vis=cur_cons, reproj_vis=reproj_cons,
        )
    if cfg.variance_guided:
        reproj_moments = reproject_rows_sharded(
            history_local.moments, py, px, row_offset, axis_name=axis,
            ledger=ledger,
        )
        lum = atrous.luminance(noisy)
        # young-history spatial estimate needs cross-shard rows (5x5 box)
        var_spatial = atrous.spatial_variance(
            exchange_row_halo(lum, 2, axis, ledger), halo=2
        )
        moments, v = atrous.accumulate_moments(
            lum, history_local.moments, py, px, frame_idx, cfg,
            var_spatial=var_spatial, reproj=reproj_moments,
        )
    else:
        moments = None

    c = noisy
    for k in range(1, cfg.wavelet_iterations + 1):
        if cfg.variance_guided:
            c, v = atrous.atrous_iteration_var(
                exchange_row_halo(c, k, axis, ledger),
                exchange_row_halo(v, k, axis, ledger),
                exchange_row_halo(normal_img, k, axis, ledger),
                exchange_row_halo(depth, k, axis, ledger),
                k, cfg, halo=k,
            )
        else:
            c = atrous.atrous_iteration(
                exchange_row_halo(c, k, axis, ledger),
                exchange_row_halo(normal_img, k, axis, ledger),
                exchange_row_halo(depth, k, axis, ledger),
                k, cfg, halo=k,
            )

    reproj_image = reproject_rows_sharded(
        history_local.image, py, px, row_offset, axis_name=axis,
        ledger=ledger,
    )
    rgb = atrous.temporal_accumulate_at(
        c, history_local.image, py, px, frame_idx, lam, cfg,
        reprojected=reproj_image, age=age,
    )

    new_history = History(
        image=rgb,
        visibility=visibility,
        lut=lut,
        view=view,
        proj=proj,
        light_pos=light.position,
        light_color=light.color,
        frame=frame_idx + 1,
        moments=moments,
        age=age,
        vis_class=cls_cur,
        noisy_lum=noisy_lum,
        cam_pos=jnp.asarray(camera.position) if cfg.path_gradient else None,
        cam_rot=jnp.asarray(camera.rotation) if cfg.path_gradient else None,
    )
    if cfg.demodulate_albedo:
        # display radiance; history stays demodulated
        rgb = atrous.modulate(rgb, demod_s)
    if ledger is not None:
        # mesh-uniform by construction: halo_bytes is static and
        # gather_bytes derives from the pmin-reduced branch predicate
        comm = {
            "halo_bytes": jnp.int32(ledger.halo_bytes),
            "gather_bytes": jnp.asarray(ledger.gather_bytes, jnp.int32),
        }
        return rgb, new_history, comm
    return rgb, new_history


def make_sharded_frame(
    cfg: RenderConfig, mesh, axis: str = ROW_AXIS, comm_ledger=None,
):
    """Build the jitted, row-sharded frame function for ``mesh``.

    Returns ``frame(tri_data, camera, light, history) -> (rgb, history')``
    where image planes are sharded P(axis) and everything else replicated.

    ``comm_ledger``: an optional :class:`parallel.sharding.CommLedger`.
    When given, the step instead returns ``(rgb, history', comm)`` with
    ``comm = {"halo_bytes", "gather_bytes"}`` (runtime int32 scalars, bytes
    per interior device this frame), and the ledger's static fields
    (``halo_bytes``/``reproj_halo_bytes``/``gather_fallback_bytes``) are
    populated when the step is first traced -- see CommLedger for the
    invariant this checks.
    """
    n = mesh.shape[axis]
    if cfg.height % n != 0:
        raise ValueError(
            f"height {cfg.height} must divide evenly over {n} devices"
        )
    if cfg.height // n < cfg.wavelet_iterations:
        raise ValueError(
            "each shard needs at least wavelet_iterations rows for the "
            f"widest halo ({cfg.height // n} < {cfg.wavelet_iterations})"
        )
    if cfg.path_gradient and (cfg.height // n) % cfg.gradient_stratum != 0:
        raise ValueError(
            "path_gradient needs shard rows divisible by gradient_stratum "
            f"({cfg.height // n} % {cfg.gradient_stratum} != 0) so stratum "
            "cells do not straddle shards"
        )
    if cfg.indirect_split and (cfg.height // n) % cfg.indirect_stride != 0:
        raise ValueError(
            "indirect_split needs shard rows divisible by indirect_stride "
            f"({cfg.height // n} % {cfg.indirect_stride} != 0) so every "
            "shard starts on a coarse-grid row (the PCG-prefix residual "
            "identity keys on global coarse pixels)"
        )

    hist_spec = _history_spec(
        axis, cfg.variance_guided, cfg.accumulation_ramp, cfg.path_gradient,
        normal_reset=cfg.ramp_reset_mode == "normal",
    )
    out_specs = (P(axis), hist_spec)
    if comm_ledger is not None:
        out_specs = out_specs + ({"halo_bytes": P(), "gather_bytes": P()},)
    shard_fn = jax.shard_map(
        functools.partial(
            _frame_shard, cfg=cfg, axis=axis, ledger=comm_ledger
        ),
        mesh=mesh,
        in_specs=(P(), P(), P(), hist_spec),
        out_specs=out_specs,
        # loop carries seeded from replicated constants become device-varying
        # inside the bounce loop; skip the static varying-axes check.
        check_vma=False,
    )
    return jax.jit(shard_fn, donate_argnums=(3,))


def init_sharded_history(tri_data, cfg: RenderConfig, mesh, axis: str = ROW_AXIS):
    """init_history placed with the sharded layout (image planes P(axis))."""
    from jax.sharding import NamedSharding

    hist = init_history(tri_data, cfg)
    # PartitionSpec subclasses tuple, so flatten the spec tree with an
    # explicit leaf predicate rather than tree_map'ing over both trees.
    leaves, treedef = jax.tree_util.tree_flatten(hist)
    specs = jax.tree_util.tree_leaves(
        _history_spec(
            axis, cfg.variance_guided, cfg.accumulation_ramp,
            cfg.path_gradient,
            normal_reset=cfg.ramp_reset_mode == "normal",
        ),
        is_leaf=lambda x: isinstance(x, P),
    )
    placed = [
        jax.device_put(x, NamedSharding(mesh, s)) for x, s in zip(leaves, specs)
    ]
    return jax.tree_util.tree_unflatten(treedef, placed)
