"""The frame function: the whole reference frame as one pure jitted program.

The reference crosses the host/device boundary >= 16 times per frame with a
full queue drain each time (main.cpp:1090-1113; SURVEY.md section 3.2). This
design collapses the four passes --

    visibility G-buffer -> temporal gradient -> path trace -> a-trous+EMA

-- into one XLA program over a History pytree: zero host round-trips, full
cross-pass fusion, and history buffers donated back in place.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
    atrous,
    camera as cam_ops,
    gbuffer,
    gradient,
    multires,
    pathgrad,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas import (
    pathtrace as pathtrace_kernel,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.history import (
    History,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    TriangleData,
)


def camera_matrices(camera, cfg: RenderConfig):
    """The reference's per-frame UBO matrices (main.cpp:1463-1475): the view
    (translate-only in the reference; general camera->world basis here) and
    glm::perspective(2*FOV) with the Vulkan y flip. Accepts a Camera or a
    bare (3,) position (identity rotation)."""
    if isinstance(camera, Camera):
        view = cam_ops.camera_view(camera.position, camera.rotation)
    else:
        view = cam_ops.reference_view(camera)
    proj = cam_ops.vulkan_perspective(
        cfg.fov * 2.0, cfg.width / cfg.height, cfg.near, cfg.far
    )
    return view, proj


def use_trace_kernel(cfg: RenderConfig) -> bool:
    """Whether the noisy trace runs the per-pixel Pallas kernel
    (ops/pallas/pathtrace.py) instead of the XLA trace (ops/pathtrace.py).

    The one routing decision of both the single-chip and the row-sharded
    frame. ``backend="auto"`` takes the kernel on a GPU and XLA elsewhere;
    ``"xla"`` never takes it; ``"pallas"`` always does, and off the GPU
    only when the caller opted into the Pallas interpreter
    (``cfg.pallas_interpret``) -- the frame never decides to interpret by
    itself. ``gbuffer_primary`` and ``indirect_split`` are not traced by
    the kernel and take the XLA trace on the same device.
    """
    if cfg.backend == "xla" or cfg.gbuffer_primary or cfg.indirect_split:
        return False
    on_gpu = jax.default_backend() == "gpu"
    if cfg.backend == "auto":
        return on_gpu
    if not on_gpu and not cfg.pallas_interpret:
        raise ValueError(
            "backend='pallas' compiles the trace kernel for a GPU; on "
            f"{jax.default_backend()!r} set pallas_interpret=True to run it "
            "in the Pallas interpreter"
        )
    return True


def noisy_trace(tri_data, camera, light, frame_idx, cfg: RenderConfig,
                normal_img, depth, primary=None, row_offset=0, rows=None,
                row_pad=None):
    """Pass 3, the noisy path-traced radiance (rows, W, 3) of the pixel
    rows [row_offset, row_offset + rows), by the route
    :func:`use_trace_kernel` picks. ``normal_img``/``depth`` guide the
    multi-resolution upsample (cfg.indirect_split), ``primary`` seeds
    bounce 0 from the G-buffer (cfg.gbuffer_primary) and ``row_pad`` is
    the sharded frame's coarse-row halo exchange."""
    if cfg.indirect_split:
        # multi-res indirect (config.py): full-res truncated trace +
        # coarse full-length trace, G-buffer-guided upsample
        return multires.multires_noisy_xla(
            tri_data, camera.position, light, frame_idx, cfg,
            normal_img, depth, rotation=camera.rotation, primary=primary,
            row_offset=row_offset, rows=rows, row_pad=row_pad,
        )
    if use_trace_kernel(cfg):
        return pathtrace_kernel.path_trace_pass_pallas(
            tri_data, camera.position, light, frame_idx, cfg,
            row_offset=row_offset, rows=rows, rotation=camera.rotation,
            interpret=cfg.pallas_interpret,
        )
    return pathtrace.path_trace_pass(
        tri_data, camera.position, light, frame_idx, cfg,
        row_offset=row_offset, rows=rows, rotation=camera.rotation,
        primary=primary,
    )


def render_frame_impl(
    tri_data: TriangleData,
    camera: Camera,
    light: Light,
    history: History,
    cfg: RenderConfig,
    model=None,
):
    """One frame: (triangle tables, camera, light, history) -> (rgb, history').

    Pass order matches drawScene (main.cpp:1104-1110). Returns the final
    denoised image and the next frame's history. Every pass is XLA except
    the noisy trace, which :func:`noisy_trace` routes to the per-pixel
    kernel on a GPU (:func:`use_trace_kernel`).

    ``model``: optional (4, 4) per-frame model matrix (the reference's
    UBO model slot, visibility.vert.glsl:22-24); applied in-graph to the
    static tables (scene.transform_triangle_data). History.lut then
    carries the previous frame's transformed vertices, so reprojection
    and the temporal gradient handle geometry motion exactly like the
    reference's modelPrev would (main.cpp:1465-1469).
    """
    if model is not None:
        from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
            transform_triangle_data,
        )

        tri_data = transform_triangle_data(tri_data, model)
    frame_idx = history.frame
    view, proj = camera_matrices(camera, cfg)

    # Each pass runs under a named scope: the profiler reduction
    # (benchmarks/frame_profile.py) attributes device time by these names.
    # -- pass 1: visibility G-buffer (replaces visibility.{vert,geom,frag}) --
    with jax.named_scope("gbuffer"):
        gbuf = gbuffer.visibility_pass(
            tri_data, camera.position, view, proj, cfg,
            rotation=camera.rotation,
        )
    lut = tri_data.lut  # static geometry: rebuilt-per-frame in the reference

    # -- pass 2: temporal gradient (temporalGradient.comp.glsl) --
    with jax.named_scope("temporal_gradient"):
        lam = gradient.temporal_gradient_pass(
            gbuf,
            lut,
            history.lut,
            camera.position,
            light.position,
            history.light_pos,
            light.color,
            history.light_color,
        )

    py = px = None
    if cfg.variance_guided or cfg.accumulation_ramp or cfg.path_gradient:
        py, px = atrous.backproject_pixels(
            gbuf, history.lut, history.view, history.proj, cfg
        )
    if cfg.path_gradient:
        # A-SVGF path-space gradient (config.py): re-trace last frame's
        # samples under the current light; max() with the Phong proxy
        # (disjoint blind spots -- see ops/pathgrad.py).
        lam = jnp.maximum(
            lam,
            pathgrad.path_gradient_pass(
                tri_data, light, frame_idx, cfg,
                history.noisy_lum, history.cam_pos, history.cam_rot,
                py, px, gbuf.visibility, history.visibility,
            ),
        )

    # -- pass 3: path trace (raytrace.comp.glsl) --
    normal_img = tri_data.lut_normals[gbuf.visibility.astype(jnp.int32)]
    primary = None
    if cfg.gbuffer_primary:
        # seed bounce 0 from the already-traced G-buffer (config.py):
        # the trace starts at segment 1
        primary = (
            gbuf.visibility,
            gbuf.world_pos,
            normal_img,
            atrous.albedo_image(tri_data, gbuf.visibility),
        )
    with jax.named_scope("path_trace"):
        noisy = noisy_trace(
            tri_data, camera, light, frame_idx, cfg, normal_img, gbuf.depth,
            primary=primary,
        )
    noisy_lum = atrous.luminance(noisy) if cfg.path_gradient else None
    if cfg.firefly_clamp:
        # after noisy_lum: the gradient's stored luminance must stay
        # stream-exact vs the (unclamped) re-trace (ops/pathgrad.py)
        noisy = jnp.minimum(noisy, jnp.float32(cfg.firefly_clamp))

    # -- pass 4: a-trous filter + temporal EMA (temporalFiltering.comp.glsl) --
    if cfg.demodulate_albedo:
        # SVGF extension: filter irradiance, not radiance (config.py) --
        # history is carried demodulated; display re-modulates at the end
        demod_s = atrous.demod_scale(
            atrous.albedo_image(tri_data, gbuf.visibility), cfg
        )
        noisy = atrous.demodulate(noisy, demod_s)
    age = None
    cls_cur = None
    if cfg.accumulation_ramp:
        # SVGF accumulation ramp (config.py): per-pixel history length,
        # reprojected like the color history; reset by the temporal
        # gradient (shading change) or a surface-consistency mismatch
        # (disocclusion / camera cut -- SVGF's G-buffer consistency test;
        # exact primitive ids or quantized normals per ramp_reset_mode).
        if cfg.ramp_reset_mode == "normal":
            cls_cur = atrous.normal_class(normal_img, gbuf.visibility)
            age = atrous.accumulate_age(
                history.age, py, px, lam, frame_idx, cfg,
                prev_vis=history.vis_class, cur_vis=cls_cur,
            )
        else:
            age = atrous.accumulate_age(
                history.age, py, px, lam, frame_idx, cfg,
                prev_vis=history.visibility, cur_vis=gbuf.visibility,
            )
    if cfg.variance_guided:
        # SVGF extension (config.py): moments reprojected with the same
        # backprojection as the color history, variance-normalized w_l.
        moments, var = atrous.accumulate_moments(
            atrous.luminance(noisy), history.moments, py, px, frame_idx, cfg
        )
        filtered, _ = atrous.atrous_filter_var(
            noisy, var, normal_img, gbuf.depth, cfg
        )
        rgb = atrous.temporal_accumulate_at(
            filtered, history.image, py, px, frame_idx, lam, cfg, age=age
        )
    else:
        moments = None
        with jax.named_scope("atrous"):
            filtered = atrous.atrous_filter(
                noisy, normal_img, gbuf.depth, cfg
            )
        if cfg.accumulation_ramp:
            rgb = atrous.temporal_accumulate_at(
                filtered, history.image, py, px, frame_idx, lam, cfg,
                age=age,
            )
        else:
            with jax.named_scope("temporal_blend"):
                rgb = atrous.temporal_accumulate(
                    filtered,
                    history.image,
                    gbuf,
                    history.lut,
                    history.view,
                    history.proj,
                    frame_idx,
                    lam,
                    cfg,
                )

    # -- history commit (the reference's end-of-frame blits, main.cpp:1361-72)
    new_history = History(
        image=rgb,
        visibility=gbuf.visibility,
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
        return atrous.modulate(rgb, demod_s), new_history
    return rgb, new_history


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("history",))
def render_frame(tri_data, camera, light, history, cfg, model=None):
    """Jitted :func:`render_frame_impl`; history buffers are donated so XLA
    reuses them in place (the functional analogue of the reference's
    ping-pong blits)."""
    return render_frame_impl(tri_data, camera, light, history, cfg, model)


def init_history(tri_data: TriangleData, cfg: RenderConfig) -> History:
    """Frame-0 history.

    Previous matrices start equal to the current ones (main.cpp:486-489);
    the image/visibility planes start at zero (frame 0 skips blending,
    temporalFiltering.comp.glsl:251-259, so their values never leak). The
    previous LUT starts as the current LUT -- the reference leaves that
    buffer uninitialized on frame 0 (it is only copied at end-of-frame,
    main.cpp:1370-1372) and nothing consumes it before frame 1.
    """
    camera = Camera.default()
    light = Light.default()
    view, proj = camera_matrices(camera.position, cfg)
    return History(
        image=jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
        visibility=jnp.zeros((cfg.height, cfg.width), jnp.float32),
        # copy=True: the history is donated to the jitted frame, so it must
        # not alias the (non-donated) tri_data.lut buffer.
        lut=jnp.array(tri_data.lut, copy=True),
        view=view,
        proj=proj,
        light_pos=light.position,
        light_color=light.color,
        frame=jnp.zeros((), jnp.int32),
        moments=(
            jnp.zeros((cfg.height, cfg.width, 2), jnp.float32)
            if cfg.variance_guided
            else None
        ),
        age=(
            jnp.zeros((cfg.height, cfg.width), jnp.float32)
            if cfg.accumulation_ramp
            else None
        ),
        vis_class=(
            jnp.zeros((cfg.height, cfg.width), jnp.float32)
            if cfg.accumulation_ramp and cfg.ramp_reset_mode == "normal"
            else None
        ),
        noisy_lum=(
            jnp.zeros((cfg.height, cfg.width), jnp.float32)
            if cfg.path_gradient
            else None
        ),
        cam_pos=jnp.asarray(camera.position) if cfg.path_gradient else None,
        cam_rot=jnp.asarray(camera.rotation) if cfg.path_gradient else None,
    )
