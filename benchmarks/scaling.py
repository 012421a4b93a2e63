"""Scene-size scaling probe: per-pass ms at 1080p across triangle counts.

Times the G-buffer pass (XLA, the tiled dense intersector), the noisy trace
on the kernel route and on the XLA route, and optionally the full frame,
for subdivided Cornell boxes of the requested sizes, on one GPU:

    python -m benchmarks.scaling [--sizes 2048,8192,32768] [--frames N]
        [--no-xla-trace] [--full-frame]

The XLA trace re-scans every triangle block for each of the 33 segments,
so it takes seconds per frame at tens of thousands of triangles;
--no-xla-trace skips it.
"""

from __future__ import annotations

import argparse
import sys
import time


def time_pass(fn, frames):
    fn().block_until_ready()
    t0 = time.perf_counter()
    out = None
    for _ in range(frames):
        out = fn()
    out.block_until_ready()
    return (time.perf_counter() - t0) / frames * 1000.0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="2048,8192,32768")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--rr-start-bounce", type=int, default=0,
                   help="Russian roulette from this bounce (non-parity)")
    p.add_argument("--no-xla-trace", action="store_true")
    p.add_argument("--full-frame", action="store_true")
    args = p.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("scaling: no GPU; refusing to run", file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        gbuffer,
        intersect,
        pathtrace,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas import (
        pathtrace as pathtrace_kernel,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
        enable_compile_cache,
    )

    enable_compile_cache()
    cfg = ptsf.RenderConfig(
        width=args.width, height=args.height,
        rr_start_bounce=args.rr_start_bounce,
    )
    print(f"# device: {jax.devices()[0]}")
    for size_s in args.sizes.split(","):
        splits = max(1, int(round((int(size_s) / 32) ** 0.5)))
        scene = ptsf.Scene.from_arrays(*procedural.subdivided_cornell(splits))
        t0 = time.perf_counter()
        td = ptsf.precompute_triangle_data(scene)
        prep_s = time.perf_counter() - t0
        ntri = scene.num_triangles
        cam, light = ptsf.Camera.default(), ptsf.Light.default()
        view, proj = frame_mod.camera_matrices(cam, cfg)
        block = intersect.triangle_block(cfg.width * cfg.height, ntri)

        g_ms = time_pass(jax.jit(lambda: gbuffer.visibility_pass(
            td, cam.position, view, proj, cfg, rotation=cam.rotation
        ).depth), args.frames)
        k_ms = time_pass(jax.jit(lambda: pathtrace_kernel.path_trace_pass_pallas(
            td, cam.position, light, 1, cfg, rotation=cam.rotation
        )), args.frames)
        line = (
            f"tris={ntri:>7} blocks={-(-ntri // block):>5} "
            f"prep={prep_s * 1e3:8.1f}ms gbuffer={g_ms:9.2f}ms "
            f"trace_kernel={k_ms:9.2f}ms"
        )
        if not args.no_xla_trace:
            x_ms = time_pass(jax.jit(lambda: pathtrace.path_trace_pass(
                td, cam.position, light, 1, cfg, rotation=cam.rotation
            )), args.frames)
            line += f" trace_xla={x_ms:10.2f}ms"
        if args.full_frame:
            r = ptsf.Renderer(scene, cfg)
            line += f" frame={time_pass(r.step, args.frames):10.2f}ms"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
