"""Hardware A/B: multi-resolution indirect (cfg.indirect_split).

Measures the interactive rows (32k or 248k triangles, 1080p 1spp, max_bounces=8 + RR@2 + adaptive alpha,
orbiting camera) with the multi-res split off vs several (split, stride)
points. Run on a GPU:

    python -m benchmarks.multires_ab [--tris 32768] [--frames 3]

One JSON line per variant.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from benchmarks.suite import bench_renderer


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--splits", type=int, default=32,
        help="subdivided-Cornell splits (32 -> 32,768 tris; 88 -> 247,808)",
    )
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument(
        "--variants", type=str,
        default="base,s2x2,s2x4,s1x4",
        help="comma list: base | s<split>x<stride>; append 'g' for "
        "gbuffer_primary (G-buffer-seeded bounce 0) and/or 'j' for "
        "indirect_jitter (per-frame grid phase), e.g. s1x4g / s1x4gj",
    )
    parser.add_argument(
        "--ramp", action="store_true",
        help="use the recommended-quality temporal config (variance-"
        "guided + accumulation ramp + adaptive alpha) instead of plain "
        "adaptive alpha -- the config under which jitter recovers the "
        "full-res quality bar",
    )
    args = parser.parse_args()

    import jax

    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
    )

    tris = 32 * args.splits * args.splits
    print(
        f"# device: {jax.devices()[0].device_kind}  tris={tris} "
        f"frames={args.frames}",
        file=sys.stderr,
    )
    scene = ptsf.Scene.from_arrays(*procedural.subdivided_cornell(args.splits))
    base = ptsf.RenderConfig(
        width=1920, height=1080, max_bounces=8, rr_start_bounce=2,
        adaptive_alpha=True,
        variance_guided=args.ramp, accumulation_ramp=args.ramp,
        ramp_reset_mode="normal" if args.ramp else "id",
    )

    def orbit(r, i):
        r.camera = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0)

    for variant in args.variants.split(","):
        name = variant
        jitter = name.endswith("j")
        if jitter:
            name = name[:-1]
        gprim = name.endswith("g")
        if gprim:
            name = name[:-1]
        if name == "base":
            cfg = base
        else:
            split, stride = name.lstrip("s").split("x")
            cfg = dataclasses.replace(
                base, indirect_split=int(split), indirect_stride=int(stride)
            )
        if gprim:
            cfg = dataclasses.replace(cfg, gbuffer_primary=True)
        if jitter:
            cfg = dataclasses.replace(cfg, indirect_jitter=True)
        ms = bench_renderer(
            lambda: ptsf.Renderer(scene, cfg), args.frames, orbit
        )
        print(
            json.dumps(
                {
                    "metric": f"ms/frame, interactive {tris}tris {variant}",
                    "value": round(ms, 1),
                    "unit": "ms/frame",
                }
            ),
            flush=True,
        )
        print(f"{variant:8s} {ms:9.1f} ms/frame", file=sys.stderr)


if __name__ == "__main__":
    main()
