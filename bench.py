"""Headline benchmark: denoised 1-spp 1080p Cornell Box, ms/frame, one GPU.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "ms/frame", "device": {...},
     "card": "<name>, <power limit>"}

The frame is the full A-SVGF pipeline (G-buffer + gradient + path trace +
9x a-trous + EMA) through Renderer.step on the route the frame picks
(pipeline/frame.use_trace_kernel). Frames are serially dependent through the
donated history, so timing N steps and waiting on the last output with
block_until_ready measures steady-state throughput. Refuses to run without
a GPU: a CPU time is not a device number.

Usage: python bench.py [--width W --height H --frames N --warmup N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def run_bench(width: int, height: int, frames: int, warmup: int):
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf

    cfg = ptsf.RenderConfig(width=width, height=height)
    renderer = ptsf.Renderer(ptsf.Scene.cornell_box(), cfg)
    for _ in range(warmup):  # compile + temporal warmup
        renderer.step().block_until_ready()
    t0 = time.perf_counter()
    rgb = None
    for _ in range(frames):
        rgb = renderer.step()
    rgb.block_until_ready()
    return (time.perf_counter() - t0) / frames * 1000.0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    args = parser.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (platform {dev.platform!r}); refusing to run",
              file=sys.stderr)
        return 1
    from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
        enable_compile_cache,
    )

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ms = run_bench(args.width, args.height, args.frames, args.warmup)
    print(
        json.dumps(
            {
                "metric": (
                    f"ms/frame, {args.width}x{args.height} 1spp Cornell Box, "
                    "full A-SVGF (G-buffer + gradient + path trace + 9x "
                    "a-trous + EMA), one GPU"
                ),
                "value": ms,
                "unit": "ms/frame",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "card": card,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
