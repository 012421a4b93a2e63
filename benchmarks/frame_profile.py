"""Frame time of the trace kernel route against the XLA route, and the
device time of each layer of the frame, on one GPU.

    python -m benchmarks.frame_profile [--frames 20] [--out FILE]

Cells (pipeline/frame.use_trace_kernel picks the route; backend="xla"
forces the plain one):
  headline   Cornell box, 1920x1080, 1 spp, 32 bounces, 9 a-trous, EMA
  nee512     512x512, next-event estimation
  rr512      512x512, Russian roulette from bounce 4

Each cell runs the two routes in turns (xla, kernel, kernel, xla), each
run warming up and then timing ``--frames`` frames through Renderer.step,
ended by block_until_ready.

``--trace`` runs instead one profiler trace per route of the headline
cell: device time per frame of each named scope of render_frame_impl
(gbuffer, temporal_gradient, path_trace, atrous, temporal_blend; the rest
is "other"), and the device's idle share over the traced window. XLA
replays a jitted step as one CUDA graph (a "command buffer"), which hides
the kernels inside it from the trace, so this mode starts JAX with command
buffers off; its times are for attribution, the timed runs are the frame
times. Refuses to run without a GPU. Prints one JSON line and writes it
to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

LAYERS = ("gbuffer", "temporal_gradient", "path_trace", "atrous",
          "temporal_blend")
CELLS = {
    "headline": dict(width=1920, height=1080),
    "nee512": dict(width=512, height=512, nee=True),
    "rr512": dict(width=512, height=512, rr_start_bounce=4),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_route(ptsf, cfg, frames, warmup=3):
    r = ptsf.Renderer(ptsf.Scene.cornell_box(), cfg)
    for _ in range(warmup):
        r.step().block_until_ready()
    t0 = time.perf_counter()
    rgb = None
    for _ in range(frames):
        rgb = r.step()
    rgb.block_until_ready()
    return (time.perf_counter() - t0) / frames * 1000.0


def op_layers(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> layer, from each instruction's op_name."""
    layers = {}
    pat = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        name, op_name = m.groups()
        layer = next((lay for lay in LAYERS if f"/{lay}/" in op_name + "/"),
                     "other")
        layers[name] = layer
    return layers


def reduce_trace(xplane_path, layers_of, frames):
    """Per-layer device ms/frame, busy ms and idle share of a trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    per_layer = {lay: 0.0 for lay in LAYERS + ("other",)}
    intervals = []
    unmatched = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                op = stats.get("hlo_op")
                if op is None:
                    continue
                start, dur = ev.start_ns, ev.duration_ns
                intervals.append((start, start + dur))
                layer = layers_of.get(str(op))
                if layer is None:
                    unmatched[str(op)] = unmatched.get(str(op), 0) + dur
                    layer = "other"
                per_layer[layer] += dur
    if not intervals:
        raise RuntimeError(f"no device events in {xplane_path}")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return {
        "layer_ms_per_frame": {
            k: v / 1e6 / frames for k, v in per_layer.items()
        },
        "busy_ms_per_frame": busy / 1e6 / frames,
        "idle_share": 1.0 - busy / window,
        "unmatched_ops": dict(sorted(unmatched.items(),
                                     key=lambda kv: -kv[1])[:5]),
    }


def profile_route(jax, ptsf, cfg, frames=5):
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )

    r = ptsf.Renderer(ptsf.Scene.cornell_box(), cfg)
    for _ in range(3):
        r.step().block_until_ready()
    hlo = frame_mod.render_frame.lower(
        r.tri_data, r.camera, r.light, r.history, cfg, None
    ).compile().as_text()
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            rgb = None
            for _ in range(frames):
                rgb = r.step()
            rgb.block_until_ready()
        path = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        return reduce_trace(path, op_layers(hlo), frames)


def time_cells(ptsf, frames):
    """ms/frame of each cell, routes in turns (xla, kernel, kernel, xla)."""
    cells = {}
    for name, kw in CELLS.items():
        base = ptsf.RenderConfig(**kw)
        runs = {"xla": [], "kernel": []}
        for route in ("xla", "kernel", "kernel", "xla"):
            cfg = dataclasses.replace(
                base, backend="xla" if route == "xla" else "auto"
            )
            runs[route].append(time_route(ptsf, cfg, frames))
        cells[name] = {
            "config": kw,
            "ms_per_frame": runs,
            "median_ms": {k: float(np.median(v)) for k, v in runs.items()},
        }
        print(name, json.dumps(cells[name]), flush=True)
    return cells


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--out", default=None)
    parser.add_argument("--trace", action="store_true",
                        help="per-layer device times from a profiler trace")
    args = parser.parse_args()

    if args.trace:
        # before JAX starts: the flag is read once, at backend start-up
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        ).strip()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"frame_profile: no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
        enable_compile_cache,
    )

    enable_compile_cache()
    card = card_line()
    result = {"card": card, "device_kind": dev.device_kind}
    if args.trace:
        head = ptsf.RenderConfig(**CELLS["headline"])
        result["profile_headline"] = {
            route: profile_route(
                jax, ptsf, dataclasses.replace(head, backend=backend)
            )
            for route, backend in (("kernel", "auto"), ("xla", "xla"))
        }
    else:
        result["frames"] = args.frames
        result["cells"] = time_cells(ptsf, args.frames)
    result["peak_bytes_in_use"] = dev.memory_stats().get("peak_bytes_in_use")
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
