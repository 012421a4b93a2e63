"""Benchmark suite: the tracked configs, ms/frame on one GPU.

Run: python -m benchmarks.suite [--quick] [--only SUBSTR]
Prints one JSON line per config plus a human-readable table on stderr.
Refuses to run without a GPU.

Configs:
  1. Cornell, static camera, 1spp 512x512, spatial a-trous only
  2. Cornell, static camera, full SVGF (temporal + a-trous), no gradients
  3. Cornell, orbiting camera, full A-SVGF w/ adaptive alpha, 1080p 1spp
  4. Large-scene stress (subdivided Cornell; LBVH-scale traversal)
  5. Dynamic light + disocclusion cuts (gradient-driven rejection, 4spp)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def bench_renderer(make_renderer, frames, mutate=None):
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf  # noqa: F401

    r = make_renderer()
    r.step().block_until_ready()  # compile + warm
    r.step().block_until_ready()
    t0 = time.perf_counter()
    rgb = None
    for i in range(frames):
        if mutate is not None:
            mutate(r, i)
        rgb = r.step()
    rgb.block_until_ready()
    return (time.perf_counter() - t0) / frames * 1000.0


def suite_entries(quick: bool):
    """The tracked configs as (name, thunk) pairs; each thunk measures and
    returns ms/frame. Lazy so a --only filter skips scene prep entirely."""
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
    )

    frames = 5 if quick else 20
    # the interactive rows need a steady-state measurement, not a 2-frame
    # sample -- 10 timed frames after 2 warm
    interactive_frames = frames if quick else 10
    # the 32-bounce parity stress rows run at seconds/frame; 3 frames keeps
    # the wall-clock sane while still averaging over dispatch jitter
    big_frames = frames if quick else 3
    scene_cache: dict = {}

    def cornell():
        if "cornell" not in scene_cache:
            scene_cache["cornell"] = ptsf.Scene.cornell_box()
        return scene_cache["cornell"]

    def subdiv(splits):
        key = ("subdiv", splits)
        if key not in scene_cache:
            scene_cache[key] = ptsf.Scene.from_arrays(
                *procedural.subdivided_cornell(splits)
            )
        return scene_cache[key]

    def run(scene_fn, cfg, n, mutate=None):
        return lambda: bench_renderer(
            lambda: ptsf.Renderer(scene_fn(), cfg), n, mutate
        )

    entries = []

    # 0. the reference's exact configuration (1000x800, main.cpp:52-53)
    cfg0 = ptsf.RenderConfig()
    entries.append(
        ("cornell_1000x800_reference_parity", run(cornell, cfg0, frames))
    )

    # 1. spatial-only 512x512 (temporal alpha 1.0 = no history blend)
    cfg1 = ptsf.RenderConfig(width=512, height=512, ema_alpha=1.0)
    entries.append(("cornell_512_spatial_only", run(cornell, cfg1, frames)))

    # 2. full SVGF 512x512: temporal EMA + variance-guided a-trous
    cfg2 = ptsf.RenderConfig(width=512, height=512, variance_guided=True)
    entries.append(("cornell_512_full_svgf", run(cornell, cfg2, frames)))

    # 2b. (extra, non-parity) same + Russian roulette from bounce 4:
    # unbiased early termination, the biggest throughput lever on enclosed
    # scenes (quality cost measured at ~4% rMSE, benchmarks/quality.py)
    cfg2rr = dataclasses.replace(cfg2, rr_start_bounce=4)
    entries.append(
        ("cornell_512_full_svgf_rr4_nonparity", run(cornell, cfg2rr, frames))
    )

    # 2c. (extra, non-parity) NEE + variance guidance: the framework's
    # best-quality estimator (denoised rMSE 0.043 vs 0.155, quality.py);
    # the shadow ray roughly doubles trace cost
    cfg2nee = dataclasses.replace(cfg2, nee=True)
    entries.append(
        ("cornell_512_svgf_nee_nonparity", run(cornell, cfg2nee, frames))
    )

    # 2d. (extra, non-parity) same + the SVGF accumulation ramp: the
    # per-pixel age plane adds one reprojected history plane and a
    # per-pixel alpha -- tracks the feature's frame cost next to 2
    cfg2ramp = dataclasses.replace(cfg2, accumulation_ramp=True)
    entries.append(
        ("cornell_512_svgf_ramp_nonparity", run(cornell, cfg2ramp, frames))
    )

    # 2e. (extra, non-parity) + the A-SVGF path-space gradient: one
    # re-traced sample per 3x3 stratum under the current light -- tracks
    # the feature's frame cost (~1/9 of a 1-spp trace) next to 2d
    cfg2pg = dataclasses.replace(
        cfg2, accumulation_ramp=True, path_gradient=True
    )

    def light_drift(r, i):
        r.move_light(dx=0.05)

    entries.append(
        (
            "cornell_512_svgf_ramp_pathgrad_nonparity",
            run(cornell, cfg2pg, frames, light_drift),
        )
    )

    # 3. orbiting camera, full A-SVGF with adaptive alpha, 1080p
    cfg3 = ptsf.RenderConfig(width=1920, height=1080, adaptive_alpha=True)

    def orbit(r, i):
        r.camera = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0)

    entries.append(
        ("cornell_1080p_asvgf_orbit", run(cornell, cfg3, frames, orbit))
    )

    # 4. large-scene stress: 32,768 tris, moving camera, 1080p 1spp,
    # 32 bounces. --quick keeps a small stand-in (see benchmarks/scaling.py
    # for the curve over scene sizes).
    splits = 2 if quick else 32  # 128 or 32,768 triangles
    big = lambda: subdiv(splits)  # noqa: E731
    cfg4 = ptsf.RenderConfig(width=1920, height=1080)
    entries.append(
        (
            f"cornell_subdiv{splits}_{32 * splits * splits}tris_1080p_orbit",
            run(big, cfg4, big_frames, orbit),
        )
    )

    # 4b. (extra, non-parity) the large-scene stress with RR@4: on a
    # closed box every parity path runs all 32 segments; RR bounds the
    # expected path length
    cfg4rr = dataclasses.replace(cfg4, rr_start_bounce=4)
    entries.append(
        (
            f"cornell_subdiv{splits}_rr4_nonparity",
            run(big, cfg4rr, big_frames, orbit),
        )
    )

    # 4c. (extra, non-parity) interactive config at the same scale:
    # max_bounces=8 (past visual convergence for diffuse boxes: energy
    # after 8 bounces ~ 0.7^8 ~ 6%), Russian roulette from bounce 2
    # (unbiased), adaptive alpha. The closed box is the worst case (no
    # path ever escapes).
    cfg4i = ptsf.RenderConfig(
        width=1920, height=1080, max_bounces=8, rr_start_bounce=2,
        adaptive_alpha=True,
    )
    entries.append(
        (
            f"cornell_subdiv{splits}_{32 * splits * splits}tris_1080p_interactive_nonparity",
            run(big, cfg4i, interactive_frames, orbit),
        )
    )

    # 4c'. (extra, non-parity) 4c + multi-res indirect (split@1, stride
    # 4) + G-buffer-seeded primaries, variance guidance, accumulation ramp
    # and grid-phase jitter: the recommended-quality interactive config.
    # These modes are traced by the XLA route.
    cfg4iq = dataclasses.replace(
        cfg4i, indirect_split=1, indirect_stride=4, gbuffer_primary=True,
        indirect_jitter=True, variance_guided=True,
        accumulation_ramp=True, ramp_reset_mode="normal",
    )
    entries.append(
        (
            f"cornell_subdiv{splits}_{32 * splits * splits}tris_1080p_interactive_recommended_nonparity",
            run(big, cfg4iq, interactive_frames, orbit),
        )
    )

    # 5. dynamic light + camera cuts, 4spp, gradient-driven rejection
    cfg5 = ptsf.RenderConfig(
        width=512, height=512, spp=4, adaptive_alpha=True
    )

    def light_cuts(r, i):
        r.move_light(dx=0.3)
        if i % 7 == 6:
            r.move_camera(dx=0.8 if (i // 7) % 2 == 0 else -0.8)

    entries.append(
        (
            "cornell_512_4spp_dynamic_light_cuts",
            run(cornell, cfg5, frames, light_cuts),
        )
    )
    return entries


def run_suite(quick: bool, only: str | None = None):
    results = []
    for name, thunk in suite_entries(quick):
        if only is not None and only not in name:
            continue
        results.append((name, thunk()))
        # stream partial results (long rows take minutes; a killed run
        # should still leave the finished rows on record)
        print(f"[suite] {name}: {results[-1][1]:.1f} ms", file=sys.stderr)
    return results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument(
        "--only", default=None, metavar="SUBSTR",
        help="run only config names containing SUBSTR",
    )
    args = parser.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("suite: no GPU; refusing to run", file=sys.stderr)
        return 1
    from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
        enable_compile_cache,
    )

    enable_compile_cache()
    results = run_suite(args.quick, args.only)
    for name, ms in results:
        print(
            json.dumps(
                {
                    "metric": f"ms/frame, {name}, one GPU",
                    "value": ms,
                    "unit": "ms/frame",
                    "device_kind": dev.device_kind,
                }
            )
        )
    print("\nconfig                                   ms/frame", file=sys.stderr)
    for name, ms in results:
        print(f"{name:42s} {ms:8.2f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
