"""GPU smoke test: the renderer's main path on one NVIDIA card, end to end.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the row-sharded frame only

Phases (one process; any failure raises and exits non-zero):

  device      jax.devices() and the card's name and power limit.
  main path   Renderer(Scene.cornell_box(), 1920x1080) stepped 8 frames
              through Renderer.step: finite, non-constant images, frame 8
              smoother than frame 0, ms/frame.
  kernel      the Pallas trace kernel against the XLA trace at 1080p, 32
              bounces; a 128x96 GPU frame against the same frame on the
              CPU; the golden snapshots of tests/golden on the GPU.
  large scene the 32,768-triangle subdivided Cornell box at 1080p, 2
              frames, on the XLA route's tiled intersector; peak memory.
  --four      make_sharded_frame over a 1-D mesh of 4 GPUs at 1080p (270
              rows each), an orbit of frames compared with the one-card
              render_frame; halo bytes from the CommLedger.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

# Kernel vs XLA trace, same card. The kernel evaluates the same arithmetic
# as the XLA reference, but products are contracted (FMA) differently, so a
# ray that grazes a triangle edge can hit on one side and miss on the
# other; that one path then diverges completely. Such flips are rare and
# isolated: at most 0.1% of pixels may differ by more than 1e-3 (one ulp-
# level path difference leaves the rest far below 1e-3), and after the
# a-trous filter and EMA the mean absolute difference stays under 1e-4.
KERNEL_FLIP_SHARE = 1e-3
KERNEL_DENOISED_MAD = 1e-4
# GPU frame vs CPU frame: the GPU's sin/cos/log/sqrt and division are not
# the CPU's to the last ulp, so the PCG-driven bounce directions drift by
# ulps and more grazing hits flip than between two routes on one card.
GPU_CPU_FLIP_SHARE = 1e-2
GPU_CPU_DENOISED_MAD = 1e-3
# Goldens were written by the XLA route on the CPU (tests/test_golden.py
# holds the CPU run to rtol 1e-5); on the GPU the same flips apply, so the
# share of pixels off by more than 1e-3 is bounded instead.
GOLDEN_FLIP_SHARE = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def flip_share(a, b, tol=1e-3) -> float:
    return float(np.mean(np.abs(np.asarray(a) - np.asarray(b)).max(-1) > tol))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def noise(img) -> float:
    """Mean absolute difference of each pixel from its right and lower
    neighbours: high for per-pixel noise, low for a smooth image."""
    img = np.asarray(img, np.float64)
    return float(
        np.abs(np.diff(img, axis=0)).mean() + np.abs(np.diff(img, axis=1)).mean()
    )


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_main(ptsf, card):
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )

    cfg = ptsf.RenderConfig(width=1920, height=1080)
    r = ptsf.Renderer(ptsf.Scene.cornell_box(), cfg)
    t0 = time.perf_counter()
    frames = [np.asarray(r.step())]
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb = None
    for _ in range(7):
        rgb = r.step()
    rgb.block_until_ready()
    ms = (time.perf_counter() - t0) / 7 * 1000.0
    frames.append(np.asarray(rgb))
    for i, f in zip((0, 7), frames):
        check(f.shape == (1080, 1920, 3), f"frame {i} shape {f.shape}")
        check(bool(np.isfinite(f).all()), f"frame {i} has non-finite values")
        check(float(f.std()) > 1e-3, f"frame {i} is constant")
    n0, n7 = noise(frames[0]), noise(frames[1])
    check(n7 < n0, f"frame 8 not smoother than frame 0 ({n7} >= {n0})")
    log(
        f"main path: 1920x1080 Cornell box, 8 frames through Renderer.step, "
        f"route={'kernel' if frame_mod.use_trace_kernel(cfg) else 'xla'}; "
        f"{ms:.3f} ms/frame over frames 2-8 (first frame incl. compile "
        f"{compile_s:.1f} s) on {card}; noise frame 1 {n0:.5f} -> frame 8 "
        f"{n7:.5f}"
    )


def phase_kernel(ptsf, card):
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        pathtrace,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas import (
        pathtrace as pathtrace_kernel,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )

    td = ptsf.precompute_triangle_data(ptsf.Scene.cornell_box())
    cam, light = ptsf.Camera.default(), ptsf.Light.default()
    cfg = ptsf.RenderConfig(width=1920, height=1080)
    check(frame_mod.use_trace_kernel(cfg), "auto route is not the kernel")
    frame_idx = jnp.int32(5)
    kern = jax.jit(
        lambda td, c, l, f: pathtrace_kernel.path_trace_pass_pallas(
            td, c.position, l, f, cfg, rotation=c.rotation
        )
    )(td, cam, light, frame_idx)
    ref = jax.jit(
        lambda td, c, l, f: pathtrace.path_trace_pass(
            td, c.position, l, f, cfg, rotation=c.rotation
        )
    )(td, cam, light, frame_idx)
    kern, ref = np.asarray(kern), np.asarray(ref)
    check(bool(np.isfinite(kern).all()), "kernel trace has non-finite values")
    share = flip_share(kern, ref)
    check(share <= KERNEL_FLIP_SHARE, f"kernel vs XLA: {share} of pixels differ")

    outs = {}
    for backend in ("auto", "xla"):
        c = dataclasses.replace(cfg, backend=backend)
        hist = ptsf.init_history(td, c)
        for _ in range(3):
            rgb, hist = frame_mod.render_frame(td, cam, light, hist, c)
        outs[backend] = np.asarray(rgb)
    mad = float(np.abs(outs["auto"] - outs["xla"]).mean())
    check(mad <= KERNEL_DENOISED_MAD, f"kernel vs XLA denoised MAD {mad}")
    log(
        f"kernel vs XLA trace, 1920x1080, 32 bounces: {share:.2e} of pixels "
        f"differ by >1e-3 (limit {KERNEL_FLIP_SHARE}), max "
        f"{np.abs(kern - ref).max():.3g}; denoised frame 3 MAD {mad:.2e} "
        f"(limit {KERNEL_DENOISED_MAD})"
    )

    small = ptsf.RenderConfig(width=128, height=96)
    gpu = ptsf.Renderer(ptsf.Scene.cornell_box(), small)
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = ptsf.Renderer(
            ptsf.Scene.cornell_box(), dataclasses.replace(small, backend="xla")
        )
        for _ in range(3):
            cpu_rgb = cpu.step()
        cpu_rgb = np.asarray(cpu_rgb)
    for _ in range(3):
        gpu_rgb = gpu.step()
    gpu_rgb = np.asarray(gpu_rgb)
    share = flip_share(gpu_rgb, cpu_rgb)
    mad = float(np.abs(gpu_rgb - cpu_rgb).mean())
    check(share <= GPU_CPU_FLIP_SHARE, f"GPU vs CPU: {share} of pixels differ")
    check(mad <= GPU_CPU_DENOISED_MAD, f"GPU vs CPU denoised MAD {mad}")
    log(
        f"GPU kernel frame vs CPU XLA frame, 128x96, frame 3: {share:.2e} of "
        f"pixels differ by >1e-3 (limit {GPU_CPU_FLIP_SHARE}), MAD {mad:.2e} "
        f"(limit {GPU_CPU_DENOISED_MAD})"
    )

    gcfg = ptsf.RenderConfig(
        width=48, height=32, max_bounces=6, wavelet_iterations=3
    )
    noisy = np.asarray(
        pathtrace_kernel.path_trace_pass_pallas(
            td, cam.position, light, jnp.int32(7), gcfg
        )
    )
    results = {"pathtrace_48x32_f7": noisy}
    for name, extra in (("frame3_48x32", {}),
                        ("frame3_48x32_var", {"variance_guided": True})):
        c = dataclasses.replace(gcfg, **extra)
        hist = ptsf.init_history(td, c)
        for _ in range(3):
            rgb, hist = frame_mod.render_frame(td, cam, light, hist, c)
        results[name] = np.asarray(rgb)
    for name, got in results.items():
        share = flip_share(got, np.load(os.path.join(GOLDEN, name + ".npy")))
        check(share <= GOLDEN_FLIP_SHARE, f"golden {name}: {share} differ")
        log(f"golden {name} on the GPU kernel route: {share:.2e} of pixels "
            f"differ by >1e-3 (limit {GOLDEN_FLIP_SHARE})")


def phase_large(ptsf, card):
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        intersect,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )

    scene = ptsf.Scene.from_arrays(*procedural.subdivided_cornell(32))
    tris = scene.num_triangles
    check(tris == 32768, f"subdivided Cornell has {tris} triangles")
    cfg = ptsf.RenderConfig(width=1920, height=1080, backend="xla")
    block = intersect.triangle_block(1920 * 1080, tris)
    check(block < tris, "the large scene does not take the tiled route")
    r = ptsf.Renderer(scene, cfg)
    t0 = time.perf_counter()
    rgb = r.step()
    rgb.block_until_ready()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb = np.asarray(r.step())
    second_s = time.perf_counter() - t0
    check(bool(np.isfinite(rgb).all()), "large scene has non-finite values")
    check(float(rgb.std()) > 1e-3, "large scene frame is constant")
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
    log(
        f"large scene: {tris} triangles at 1920x1080 on the XLA route, "
        f"{-(-tris // block)} triangle blocks of {block}; frame 1 (incl. "
        f"compile) {first_s:.1f} s, frame 2 {second_s:.1f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB on {card}"
    )


def phase_four(ptsf, card):
    from real_time_path_tracing_with_spatiotemporal_filtering.parallel import (
        frame_sharded,
        sharding,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.pipeline import (
        frame as frame_mod,
    )

    check(len(jax.devices()) == 4, f"--four needs 4 GPUs, have {jax.devices()}")
    cfg = ptsf.RenderConfig(width=1920, height=1080)
    mesh = sharding.make_mesh(4)
    td = ptsf.precompute_triangle_data(ptsf.Scene.cornell_box())
    ledger = sharding.CommLedger()
    step = frame_sharded.make_sharded_frame(cfg, mesh, comm_ledger=ledger)
    hist_s = frame_sharded.init_sharded_history(td, cfg, mesh)
    hist_1 = ptsf.init_history(td, cfg)
    light = ptsf.Light.default()
    shares, mads = [], []
    t_sharded = []
    comm = None
    for i in range(5):
        cam = ptsf.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.02 * i, 1.0)
        t0 = time.perf_counter()
        rgb_s, hist_s, comm = step(td, cam, light, hist_s)
        rgb_s.block_until_ready()
        t_sharded.append(time.perf_counter() - t0)
        rgb_1, hist_1 = frame_mod.render_frame(td, cam, light, hist_1, cfg)
        a, b = np.asarray(rgb_s), np.asarray(rgb_1)
        check(bool(np.isfinite(a).all()), f"sharded frame {i} non-finite")
        shares.append(flip_share(a, b))
        mads.append(float(np.abs(a - b).mean()))
    comm = {k: int(v) for k, v in comm.items()}
    # Each slab runs the same per-pixel kernel on its global rows; only
    # the XLA passes see other shapes, which on the GPU may pick other
    # matmul algorithms, so the one-route limits above apply.
    check(max(shares) <= KERNEL_FLIP_SHARE, f"sharded vs one card: {shares}")
    check(max(mads) <= KERNEL_DENOISED_MAD, f"sharded vs one card: {mads}")
    check(comm["halo_bytes"] == ledger.halo_bytes > 0, f"halo bytes {comm}")
    log(
        f"four cards: 1920x1080 over a 4-way row mesh (270 rows each), 5 "
        f"orbit frames; vs one card: worst share of pixels off by >1e-3 "
        f"{max(shares):.2e}, worst MAD {max(mads):.2e}; halo bytes/"
        f"frame/device {comm['halo_bytes']}, gather bytes {comm['gather_bytes']}"
        f"; last frame {t_sharded[-1] * 1000:.2f} ms wall incl. sync on {card}"
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU row-sharded frame phase")
    args = parser.parse_args()

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU (platform {platform!r}); refusing to run",
              file=sys.stderr)
        return 1

    sys.path.insert(0, HERE)
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.utils.device import (
        enable_compile_cache,
    )

    enable_compile_cache()
    card = card_line()
    log(f"device: {devices}; {card}")
    if args.four:
        phase_four(ptsf, card)
    else:
        phase_main(ptsf, card)
        phase_kernel(ptsf, card)
        phase_large(ptsf, card)
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
