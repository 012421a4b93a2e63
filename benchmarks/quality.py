"""Denoising quality benchmark: rMSE vs a high-spp converged reference.

The repo's denoising-quality metric. A ground-truth image is accumulated
from many independent 1-spp frames (distinct frame seeds), then the
denoiser's steady-state output is compared against it alongside the raw
1-spp input, reporting the improvement factor.

Run: python -m benchmarks.quality [--spp 1024] [--size 256]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


_TRUTH_CACHE: dict = {}


def ground_truth(tri_data, camera, light, cfg, total_spp: int):
    """Average many independent 1-spp renders (each frame index is an
    independent PCG stream, raytrace.comp.glsl:297). Cached per config
    within the process: the CI quality bars share one truth across modes
    that differ only in filtering."""
    import jax
    import jax.numpy as jnp

    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        pathtrace,
    )

    import dataclasses as _dc

    # Normalize away filter-only fields: the trace truth is identical for
    # parity vs variance-guided filtering (RenderConfig is frozen/hashable).
    cfg = _dc.replace(
        cfg, variance_guided=False, adaptive_alpha=False,
        demodulate_albedo=False, path_gradient=False,
        # estimator-bias fields forced off: the truth is always the
        # unbiased full-resolution jittered estimator (gbuffer_primary has
        # no effect without a primary argument; normalized so seeded and
        # unseeded modes share one cached truth)
        indirect_split=0, indirect_jitter=False, truncate_radiance=False,
        gbuffer_primary=False,
    )
    key = (cfg, total_spp,
           np.asarray(camera.position).tobytes(),
           np.asarray(camera.rotation).tobytes(),
           np.asarray(light.position).tobytes())
    cached = _TRUTH_CACHE.get(key)
    if cached is not None:
        return cached

    fn = jax.jit(
        lambda f: pathtrace.path_trace_pass(
            tri_data, camera.position, light, f, cfg,
            rotation=camera.rotation,
        )
    )
    acc = np.zeros((cfg.height, cfg.width, 3), np.float64)
    for f in range(total_spp):
        acc += np.asarray(fn(jnp.int32(f + 1_000_000)))
    out = (acc / total_spp).astype(np.float32)
    _TRUTH_CACHE[key] = out
    return out


def run(
    size: int,
    spp: int,
    frames: int,
    variance_guided: bool = False,
    rr_start_bounce: int = 0,
    nee: bool = False,
    demodulate: bool = False,
    ramp: bool = False,
    orbit: float = 0.0,
    light_motion: float = 0.0,
    path_gradient: bool = False,
    width: int | None = None,
    height: int | None = None,
    indirect_split: int = 0,
    indirect_stride: int = 2,
    max_bounces: int = 32,
    gbuffer_primary: bool = False,
    indirect_jitter: bool = False,
):
    """One quality measurement. ``orbit`` (radians/frame): the camera
    orbits the scene center during accumulation and the final frame is
    compared against a high-spp truth AT THE FINAL CAMERA -- this measures
    reprojection lag and ghosting (what the accumulation ramp and the
    windowed reprojection act on), which the static-camera number cannot
    see.

    ``light_motion`` (units/frame along x): the light translates during
    accumulation and the truth is rendered AT THE FINAL LIGHT -- this
    measures shading-change lag (stale shadows/indirect light), the signal
    the temporal-gradient lambda exists to bound. ``path_gradient`` swaps
    in the A-SVGF path-space gradient (ops/pathgrad.py) on top of the
    reference's Phong proxy."""
    import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Camera,
        Light,
        precompute_triangle_data,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering.utils.image import (
        rmse,
    )

    cfg = ptsf.RenderConfig(
        width=width or size, height=height or size,
        variance_guided=variance_guided or demodulate,
        rr_start_bounce=rr_start_bounce, nee=nee,
        demodulate_albedo=demodulate,
        accumulation_ramp=ramp,
        # the A-SVGF dynamic configs
        adaptive_alpha=orbit != 0.0 or light_motion != 0.0 or path_gradient,
        path_gradient=path_gradient,
        # multi-res indirect (estimator bias measured against the
        # full-res truth; the truth normalizes these away)
        indirect_split=indirect_split,
        indirect_stride=indirect_stride,
        indirect_jitter=indirect_jitter,
        max_bounces=max_bounces,
        # G-buffer-seeded primaries (no primary AA jitter); the truth
        # keeps the jittered reference estimator, so this row measures
        # the mode's full bias (including the lost anti-aliasing)
        gbuffer_primary=gbuffer_primary,
    )
    scene = ptsf.Scene.cornell_box()
    td = precompute_triangle_data(scene)

    import dataclasses

    def light_at(i):
        l = Light.default()
        if light_motion == 0.0:
            return l
        return dataclasses.replace(
            l,
            position=np.asarray(l.position, np.float32)
            + np.array([light_motion * i, 0.0, 0.0], np.float32),
        )

    light = light_at(frames - 1)  # truth at the final light

    def cam_at(i):
        if orbit == 0.0:
            return Camera.default()
        return Camera.orbit([0.0, 1.0, 0.0], 6.0, orbit * i, 1.0)

    cam = cam_at(frames - 1)  # truth at the final camera

    # Ground truth is always RR-free (RR is unbiased, so the truth is the
    # same; keeping it exact avoids paying RR's variance twice). NEE stays
    # on for the truth when enabled: it changes the transport semantics
    # (no fall-through quirk, occluded light), not just the variance.
    truth = ground_truth(
        td, cam, light,
        dataclasses.replace(cfg, rr_start_bounce=0, path_gradient=False),
        spp,
    )

    r = ptsf.Renderer(scene, cfg, camera=cam_at(0), light=light_at(0))
    out = None
    for i in range(frames):
        r.camera = cam_at(i)
        r.light = light_at(i)
        out = np.asarray(r.step())

    # raw 1-spp noise level for the improvement factor
    import jax.numpy as jnp
    from real_time_path_tracing_with_spatiotemporal_filtering.ops import (
        pathtrace,
    )

    noisy = np.asarray(
        pathtrace.path_trace_pass(
            td, cam.position, light, jnp.int32(frames), cfg,
            rotation=cam.rotation,
        )
    )

    # clamp to displayable range: the HDR light pixels dominate rMSE
    # otherwise (the reference displays clamped output too)
    c = lambda x: np.clip(x, 0.0, 1.0)
    return {
        "rmse_denoised": rmse(c(out), c(truth)),
        "rmse_noisy_1spp": rmse(c(noisy), c(truth)),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument(
        "--width", type=int, default=None,
        help="non-square width (e.g. 1920 for the 1080p headline config)",
    )
    parser.add_argument(
        "--height", type=int, default=None,
        help="non-square height (e.g. 1080)",
    )
    parser.add_argument("--spp", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument(
        "--skip-variance", action="store_true",
        help="only measure reference-parity filtering",
    )
    parser.add_argument(
        "--rr-start-bounce", type=int, default=0,
        help="also measure with Russian roulette from this bounce "
        "(variance-guided mode only; quantifies RR's noise cost)",
    )
    parser.add_argument(
        "--demod", action="store_true",
        help="also measure with SVGF albedo demodulation (parity and "
        "variance-guided filtering of irradiance)",
    )
    parser.add_argument(
        "--nee", action="store_true",
        help="also measure with next-event estimation (variance-guided)",
    )
    parser.add_argument(
        "--ramp", action="store_true",
        help="also measure with the SVGF accumulation ramp "
        "(per-pixel history length, alpha floor ramp_alpha_min)",
    )
    parser.add_argument(
        "--orbit", type=float, default=0.0, metavar="RAD",
        help="orbit the camera by RAD radians/frame; the final frame is "
        "compared against a truth at the final camera (measures "
        "reprojection lag/ghosting; applies to every mode measured)",
    )
    parser.add_argument(
        "--light-motion", type=float, default=0.0, metavar="DX",
        help="translate the light by DX units/frame along x; the final "
        "frame is compared against a truth at the final light (measures "
        "shading-change lag; applies to every mode measured)",
    )
    parser.add_argument(
        "--path-gradient", action="store_true",
        help="also measure with the A-SVGF path-space temporal gradient "
        "(re-traced sparse samples; variance-guided mode)",
    )
    parser.add_argument(
        "--indirect", type=int, default=0, metavar="SPLIT",
        help="also measure multi-res indirect with this split bounce "
        "(variance-guided mode; bias vs the full-res truth)",
    )
    parser.add_argument(
        "--indirect-stride", type=int, default=2,
        help="coarse-grid stride of --indirect",
    )
    parser.add_argument(
        "--max-bounces", type=int, default=32,
        help="bounce cap for every measured mode AND the truth "
        "(8 = the interactive estimator)",
    )
    parser.add_argument(
        "--gbuffer-primary", action="store_true",
        help="also measure G-buffer-seeded primaries (no primary AA "
        "jitter) in variance-guided mode, with and without the "
        "--indirect split -- total bias vs the jittered truth",
    )
    parser.add_argument(
        "--multires-sweep", action="store_true",
        help="measure the shipped multi-res indirect points in one process "
        "(shared truth cache): variance-guided baseline, split@2 stride 2, "
        "split@2 stride 4, split@1 stride 4, split@1 stride 4 + G-buffer "
        "primaries, and the full interactive estimator stack "
        "(max_bounces=8 + RR@2 + split@1 stride 4 + primaries). Honors "
        "--size/--spp/--frames/--orbit.",
    )
    parser.add_argument(
        "--cpu", action="store_true", help="force the CPU backend"
    )
    args = parser.parse_args()
    if args.cpu:
        # set the config directly BEFORE any package import: the package's
        # module-scope jnp constants would initialize the default backend
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.multires_sweep:
        # the shipped (split, stride) points, measured
        # against the same full-res truth in one process. Rows at the
        # default bounce cap isolate the split's bias next to the
        # variance-guided bar; the final rows are the production
        # interactive estimator (suite row
        # ..._interactive_multires_gprimary_nonparity).
        points = [
            ("variance-guided baseline", {}),
            ("indirect split@2 stride 2", dict(indirect_split=2)),
            ("indirect split@2 stride 4",
             dict(indirect_split=2, indirect_stride=4)),
            ("indirect split@1 stride 4",
             dict(indirect_split=1, indirect_stride=4)),
            ("indirect split@1 stride 4 + G-buffer primaries",
             dict(indirect_split=1, indirect_stride=4,
                  gbuffer_primary=True)),
            ("interactive stack mb8 RR@2 split@1 stride 4 + primaries",
             dict(indirect_split=1, indirect_stride=4,
                  gbuffer_primary=True, max_bounces=8, rr_start_bounce=2)),
            # the same points with the per-frame grid-phase jitter
            # (cfg.indirect_jitter): the EMA integrates over phases, so
            # the static low-pass bias should shrink toward temporal noise
            ("indirect split@1 stride 4 + jitter",
             dict(indirect_split=1, indirect_stride=4,
                  indirect_jitter=True)),
            ("interactive stack + jitter",
             dict(indirect_split=1, indirect_stride=4,
                  gbuffer_primary=True, max_bounces=8, rr_start_bounce=2,
                  indirect_jitter=True)),
        ]
        for label, kw in points:
            stats = run(
                args.size, args.spp, args.frames, True,
                kw.pop("rr_start_bounce", 0),
                width=args.width, height=args.height, orbit=args.orbit,
                indirect_stride=kw.pop("indirect_stride", 2),
                **kw,
            )
            improvement = stats["rmse_noisy_1spp"] / max(
                stats["rmse_denoised"], 1e-12
            )
            if args.orbit:
                label += f" (orbit {args.orbit:g} rad/frame)"
            print(
                json.dumps(
                    {
                        "metric": (
                            f"denoised rMSE vs {args.spp}-spp reference, "
                            f"{args.width or args.size}x"
                            f"{args.height or args.size} Cornell "
                            f"(clamped [0,1]), {label}"
                        ),
                        "value": round(stats["rmse_denoised"], 6),
                        "unit": "rmse",
                        "noisy_1spp_rmse": round(stats["rmse_noisy_1spp"], 6),
                        "improvement_factor": round(improvement, 2),
                    }
                )
            )
            print(
                f"[{label}] denoised {stats['rmse_denoised']:.4f} vs noisy "
                f"{stats['rmse_noisy_1spp']:.4f} ({improvement:.1f}x)",
                file=sys.stderr,
            )
        return
    modes = [(False, 0, False, False, False, False, 0)] if args.skip_variance else [
        (False, 0, False, False, False, False, 0),
        (True, 0, False, False, False, False, 0),
    ]
    if args.rr_start_bounce:
        modes.append((True, args.rr_start_bounce, False, False, False, False, 0))
    if args.nee:
        modes.append((True, 0, True, False, False, False, 0))
    if args.demod:
        # demodulation requires the variance-normalized (scale-invariant)
        # luminance weight (config.py validation)
        modes.append((True, 0, False, True, False, False, 0))
    if args.ramp:
        modes.append((True, 0, False, False, True, False, 0))
    if args.path_gradient:
        modes.append((True, 0, False, False, args.ramp, True, 0))
    if args.indirect:
        # like-for-like: the multi-res row keeps the same RR setting so
        # the delta against the variance-guided row isolates the split
        modes.append(
            (True, args.rr_start_bounce, False, False, False, False,
             args.indirect)
        )
    if args.gbuffer_primary:
        # variance-guided + G-buffer primaries, then the full interactive
        # estimator stack (split + seed) when --indirect is also given
        modes.append(
            (True, args.rr_start_bounce, False, False, False, False, 0, True)
        )
        if args.indirect:
            modes.append(
                (True, args.rr_start_bounce, False, False, False, False,
                 args.indirect, True)
            )
    for variance_guided, rr, nee, demod, ramp, pg, ind, *rest in modes:
        gp = bool(rest[0]) if rest else False
        stats = run(
            args.size, args.spp, args.frames, variance_guided, rr, nee,
            width=args.width, height=args.height,
            demodulate=demod, ramp=ramp, orbit=args.orbit,
            light_motion=args.light_motion, path_gradient=pg,
            indirect_split=ind, indirect_stride=args.indirect_stride,
            max_bounces=args.max_bounces, gbuffer_primary=gp,
        )
        improvement = stats["rmse_noisy_1spp"] / max(
            stats["rmse_denoised"], 1e-12
        )
        mode = "variance-guided SVGF" if variance_guided else "reference parity"
        if rr:
            mode += f" + RR@{rr}"
        if nee:
            mode += " + NEE"
        if demod:
            mode += " + albedo demod"
        if ramp:
            mode += " + accumulation ramp"
        if pg:
            mode += " + path gradient"
        if ind:
            mode += f" + indirect split@{ind} stride {args.indirect_stride}"
        if gp:
            mode += " + G-buffer primaries"
        if args.max_bounces != 32:
            mode += f" (mb{args.max_bounces})"
        if args.orbit:
            mode += f" (orbit {args.orbit:g} rad/frame)"
        if args.light_motion:
            mode += f" (light {args.light_motion:g} u/frame)"
        print(
            json.dumps(
                {
                    "metric": (
                        f"denoised rMSE vs {args.spp}-spp reference, "
                        f"{args.width or args.size}x"
                        f"{args.height or args.size} Cornell "
                        f"(clamped [0,1]), {mode}"
                    ),
                    "value": round(stats["rmse_denoised"], 6),
                    "unit": "rmse",
                    "noisy_1spp_rmse": round(stats["rmse_noisy_1spp"], 6),
                    "improvement_factor": round(improvement, 2),
                }
            )
        )
        print(
            f"[{mode}] denoised {stats['rmse_denoised']:.4f} vs noisy "
            f"{stats['rmse_noisy_1spp']:.4f} ({improvement:.1f}x better)",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
