"""Render any OBJ scene (the reference hardcodes its scene path,
main.cpp:417; here it is an argument).

Any scene size renders (the trace kernel loops over every triangle, the
XLA route scans triangle blocks); add --rr to bound path lengths
(unbiased Russian roulette, non-parity).

Run:  python examples/render_obj.py scene.obj [out.png] [--rr]
"""

import sys

import numpy as np

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
from real_time_path_tracing_with_spatiotemporal_filtering.utils.image import (
    write_png,
)


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--rr"]
    rr = "--rr" in sys.argv
    path = args[0] if args else None
    out = args[1] if len(args) > 1 else "render.png"
    cfg = ptsf.RenderConfig(
        width=1280, height=720, rr_start_bounce=4 if rr else 0
    )
    scene = ptsf.Scene.from_arrays(*ptsf.load_obj(path))  # None = default scene
    renderer = ptsf.Renderer(scene, cfg)
    rgb = renderer.render(num_frames=20)
    write_png(out, np.asarray(rgb))
    print(f"wrote {out}: {scene.num_triangles} triangles")


if __name__ == "__main__":
    main()
