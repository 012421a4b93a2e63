"""Minimal end-to-end render: the reference's default scene and settings.

Equivalent of building and launching the reference app (main.cpp:179-308)
headlessly: Cornell Box, 1000x800, 1 spp, full A-SVGF denoising, 30 frames
of temporal accumulation, PNG out.

Run:  python examples/render_cornell.py [out.png]
"""

import sys

import numpy as np

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf
from real_time_path_tracing_with_spatiotemporal_filtering.utils.image import (
    write_png,
)


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else "cornell.png"
    renderer = ptsf.Renderer(ptsf.Scene.cornell_box(), ptsf.RenderConfig())
    rgb = renderer.render(num_frames=30)
    write_png(out, np.asarray(rgb))
    print(f"wrote {out} after {renderer.frame_count} frames")


if __name__ == "__main__":
    main()
