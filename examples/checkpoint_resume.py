"""Exact mid-sequence checkpoint/resume (a capability the reference lacks:
its only restart is relaunching the app and losing temporal history).

Renders 10 frames, saves, renders 10 more; then reloads the checkpoint in
a fresh renderer and re-renders the same 10 -- bit-identical.

Run:  python examples/checkpoint_resume.py
"""

import tempfile

import numpy as np

import real_time_path_tracing_with_spatiotemporal_filtering as ptsf

cfg = ptsf.RenderConfig(width=320, height=240, max_bounces=8)
scene = ptsf.Scene.cornell_box()

r = ptsf.Renderer(scene, cfg)
r.render(10)
with tempfile.NamedTemporaryFile(suffix=".npz") as f:
    r.save_state(f.name)
    a = np.asarray(r.render(10))

    r2 = ptsf.Renderer(scene, cfg)
    r2.load_state(f.name)
    b = np.asarray(r2.render(10))

assert np.array_equal(a, b), "resume must be exact"
print(f"resume bit-identical at frame {r.frame_count}")
