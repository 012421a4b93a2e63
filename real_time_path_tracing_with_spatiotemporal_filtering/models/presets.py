"""Preset renderer factories (the framework's model zoo)."""

from __future__ import annotations

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.renderer import (
    Renderer,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Scene,
)


def cornell_box_reference(**overrides) -> Renderer:
    """Exact reference-parity setup: 1000x800, 1 spp, 32 bounces, 9 wavelet
    iterations, quirks on (main.cpp:52-72 and shader constants)."""
    return Renderer(Scene.cornell_box(), RenderConfig(**overrides))


def cornell_box_realtime(**overrides) -> Renderer:
    """The headline benchmark shape: 1080p 1spp full A-SVGF."""
    cfg = RenderConfig(**{"width": 1920, "height": 1080, **overrides})
    return Renderer(Scene.cornell_box(), cfg)


def cornell_box_quality(**overrides) -> Renderer:
    """Quality-leaning: 4 spp, adaptive temporal alpha (the reference's
    commented-out gradient-driven blend, temporalFiltering:246-248), plus
    the framework's estimator/filter extensions: next-event estimation
    (low-variance direct light, shadows respect occluders) and the
    variance-guided SVGF weights."""
    cfg = RenderConfig(
        **{"width": 1920, "height": 1080, "spp": 4, "adaptive_alpha": True,
           "nee": True, "variance_guided": True, "accumulation_ramp": True,
           **overrides}
    )
    return Renderer(Scene.cornell_box(), cfg)


def cornell_box_interactive(**overrides) -> Renderer:
    """Speed-leaning non-parity preset: Russian roulette from bounce 4
    (unbiased; expected path length drops from max_bounces to ~1/(1-albedo))
    with the variance-guided filter absorbing the extra sample noise. On
    enclosed scenes -- where every path otherwise runs all 32 segments --
    this is the single biggest throughput lever at any scene size."""
    cfg = RenderConfig(
        **{"width": 1920, "height": 1080, "rr_start_bounce": 4,
           "variance_guided": True, "accumulation_ramp": True,
           "adaptive_alpha": True, **overrides}
    )
    return Renderer(Scene.cornell_box(), cfg)


def cornell_stress(splits: int = 4, **overrides) -> Renderer:
    """Traversal stress: each Cornell quad subdivided splits^2-fold
    (32 * splits**2 triangles, identical image) -- exercises pair merging
    and Morton-cluster culling."""
    from real_time_path_tracing_with_spatiotemporal_filtering.scene import (
        procedural,
    )

    scene = Scene.from_arrays(*procedural.subdivided_cornell(splits))
    cfg = RenderConfig(**{"width": 1920, "height": 1080, **overrides})
    return Renderer(scene, cfg)


def custom_obj(path: str, **overrides) -> Renderer:
    """Any OBJ scene (native C++ loader when built, Python fallback)."""
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.obj import (
        load_obj,
    )

    scene = Scene.from_arrays(*load_obj(path))
    return Renderer(scene, RenderConfig(**overrides))
