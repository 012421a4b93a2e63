"""Model zoo: preconfigured scene + config bundles.

A renderer's "model families" are its scene/config presets. Each factory
returns a ready-to-step Renderer; the presets mirror the benchmark
configurations (benchmarks/suite.py) so users reproduce them in one call.
"""

from real_time_path_tracing_with_spatiotemporal_filtering.models.presets import (
    cornell_box_realtime,
    cornell_box_reference,
    cornell_box_quality,
    cornell_stress,
    custom_obj,
)

__all__ = [
    "cornell_box_realtime",
    "cornell_box_reference",
    "cornell_box_quality",
    "cornell_stress",
    "custom_obj",
]
