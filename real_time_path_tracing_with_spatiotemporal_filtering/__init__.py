"""Real-time path tracing with spatiotemporal (A-SVGF) filtering in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the Vulkan/GLSL
reference renderer (OnurBasci/Real_Time_Path_Tracing_With_SpatioTemporal_
Filtering). The reference's four GPU passes (rasterized visibility G-buffer,
temporal-gradient estimate, VK_KHR_ray_query path trace, 9x a-trous wavelet
filter with temporal EMA -- /root/reference/main.cpp:1090-1113) are redesigned
as one pure, jitted frame function over a ``History`` pytree, with a
per-pixel Pallas (Triton) path-trace kernel on NVIDIA GPUs and ``shard_map``
image-space data parallelism across a device mesh.

Public API:
    RenderConfig     -- every tunable the reference hardcodes (common.h etc.)
    Scene / load_obj -- OBJ scenes (Cornell Box first)
    Camera, Light    -- frame inputs
    History          -- cross-frame state pytree
    render_frame     -- (scene, camera, light, history, cfg) -> (rgb, history')
    Renderer         -- stateful convenience wrapper + checkpointing
"""

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    TriangleData,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.obj import (
    load_obj,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.history import (
    History,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.frame import (
    init_history,
    render_frame,
)
from real_time_path_tracing_with_spatiotemporal_filtering.pipeline.renderer import (
    Renderer,
)

__all__ = [
    "RenderConfig",
    "Scene",
    "TriangleData",
    "Camera",
    "Light",
    "History",
    "load_obj",
    "precompute_triangle_data",
    "init_history",
    "render_frame",
    "Renderer",
]

__version__ = "0.1.0"
