"""Real-time path tracing with spatiotemporal (A-SVGF) filtering, in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``real_time_path_tracing_with_spatiotemporal_filtering_tpu``
(the JAX package, which stays the reference). The reference's four GPU passes
(visibility G-buffer, temporal gradient, path trace, 9x a-trous wavelet
filter with temporal EMA), and the SVGF and estimator extensions on them,
run through hand-written CUDA kernels on a CUDA device and through their
plain PyTorch versions on the CPU. Preset renderers are in ``models``. This
package imports torch and numpy, never jax.

Public API (the JAX package's names):
    RenderConfig     -- every tunable the reference hardcodes (common.h etc.)
    Scene / load_obj -- OBJ scenes (Cornell Box first)
    Camera, Light    -- frame inputs
    History          -- cross-frame state
    render_frame     -- (scene, camera, light, history, cfg) -> (rgb, history')
    Renderer         -- stateful convenience wrapper + checkpointing
"""

from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
    Scene,
    TriangleData,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.obj import (
    load_obj,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.history import (
    History,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.frame import (
    init_history,
    render_frame,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.renderer import (
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
