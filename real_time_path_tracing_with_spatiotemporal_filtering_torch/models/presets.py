"""Preset renderer factories (the framework's model zoo), as in the JAX
package. Each takes the config overrides of the JAX factories and the
``device`` of :class:`Renderer` (None: the card when there is one)."""

from __future__ import annotations

from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.renderer import (
    Renderer,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Scene,
)


def cornell_box_reference(device=None, **overrides) -> Renderer:
    """Exact reference-parity setup: 1000x800, 1 spp, 32 bounces, 9 wavelet
    iterations, quirks on (main.cpp:52-72 and shader constants)."""
    return Renderer(Scene.cornell_box(), RenderConfig(**overrides), device=device)


def cornell_box_realtime(device=None, **overrides) -> Renderer:
    """The headline benchmark shape: 1080p 1spp full A-SVGF."""
    cfg = RenderConfig(**{"width": 1920, "height": 1080, **overrides})
    return Renderer(Scene.cornell_box(), cfg, device=device)


def cornell_box_quality(device=None, **overrides) -> Renderer:
    """Quality-leaning: 4 spp, adaptive temporal alpha (the reference's
    commented-out gradient-driven blend, temporalFiltering:246-248), plus
    the estimator/filter extensions: next-event estimation (low-variance
    direct light, shadows respect occluders), the variance-guided SVGF
    weights and the accumulation ramp."""
    cfg = RenderConfig(
        **{"width": 1920, "height": 1080, "spp": 4, "adaptive_alpha": True,
           "nee": True, "variance_guided": True, "accumulation_ramp": True,
           **overrides}
    )
    return Renderer(Scene.cornell_box(), cfg, device=device)


def cornell_box_interactive(device=None, **overrides) -> Renderer:
    """Speed-leaning non-parity preset: Russian roulette from bounce 4
    (unbiased; expected path length drops from max_bounces to ~1/(1-albedo))
    with the variance-guided filter absorbing the extra sample noise."""
    cfg = RenderConfig(
        **{"width": 1920, "height": 1080, "rr_start_bounce": 4,
           "variance_guided": True, "accumulation_ramp": True,
           "adaptive_alpha": True, **overrides}
    )
    return Renderer(Scene.cornell_box(), cfg, device=device)


def cornell_stress(splits: int = 4, device=None, **overrides) -> Renderer:
    """Traversal stress: each Cornell quad subdivided splits^2-fold
    (32 * splits**2 triangles, identical image). The kernel route holds at
    most the triangles its shared-memory tables take (ops/cuda/); beyond
    that it raises, and backend="xla" runs the plain route."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import (
        procedural,
    )

    scene = Scene.from_arrays(*procedural.subdivided_cornell(splits))
    cfg = RenderConfig(**{"width": 1920, "height": 1080, **overrides})
    return Renderer(scene, cfg, device=device)


def custom_obj(path: str, device=None, **overrides) -> Renderer:
    """Any OBJ scene (the pure-Python parser, scene/obj.py)."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.obj import (
        load_obj,
    )

    scene = Scene.from_arrays(*load_obj(path))
    return Renderer(scene, RenderConfig(**overrides), device=device)
