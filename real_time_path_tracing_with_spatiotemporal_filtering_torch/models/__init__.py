"""Model zoo: preconfigured scene + config bundles.

A renderer's "model families" are its scene/config presets. Each factory
returns a ready-to-step Renderer on ``device`` (default: the card when there
is one); the presets mirror the JAX package's (its models/presets.py).
"""

from real_time_path_tracing_with_spatiotemporal_filtering_torch.models.presets import (
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
