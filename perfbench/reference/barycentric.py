"""Area-based barycentric coordinates.

The reference recomputes barycentrics from world positions via triangle
areas for both the temporal gradient (temporalGradient.comp.glsl:50-69) and
the filter's backprojection (temporalFiltering.comp.glsl:157-176). That
exact formulation (not the usual edge-function one) keeps reprojection
behavior the same.
"""

from __future__ import annotations

import torch

from .camera import (
    cross3,
    norm3,
)


def triangle_area(v0, v1, v2):
    """getAreaOfTriangle: |cross(v1-v0, v2-v0)| / 2."""
    return 0.5 * norm3(cross3(v1 - v0, v2 - v0))


def barycentric_coordinates(p, v0, v1, v2, eps: float = 1e-20):
    """getBarycentricCoordinates: (A_pbc, A_apc, A_abp) / A_abc.

    Shapes broadcast over leading dims; returns (..., 3). ``eps`` guards the
    degenerate (zero-area) triangle the reference would divide by zero on
    (slot 0 of the visibility LUT is all-zeros).
    """
    total = torch.clamp_min(triangle_area(v0, v1, v2), eps)
    a1 = triangle_area(p, v1, v2)
    a2 = triangle_area(v0, p, v2)
    a3 = triangle_area(v0, v1, p)
    return torch.stack([a1, a2, a3], dim=-1) / total[..., None]
