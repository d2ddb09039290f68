"""Wavefront OBJ loading, pure Python.

Quads and higher n-gons are fan-triangulated exactly like tinyobjloader's
default ((0, i, i+1) for i in 1..n-2), keeping primitive IDs aligned with the
reference's BLAS/raster primitive order -- the visibility LUT and all
temporal reprojection are keyed on those IDs.
"""

from __future__ import annotations

import os

import numpy as np


def parse_obj(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse OBJ source into (vertices (V, 3) f32, indices (T, 3) i32)."""
    vertices: list[tuple[float, float, float]] = []
    triangles: list[tuple[int, int, int]] = []

    def resolve(token: str) -> int:
        # "v", "v/vt", "v//vn", "v/vt/vn"; negative indices are relative.
        idx = int(token.split("/", 1)[0])
        if idx < 0:
            return len(vertices) + idx
        return idx - 1

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "v" and len(parts) >= 4:
            vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif parts[0] == "f" and len(parts) >= 4:
            corners = [resolve(tok) for tok in parts[1:]]
            for i in range(1, len(corners) - 1):
                triangles.append((corners[0], corners[i], corners[i + 1]))

    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    idx = np.asarray(triangles, np.int32).reshape(-1, 3)
    if idx.size and (idx.min() < 0 or idx.max() >= len(verts)):
        raise ValueError("OBJ face index out of range")
    return verts, idx


def load_obj(path: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file as (vertices (V, 3) float32, indices (T, 3) int32).

    ``None`` gives the reference's only scene, the Cornell box
    (main.cpp:417), generated procedurally.
    """
    if path is None:
        from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import (
            procedural,
        )

        return procedural.cornell_box()
    if not os.path.exists(path):
        raise FileNotFoundError(f"OBJ file not found: {path!r}")
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_obj(f.read())
