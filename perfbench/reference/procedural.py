"""Procedural scene generation: the reference's Cornell box.

The reference ships exactly one scene: the merged "CornellBox-Original"
model (Morgan McGuire's Computer Graphics Archive data; reference
scenes/CornellBox-Original-Merged.obj, loaded at main.cpp:417). The geometry
is generated procedurally instead of vendoring the asset: 64 vertices in 16
independent quads (every face has its own 4 vertices), fan-triangulated to
32 triangles in the same primitive order tinyobjloader produces -- primitive
IDs must line up because the visibility LUT and temporal reprojection are
keyed on them.
"""

from __future__ import annotations

import numpy as np

# One row per quad: 4 (x, y, z) corners, in the OBJ's winding order.
# Blocks: floor, ceiling, back wall, right wall (green, -x normal), left
# wall (red, +x normal), short box (5 quads), tall box (5 quads), light
# panel. The reference OBJ lists the short box's front quad before its right
# quad (face order swap) -- preserved via _QUAD_ORDER below.
_CORNELL_QUADS = np.array(
    [
        # floor (y = 0)
        [[-1.01, 0.0, 0.99], [1.0, 0.0, 0.99], [1.0, 0.0, -1.04], [-0.99, 0.0, -1.04]],
        # ceiling (y = 1.99)
        [[-1.02, 1.99, 0.99], [-1.02, 1.99, -1.04], [1.0, 1.99, -1.04], [1.0, 1.99, 0.99]],
        # back wall (z = -1.04)
        [[-0.99, 0.0, -1.04], [1.0, 0.0, -1.04], [1.0, 1.99, -1.04], [-1.02, 1.99, -1.04]],
        # right wall (x = 1, normal -x -> green in raytrace.comp.glsl:158)
        [[1.0, 0.0, -1.04], [1.0, 0.0, 0.99], [1.0, 1.99, 0.99], [1.0, 1.99, -1.04]],
        # left wall (x ~ -1, normal +x -> red in raytrace.comp.glsl:155)
        [[-1.01, 0.0, 0.99], [-0.99, 0.0, -1.04], [-1.02, 1.99, -1.04], [-1.02, 1.99, 0.99]],
        # short box: top
        [[0.53, 0.6, 0.75], [0.7, 0.6, 0.17], [0.13, 0.6, 0.0], [-0.05, 0.6, 0.57]],
        # short box: left
        [[-0.05, 0.0, 0.57], [-0.05, 0.6, 0.57], [0.13, 0.6, 0.0], [0.13, 0.0, 0.0]],
        # short box: front
        [[0.53, 0.0, 0.75], [0.53, 0.6, 0.75], [-0.05, 0.6, 0.57], [-0.05, 0.0, 0.57]],
        # short box: right
        [[0.7, 0.0, 0.17], [0.7, 0.6, 0.17], [0.53, 0.6, 0.75], [0.53, 0.0, 0.75]],
        # short box: back
        [[0.13, 0.0, 0.0], [0.13, 0.6, 0.0], [0.7, 0.6, 0.17], [0.7, 0.0, 0.17]],
        # tall box: top
        [[-0.53, 1.2, 0.09], [0.04, 1.2, -0.09], [-0.14, 1.2, -0.67], [-0.71, 1.2, -0.49]],
        # tall box: left
        [[-0.53, 0.0, 0.09], [-0.53, 1.2, 0.09], [-0.71, 1.2, -0.49], [-0.71, 0.0, -0.49]],
        # tall box: back
        [[-0.71, 0.0, -0.49], [-0.71, 1.2, -0.49], [-0.14, 1.2, -0.67], [-0.14, 0.0, -0.67]],
        # tall box: right
        [[-0.14, 0.0, -0.67], [-0.14, 1.2, -0.67], [0.04, 1.2, -0.09], [0.04, 0.0, -0.09]],
        # tall box: front
        [[0.04, 0.0, -0.09], [0.04, 1.2, -0.09], [-0.53, 1.2, 0.09], [-0.53, 0.0, 0.09]],
        # light panel (y = 1.98)
        [[-0.24, 1.98, 0.16], [-0.24, 1.98, -0.22], [0.23, 1.98, -0.22], [0.23, 1.98, 0.16]],
    ],
    np.float32,
)

# Face emission order in the OBJ: [0..7, 8<->9 swapped, 10..15].
_QUAD_ORDER = [0, 1, 2, 3, 4, 5, 6, 7, 9, 8, 10, 11, 12, 13, 14, 15]


def cornell_box() -> tuple[np.ndarray, np.ndarray]:
    """The reference scene as (vertices (64, 3), indices (32, 3)).

    Vertex and primitive order match what tinyobjloader produces from the
    reference OBJ (quads fan-triangulated as (0,1,2), (0,2,3)).
    """
    quads = _CORNELL_QUADS[_QUAD_ORDER]
    vertices = quads.reshape(-1, 3)
    indices = []
    for q in range(len(quads)):
        base = 4 * q
        indices.append((base, base + 1, base + 2))
        indices.append((base, base + 2, base + 3))
    return vertices.copy(), np.asarray(indices, np.int32)

