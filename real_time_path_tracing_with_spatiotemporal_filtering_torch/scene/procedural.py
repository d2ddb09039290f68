"""Procedural scene generation: the reference's Cornell box.

The reference ships exactly one scene: the merged "CornellBox-Original"
model (Morgan McGuire's Computer Graphics Archive data; reference
scenes/CornellBox-Original-Merged.obj, loaded at main.cpp:417). The geometry
is generated procedurally instead of vendoring the asset: 64 vertices in 16
independent quads (every face has its own 4 vertices), fan-triangulated to
32 triangles in the same primitive order tinyobjloader produces -- primitive
IDs must line up because the visibility LUT and temporal reprojection are
keyed on them.

Also synthetic stress scenes (subdivided boxes, random triangle soups) and
an OBJ writer for loader round trips, each equal to the JAX package's.
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


# The writer's header line. It names the JAX package so that both packages
# write the same bytes for the same arrays.
_OBJ_HEADER = "# generated by real_time_path_tracing_with_spatiotemporal_filtering_tpu"


def write_obj(path: str, vertices: np.ndarray, indices: np.ndarray) -> None:
    """Emit an OBJ file (quad-free, triangles as-is) for loader round trips:
    ``%.6f`` coordinates and 1-based faces."""
    lines = [_OBJ_HEADER]
    for v in vertices:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    for tri in indices:
        lines.append(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def random_soup(
    num_triangles: int,
    seed: int = 0,
    extent: float = 1.0,
    tri_size: float = 0.05,
) -> tuple[np.ndarray, np.ndarray]:
    """Random triangle soup for traversal stress tests, from ``seed``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (num_triangles, 1, 3))
    offsets = rng.normal(0.0, tri_size, (num_triangles, 3, 3))
    vertices = (centers + offsets).astype(np.float32).reshape(-1, 3)
    indices = np.arange(num_triangles * 3, dtype=np.int32).reshape(-1, 3)
    return vertices, indices


def subdivided_cornell(splits: int) -> tuple[np.ndarray, np.ndarray]:
    """Cornell Box with each quad split into a splits x splits grid.

    Produces 32 * splits**2 triangles with identical geometry -- a scaling
    series for traversal work without changing the image. Bit-identical to
    the JAX package's: the u/v fractions are formed in float64 and rounded
    to float32.
    """
    quads = _CORNELL_QUADS[_QUAD_ORDER].astype(np.float32)
    u64 = np.arange(splits + 1, dtype=np.float64) / splits
    u = u64.astype(np.float32)
    om = (1.0 - u64).astype(np.float32)
    # corners in winding order: p00, p10, p11, p01 = quad[0..3]
    a = quads[:, None, 0, :] * om[None, :, None] + quads[:, None, 1, :] * u[None, :, None]
    b = quads[:, None, 3, :] * om[None, :, None] + quads[:, None, 2, :] * u[None, :, None]
    grid = (
        a[:, :, None, :] * om[None, None, :, None]
        + b[:, :, None, :] * u[None, None, :, None]
    )  # (quads, splits+1, splits+1, 3) bilinear lattice
    v00 = grid[:, :-1, :-1]
    v10 = grid[:, 1:, :-1]
    v11 = grid[:, 1:, 1:]
    v01 = grid[:, :-1, 1:]
    vertices = np.stack([v00, v10, v11, v01], axis=3).reshape(-1, 3)
    n_cells = quads.shape[0] * splits * splits
    base = 4 * np.arange(n_cells, dtype=np.int32)
    tri1 = np.stack([base, base + 1, base + 2], axis=1)
    tri2 = np.stack([base, base + 2, base + 3], axis=1)
    indices = np.stack([tri1, tri2], axis=1).reshape(-1, 3)
    return vertices.astype(np.float32), indices.astype(np.int32)
