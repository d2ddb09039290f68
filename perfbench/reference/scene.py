"""Scene, camera, light and the precomputed triangle tables.

The reference's scene state is a pile of Vulkan buffers (vertex/index
buffers, visibility LUT, UBO matrices -- main.cpp:357-407, 471-478) mutated
in place. Here the frame inputs are frozen dataclasses of tensors.
``TriangleData`` is the device-resident, precomputed form: intersection
planes, per-triangle unit normals, albedos, and the (T+1, 3, 3) visibility
LUT (slot 0 reserved for background, visibility.geom.glsl:32-35). The tables
are built once on the host and copied to the device; under a per-frame model
matrix they are rebuilt from the moved vertices on the device
(:func:`transform_triangle_data`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import (
    cross3,
    dot3,
    mat_apply,
)
from .intersect import (
    TrianglePlanes,
)
from .shading import (
    albedo_from_normal,
)
from . import lbvh


def _f32(values, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=device)


def tensors_to(obj, device):
    """A copy of a dataclass of tensors (Camera, Light) on ``device``."""
    return dataclasses.replace(
        obj,
        **{f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)},
    )


@dataclasses.dataclass(frozen=True)
class Scene:
    """Triangle mesh in world space (model transform pre-applied; the
    reference's model matrix is always identity, main.cpp:482/1470)."""

    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray   # (T, 3) int32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def triangles(self) -> np.ndarray:
        """(T, 3, 3) gathered triangle vertices."""
        return self.vertices[self.indices]

    @classmethod
    def from_arrays(cls, vertices, indices) -> "Scene":
        return cls(
            vertices=np.asarray(vertices, np.float32),
            indices=np.asarray(indices, np.int32),
        )

    @classmethod
    def cornell_box(cls) -> "Scene":
        from . import (
            procedural,
        )

        return cls.from_arrays(*procedural.cornell_box())


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. The reference camera never rotates (rays go along
    -z, raytrace.comp.glsl:319; view is a translation, main.cpp:1471), so
    ``rotation`` defaults to identity; it is a camera->world basis
    (columns = right, up, back)."""

    position: torch.Tensor  # (3,) float32
    rotation: torch.Tensor  # (3, 3) float32, camera->world

    @classmethod
    def default(cls, device=None) -> "Camera":
        # main.cpp:65 cameraOrigin(-0.001, 1.0, 6.0)
        return cls(
            position=_f32([-0.001, 1.0, 6.0], device),
            rotation=_f32(np.eye(3), device),
        )

    @classmethod
    def looking_at(cls, position, target, up=(0.0, 1.0, 0.0), device=None) -> "Camera":
        """Camera at ``position`` looking at ``target`` (the JAX package's
        float32 numpy construction, so both get the same matrices)."""
        p = np.asarray(position, np.float32)
        f = np.asarray(target, np.float32) - p
        f = f / np.linalg.norm(f)
        u = np.asarray(up, np.float32)
        r = np.cross(f, u)
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        rot = np.stack([r, u, -f], axis=1)  # columns: right, up, back
        return cls(position=_f32(p, device), rotation=_f32(rot, device))

    @classmethod
    def orbit(cls, center, radius, azimuth, height, device=None) -> "Camera":
        """Orbit around ``center`` at ``radius``, looking in."""
        c = np.asarray(center, np.float32)
        pos = c + np.array(
            [radius * np.sin(azimuth), height, radius * np.cos(azimuth)], np.float32
        )
        return cls.looking_at(pos, c, device=device)


@dataclasses.dataclass(frozen=True)
class Light:
    """Analytic sphere light (raytrace.comp.glsl:26-30, 278-282). ``color``
    is the LDR base color; kernels scale by cfg.light_intensity."""

    position: torch.Tensor  # (3,) float32
    color: torch.Tensor     # (3,) float32

    @classmethod
    def default(cls, device=None) -> "Light":
        # main.cpp:70-72: lightPos(1, 1.0, -0.4), lightColor(0.5, 0.5, 0.5)
        return cls(
            position=_f32([1.0, 1.0, -0.4], device),
            color=_f32([0.5, 0.5, 0.5], device),
        )


@dataclasses.dataclass(frozen=True)
class TriangleData:
    """Precomputed device-side triangle tables.

    ``lut`` is the visibility LUT: world-space triangle vertices at slot
    primID+1 with slot 0 zeroed for background -- the same layout the
    reference's geometry shader scatters every frame
    (visibility.geom.glsl:32-35). ``lut_normals`` caches
    getNormalFromTriangleIndex (temporalFiltering.comp.glsl:80-91): slot 0
    is the background sentinel normal (0, 0, 1). ``bvh`` is the packed LBVH
    of the triangles (scene/lbvh.py), built once with the tables.
    """

    planes: TrianglePlanes     # intersection constants, all (T, ...)
    normals: torch.Tensor      # (T, 3) unit geometric normals (raytrace:150)
    albedo: torch.Tensor       # (T, 3) hardcoded material (raytrace:155-163)
    lut: torch.Tensor          # (T+1, 3, 3) visibility LUT
    lut_normals: torch.Tensor  # (T+1, 3) filter normals w/ background slot
    bvh: lbvh.PackedBVH        # node table and triangle-test rows

    @property
    def num_triangles(self) -> int:
        return self.normals.shape[0]


def triangle_tables(tris: torch.Tensor) -> dict:
    """All tables from (T, 3, 3) float32 vertices, on their device, keyed
    like :func:`triangle_data_from_numpy` takes them, plus the LBVH's
    triangle-test rows ``tests`` (scene/lbvh.pack_triangle_tests). Each
    3-term sum is (a + b) + c, the cross products are np.cross's, and the
    square root is rounded once (through float64: PyTorch's float32 square
    root on the CPU is not always the nearest), so the host's build of the
    rest pose, the plain move and csrc/model.cu compute the same bits.
    Within 1 ulp of the JAX package's jnp build (its cross products use
    FMA)."""
    v0 = tris[:, 0, :]
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    n = cross3(e1, e2)
    nn = dot3(n, n)[:, None]
    inv_nn = torch.ones_like(nn) / nn
    n1 = cross3(e2, n) * inv_nn
    n2 = cross3(n, e1) * inv_nn
    normals = n / torch.sqrt(nn.double()).float()
    d0, d1, d2 = dot3(n, v0), -dot3(n1, v0), -dot3(n2, v0)
    background = torch.zeros_like(normals[:1])  # the sentinel normal (0, 0, 1)
    background[:, 2] = 1.0
    return dict(
        v0=v0, e1=e1, e2=e2, n=n, d0=d0, n1=n1, d1=d1, n2=n2, d2=d2,
        normals=normals,
        albedo=albedo_from_normal(normals),
        lut=torch.cat([torch.zeros_like(tris[:1]), tris]),
        lut_normals=torch.cat([background, normals]),
        tests=torch.cat([n, d0[:, None], n1, d1[:, None], n2, d2[:, None]], dim=1),
    )


def from_tables(tables: dict, bvh: lbvh.PackedBVH) -> TriangleData:
    """TriangleData of the tensors of :func:`triangle_tables` and ``bvh``."""
    return TriangleData(
        planes=TrianglePlanes(*(tables[f] for f in TrianglePlanes._fields)),
        normals=tables["normals"],
        albedo=tables["albedo"],
        lut=tables["lut"],
        lut_normals=tables["lut_normals"],
        bvh=bvh,
    )


def triangle_data_from_numpy(arrays: dict, device=None) -> TriangleData:
    """TriangleData from numpy arrays keyed by the plane fields (``v0``,
    ``e1``, ``e2``, ``n``, ``d0``, ``n1``, ``d1``, ``n2``, ``d2``) and
    ``normals``, ``albedo``, ``lut``, ``lut_normals`` -- the leaves of the
    JAX package's TriangleData, so its tables can be fed to this package.
    The LBVH and its refit plan are built here from the LUT's triangles."""
    tris = np.asarray(arrays["lut"], np.float32)[1:]
    tree = lbvh.build_lbvh(tris) if len(tris) >= 2 else None
    nodes = lbvh.pack_bvh_nodes(tree, tris)
    tests = lbvh.pack_triangle_tests(*(arrays[f] for f in ("n", "d0", "n1", "d1", "n2", "d2")))
    tables = {k: _f32(arrays[k], device) for k in (*TrianglePlanes._fields, "normals", "albedo",
                                                  "lut", "lut_normals")}
    return from_tables(tables, lbvh.PackedBVH(nodes=_f32(nodes, device),
                                                 tris=_f32(tests, device),
                                                 plan=lbvh.refit_plan(tree, len(tris), device)))


def precompute_triangle_data(scene: Scene, device=None, albedo=None) -> TriangleData:
    """Build all per-triangle tables on the host and place them on
    ``device``.

    ``albedo``: optional (T, 3) per-triangle albedo. Default reproduces the
    reference's hardcoded normal-keyed materials (raytrace.comp.glsl:
    155-163)."""
    if scene.num_triangles == 0:
        # empty scene: one degenerate triangle (zero area -> its plane
        # normal is 0, so every intersection test rejects it) renders sky
        scene = Scene.from_arrays(np.zeros((3, 3)), np.array([[0, 1, 2]]))
    arrays = {k: v.numpy() for k, v in triangle_tables(torch.from_numpy(scene.triangles)).items()}
    if albedo is not None:
        albedo = np.asarray(albedo, np.float32)
        if albedo.shape != (scene.num_triangles, 3):
            raise ValueError(f"albedo must be (T, 3), got {albedo.shape}")
        arrays["albedo"] = albedo
    return triangle_data_from_numpy(arrays, device)


def model_matrix(model, device) -> torch.Tensor:
    """``model`` as a float32 (4, 4) or (3, 4) tensor on ``device``: no copy
    when it is one already. Raises on another shape."""
    m = torch.as_tensor(model, dtype=torch.float32, device=device)
    if tuple(m.shape) not in ((4, 4), (3, 4)):
        raise ValueError(f"the model matrix must be (4, 4) or (3, 4), got {tuple(m.shape)}")
    return m.contiguous()


def transform_triangle_data(tri_data: TriangleData, model, refit: bool = True) -> TriangleData:
    """The tables of the scene moved by a per-frame model matrix, from the
    rest pose's ``tri_data`` (the JAX package's transform_triangle_data).

    The reference carries ``model``/``modelPrev`` in its UBO and applies
    them in the visibility vertex shader (visibility.vert.glsl:22-24,
    main.cpp:1465-1469). ``model`` is a (4, 4) or (3, 4) row-major matrix,
    applied as ``p' = M[:3, :3] @ p + M[:3, 3]`` to ``lut[1:]`` by
    ops/camera.mat_apply, each coordinate ((m0 x + m1 y) + m2 z) + m3 as
    csrc/model.cu computes it (a matrix product would leave the order to
    the library); every table is rebuilt from the moved vertices
    (:func:`triangle_tables`), and the albedo is re-keyed from the new
    normals, as the reference keys it at trace time
    (raytrace.comp.glsl:155-163). So, as in the JAX package, a custom
    ``albedo=`` given to :func:`precompute_triangle_data` is dropped under a
    model. With ``refit`` the LBVH keeps the rest pose's tree with its boxes
    refitted over the moved triangles (scene/lbvh.refit_nodes_plain): the
    walks commit the least (t, prim), so any valid tree gives the same
    hits. Without it the rest pose's boxes stay, for a frame that walks no
    tree (pipeline/frame.walks_tree). ``History.lut`` then carries the
    previous frame's moved vertices, which reprojection and the temporal
    gradient read. The plain version of ops/cuda/model.transform_triangle_data's
    two kernels; ``model = identity`` reproduces the rest pose's tables."""
    model = model_matrix(model, tri_data.lut.device)
    tris = mat_apply(model[:3], tri_data.lut[1:])
    tables = triangle_tables(tris)
    nodes = lbvh.refit_nodes_plain(tri_data.bvh, tris) if refit else tri_data.bvh.nodes
    return from_tables(tables, tri_data.bvh._replace(nodes=nodes, tris=tables["tests"]))
