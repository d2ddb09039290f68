"""Scene, camera, light and the precomputed triangle tables.

The reference's scene state is a pile of Vulkan buffers (vertex/index
buffers, visibility LUT, UBO matrices -- main.cpp:357-407, 471-478) mutated
in place. Here the frame inputs are frozen dataclasses of tensors.
``TriangleData`` is the device-resident, precomputed form: intersection
planes, per-triangle unit normals, albedos, and the (T+1, 3, 3) visibility
LUT (slot 0 reserved for background, visibility.geom.glsl:32-35). The tables
are built once on the host with numpy and copied to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.intersect import (
    TrianglePlanes,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import lbvh


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
        from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import (
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


def _base_tables_np(tris: np.ndarray) -> dict:
    """All tables from (T, 3, 3) vertices, as float32 numpy arrays keyed
    like :func:`triangle_data_from_numpy` takes them. Within 1 ulp of the
    JAX package's jnp build (its cross products use FMA, numpy's do not)."""
    tris = np.asarray(tris, np.float32)
    v0 = tris[:, 0, :]
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    n = np.cross(e1, e2)
    inv_nn = (np.float32(1.0) / np.sum(n * n, axis=-1, keepdims=True)).astype(
        np.float32
    )
    n1 = np.cross(e2, n) * inv_nn
    n2 = np.cross(n, e1) * inv_nn
    normals = n / np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    nx = normals[:, 0]
    albedo = np.where(
        (nx > 0.99)[:, None],
        np.array([1.0, 0.0, 0.0], np.float32),
        np.where(
            (nx < -0.99)[:, None],
            np.array([0.0, 1.0, 0.0], np.float32),
            np.array([0.7, 0.7, 0.7], np.float32),
        ),
    )
    return dict(
        v0=v0, e1=e1, e2=e2, n=n,
        d0=np.sum(n * v0, axis=-1),
        n1=n1, d1=-np.sum(n1 * v0, axis=-1),
        n2=n2, d2=-np.sum(n2 * v0, axis=-1),
        normals=normals,
        albedo=albedo,
        lut=np.concatenate([np.zeros((1, 3, 3), np.float32), tris], axis=0),
        lut_normals=np.concatenate(
            [np.array([[0.0, 0.0, 1.0]], np.float32), normals], axis=0
        ),
    )


def triangle_data_from_numpy(arrays: dict, device=None) -> TriangleData:
    """TriangleData from numpy arrays keyed by the plane fields (``v0``,
    ``e1``, ``e2``, ``n``, ``d0``, ``n1``, ``d1``, ``n2``, ``d2``) and
    ``normals``, ``albedo``, ``lut``, ``lut_normals`` -- the leaves of the
    JAX package's TriangleData, so its tables can be fed to this package.
    The LBVH is built here from the LUT's triangles."""
    tris = np.asarray(arrays["lut"], np.float32)[1:]
    nodes = lbvh.pack_bvh_nodes(lbvh.build_lbvh(tris) if len(tris) >= 2 else None, tris)
    tests = lbvh.pack_triangle_tests(*(arrays[f] for f in ("n", "d0", "n1", "d1", "n2", "d2")))
    return TriangleData(
        planes=TrianglePlanes(
            *(_f32(arrays[f], device) for f in TrianglePlanes._fields)
        ),
        normals=_f32(arrays["normals"], device),
        albedo=_f32(arrays["albedo"], device),
        lut=_f32(arrays["lut"], device),
        lut_normals=_f32(arrays["lut_normals"], device),
        bvh=lbvh.PackedBVH(nodes=_f32(nodes, device), tris=_f32(tests, device)),
    )


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
    arrays = _base_tables_np(scene.triangles)
    if albedo is not None:
        albedo = np.asarray(albedo, np.float32)
        if albedo.shape != (scene.num_triangles, 3):
            raise ValueError(f"albedo must be (T, 3), got {albedo.shape}")
        arrays["albedo"] = albedo
    return triangle_data_from_numpy(arrays, device)
