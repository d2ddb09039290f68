"""The port's scene tables, camera math and intersection against the JAX
package."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    camera as jcam,
    intersect as jint,
    shading as jshade,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene import (
    procedural as jproc,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    Camera as JaxCamera,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    RenderConfig,
    Scene,
    load_obj,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as tcam,
    intersect as tint,
    shading as tshade,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import (
    procedural as tproc,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    triangle_data_from_numpy,
)

torch.set_num_threads(1)

CFG = RenderConfig(width=64, height=48)


def jax_tables(td) -> dict:
    """The JAX TriangleData's leaves as the numpy dict the port takes."""
    arrays = {f: np.asarray(getattr(td.planes, f)) for f in td.planes._fields}
    for f in ("normals", "albedo", "lut", "lut_normals"):
        arrays[f] = np.asarray(getattr(td, f))
    return arrays


def test_cornell_box_identical():
    for got, want in zip(tproc.cornell_box(), jproc.cornell_box()):
        np.testing.assert_array_equal(got, want)


def test_tables_match_jax(cornell_tri_data):
    want = jax_tables(cornell_tri_data)
    td = precompute_triangle_data(Scene.cornell_box())
    got = {f: getattr(td.planes, f) for f in td.planes._fields}
    for f in ("normals", "albedo", "lut", "lut_normals"):
        got[f] = getattr(td, f)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(td.lut.numpy(), want["lut"])
    np.testing.assert_array_equal(td.albedo.numpy(), want["albedo"])
    carried = triangle_data_from_numpy(want)
    np.testing.assert_array_equal(carried.planes.n1.numpy(), want["n1"])


def test_plane_build_and_albedo_match_jax():
    """The device-side builders (ops/intersect, ops/shading) on random
    triangles, beside the host build the tables above come from."""
    tris = np.random.default_rng(11).uniform(-2.0, 2.0, (64, 3, 3)).astype(np.float32)
    want = jint.build_triangle_planes(jnp.asarray(tris))
    got = tint.build_triangle_planes(torch.from_numpy(tris))
    for name in tint.TrianglePlanes._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    normals = np.concatenate([np.eye(3), -np.eye(3), tris[:, 0]]).astype(np.float32)
    np.testing.assert_array_equal(
        tshade.albedo_from_normal(torch.from_numpy(normals)).numpy(),
        np.asarray(jshade.albedo_from_normal(jnp.asarray(normals))))


@pytest.mark.parametrize("size", [(64, 48), (1000, 800), (1920, 1080)])
def test_camera_matrices_match_jax(size):
    cfg = RenderConfig(width=size[0], height=size[1])
    jc = JaxCamera.default()
    jc_moved = JaxCamera(position=jc.position + jnp.array([0.3, -0.1, 0.5]), rotation=jc.rotation)
    tc_moved = Camera(position=torch.tensor(np.asarray(jc_moved.position)),
                      rotation=torch.eye(3))
    cases = [
        (jframe.camera_matrices(jc.position, cfg),
         tframe.camera_matrices(Camera.default().position, cfg)),
        (jframe.camera_matrices(jc_moved, cfg), tframe.camera_matrices(tc_moved, cfg)),
    ]
    for (jv, jp), (tv, tp) in cases:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_pixel_rays_and_projection_match_jax():
    r = np.random.default_rng(3)
    h, w = CFG.height, CFG.width
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    jx = r.normal(0.0, 0.375, (h, w)).astype(np.float32)
    jy = r.normal(0.0, 0.375, (h, w)).astype(np.float32)
    want = jcam.pixel_rays(jnp.asarray(px), jnp.asarray(py), w, h, CFG.fov,
                           jnp.asarray(jx), jnp.asarray(jy), rotation=jnp.eye(3))
    got = tcam.pixel_rays(torch.from_numpy(px), torch.from_numpy(py), w, h, CFG.fov,
                          torch.from_numpy(jx), torch.from_numpy(jy), rotation=torch.eye(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    pts = r.uniform(-1.0, 2.0, (h, w, 3)).astype(np.float32)
    jv, jp = jframe.camera_matrices(jnp.array([0.1, 1.0, 5.5]), CFG)
    tv, tp = tframe.camera_matrices(torch.tensor([0.1, 1.0, 5.5]), CFG)
    np.testing.assert_allclose(
        tcam.world_to_pixel(torch.from_numpy(pts), tv, tp, w, h).numpy(),
        np.asarray(jcam.world_to_pixel(jnp.asarray(pts), jv, jp, w, h)), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        tcam.ndc_depth(torch.from_numpy(pts), tv, tp).numpy(),
        np.asarray(jcam.ndc_depth(jnp.asarray(pts), jv, jp)), rtol=1e-6, atol=1e-6)


def test_nearest_hit_and_sphere_match_jax(cornell_tri_data):
    r = np.random.default_rng(5)
    o = r.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32) + np.float32([0, 1, 0])
    d = r.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jint.nearest_hit(cornell_tri_data.planes, jnp.asarray(o), jnp.asarray(d))
    td = triangle_data_from_numpy(jax_tables(cornell_tri_data))
    got = tint.nearest_hit(td.planes, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.bary_u.numpy(), np.asarray(want.bary_u), atol=1e-5)
    np.testing.assert_allclose(
        tint.hit_position(td.planes, got).numpy(),
        np.asarray(jint.hit_position(cornell_tri_data.planes, want)), atol=1e-5)
    center = np.float32([1.0, 1.0, -0.4])
    jh, jt = jint.ray_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(center), 0.2)
    th, tt = tint.ray_sphere(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(center), 0.2)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)


def test_load_obj(tmp_path):
    path = os.path.join(tmp_path, "box.obj")
    jproc.write_obj(path, *jproc.cornell_box())
    for got, want in zip(load_obj(path), jproc.cornell_box()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(load_obj(), jproc.cornell_box()):
        np.testing.assert_array_equal(got, want)
