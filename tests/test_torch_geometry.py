"""The fused geometry pass (G-buffer, temporal gradient, backprojection)
against the JAX package's XLA route, as tests/test_pallas.py holds the TPU
kernel (the CUDA wrapper runs its plain version on CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    atrous as jatrous,
    gbuffer as jgbuffer,
    gradient as jgradient,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    Camera as JaxCamera,
    Light as JaxLight,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    Light,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    geometry as tgeo,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    triangle_data_from_numpy,
)

torch.set_num_threads(1)

CFG = RenderConfig(width=64, height=48, max_bounces=8)
LIGHT_PREV_OFFSET = (0.5, 0.0, 0.0)
CAM_PREV_OFFSET = (0.0, 0.0, 0.5)


def _port_args(td, cfg, device=None):
    """The port's geometry_pass arguments for the test_pallas.py setup."""
    cam, light = Camera.default(device), Light.default(device)
    prev = Camera(cam.position + torch.tensor(CAM_PREV_OFFSET, device=device), cam.rotation)
    view, proj = tframe.camera_matrices(cam.position, cfg)
    view_p, proj_p = tframe.camera_matrices(prev.position, cfg)
    return (td, td.lut, cam.position, cam.rotation, light.position,
            light.position + torch.tensor(LIGHT_PREV_OFFSET, device=device),
            light.color, light.color * 0.5, view, proj, view_p, proj_p, cfg)


def test_geometry_matches_xla_passes(cornell_tri_data):
    jcam, jlight = JaxCamera.default(), JaxLight.default()
    light_prev_pos = jlight.position + jnp.array(LIGHT_PREV_OFFSET)
    view, proj = jframe.camera_matrices(jcam.position, CFG)
    view_prev, proj_prev = jframe.camera_matrices(
        jcam.position + jnp.array(CAM_PREV_OFFSET), CFG
    )
    ref_g = jgbuffer.visibility_pass(cornell_tri_data, jcam.position, view, proj, CFG)
    ref_lam = jgradient.temporal_gradient_pass(
        ref_g, cornell_tri_data.lut, cornell_tri_data.lut, jcam.position,
        jlight.position, light_prev_pos, jlight.color, jlight.color * 0.5,
    )
    ref_py, ref_px = jatrous.backproject_pixels(
        ref_g, cornell_tri_data.lut, view_prev, proj_prev, CFG
    )

    td = precompute_triangle_data(Scene.cornell_box())
    geo = tgeo.geometry_pass(*_port_args(td, CFG))

    np.testing.assert_array_equal(geo.visibility.numpy(), np.asarray(ref_g.visibility))
    np.testing.assert_allclose(geo.depth.numpy(), np.asarray(ref_g.depth), atol=1e-5)
    np.testing.assert_allclose(geo.world_pos.numpy(), np.asarray(ref_g.world_pos), atol=1e-5)
    prim = np.asarray(ref_g.visibility).astype(np.int32)
    ref_n = np.asarray(cornell_tri_data.lut_normals)[prim]
    np.testing.assert_allclose(geo.normal.numpy(), ref_n, atol=1e-5)
    np.testing.assert_allclose(geo.lam.numpy(), np.asarray(ref_lam), atol=2e-4)
    # truncation can differ by 1 pixel where the float coordinate sits on
    # an integer boundary; allow that on <1% of pixels
    assert geo.prev_y.dtype == torch.int32 and geo.prev_x.dtype == torch.int32
    dy = np.abs(geo.prev_y.numpy() - np.asarray(ref_py))
    dx = np.abs(geo.prev_x.numpy() - np.asarray(ref_px))
    assert (dy > 0).mean() < 0.01 and dy.max() <= 1
    assert (dx > 0).mean() < 0.01 and dx.max() <= 1


def test_backprojection_keeps_background_and_clamps(cornell_tri_data):
    """Background pixels keep their own coordinates, and a previous camera
    far off to the side clamps every surface pixel into the image."""
    td = triangle_data_from_numpy(
        {f: np.asarray(getattr(cornell_tri_data.planes, f)) for f in cornell_tri_data.planes._fields}
        | {f: np.asarray(getattr(cornell_tri_data, f))
           for f in ("normals", "albedo", "lut", "lut_normals")}
    )
    args = list(_port_args(td, CFG))
    args[10], args[11] = tframe.camera_matrices(torch.tensor([5.0, 1.0, 6.0]), CFG)
    geo = tgeo.geometry_pass(*args)
    bg = geo.visibility.numpy() == 0
    assert bg.any() and (~bg).any()
    py, px = np.meshgrid(np.arange(CFG.height), np.arange(CFG.width), indexing="ij")
    np.testing.assert_array_equal(geo.prev_y.numpy()[bg], py[bg])
    np.testing.assert_array_equal(geo.prev_x.numpy()[bg], px[bg])
    assert geo.prev_x.min() >= 0 and geo.prev_x.max() <= CFG.width - 1
    assert geo.prev_y.min() >= 0 and geo.prev_y.max() <= CFG.height - 1
