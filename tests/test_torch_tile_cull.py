"""The dense geometry kernel's tile cull (ops/tilecull.py, the plain twin of
csrc/geometry.cu's), on the CPU: no triangle that the plain ray/triangle
test finds valid for some pixel of a warp tile is culled from that tile,
the survivors are the few a tile that make the cull pay, and the nearest
hit over the survivors alone is the JAX package's G-buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    gbuffer as jgbuffer,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
    intersect,
    tilecull,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    geometry as cuda_geometry,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

torch.set_num_threads(1)

# the most survivors a tile may average at 64x48 on each scene (measured:
# 2.8-6.3 on the Cornell box's 32 triangles, 3.7-20.2 on its 288-triangle
# subdivision); at 1000x800 the Cornell box averages 2.4-2.6
MEAN_SURVIVORS = {32: 8, 288: 24}


def _scenes():
    return {32: precompute_triangle_data(Scene.cornell_box()),
            288: precompute_triangle_data(Scene.from_arrays(*procedural.subdivided_cornell(3)))}


# jitted: the eager pass compiles op by op (~3 s a frame size)
_jax_visibility = jax.jit(
    lambda td, pos, view, proj, cfg, rot: jgbuffer.visibility_pass(td, pos, view, proj, cfg,
                                                                   rotation=rot),
    static_argnums=4)


def _valid_pairs(td, cam, cfg):
    """(H*W, T): whether the plain test finds each triangle valid for each
    pixel's primary ray (every valid one, not only the nearest), and t."""
    h, w = cfg.height, cfg.width
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    d = cam_ops.pixel_rays(px, py, w, h, cfg.fov, rotation=cam.rotation).reshape(-1, 1, 3)
    o = cam.position.expand(h * w, 3)[:, None]
    p = td.planes
    valid, t, _, _ = intersect._plane_test(o, d, p.n[None], p.d0[None], p.n1[None], p.d1[None],
                                           p.n2[None], p.d2[None], cfg.t_max,
                                           cfg.intersect_eps)
    return valid, t


def _pixel_tiles(cfg):
    """Each pixel's warp tile index (tilecull.tile_grid's order)."""
    h, w = cfg.height, cfg.width
    tw, th = tilecull.TILE
    cols = -(-w // tw)
    ty = torch.arange(h)[:, None].expand(h, w) // th
    tx = torch.arange(w)[None, :].expand(h, w) // tw
    return (ty * cols + tx).reshape(-1)


@pytest.mark.parametrize(
    "pose, size",
    [("default", (64, 48)), ("orbit", (64, 48)), ("near_wall", (64, 48)), ("orbit", (61, 43))],
    ids=["default", "orbit", "near_wall", "orbit_61x43"],
)
def test_cull_keeps_every_valid_triangle(cornell_tri_data, pose, size):
    cfg = RenderConfig(width=size[0], height=size[1])
    cam = chip_smoke.dense_poses(pt, "cpu")[pose][0]
    tiles = _pixel_tiles(cfg)
    for t, td in _scenes().items():
        survivors = tilecull.tile_survivors_plain(td.planes, cam.position, cam.rotation, cfg)
        rows, cols = tilecull.tile_grid(cfg)
        assert survivors.shape == (rows * cols, t)
        valid, t_hit = _valid_pairs(td, cam, cfg)
        kept = survivors[tiles]  # (H*W, T)
        lost = valid & ~kept
        assert not lost.any(), f"{t} tris: {int(lost.sum())} valid (pixel, triangle) pairs culled"
        per_tile = survivors.sum(dim=1).double()
        assert per_tile.mean().item() <= MEAN_SURVIVORS[t] and per_tile.max().item() < t

        # the nearest hit over the survivors alone is the plain nearest hit
        ok = valid & kept
        culled_prim = torch.argmin(torch.where(ok, t_hit, torch.full_like(t_hit, 2.0 * cfg.t_max)),
                                   dim=-1)
        h, w = cfg.height, cfg.width
        py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        d = cam_ops.pixel_rays(px, py, w, h, cfg.fov, rotation=cam.rotation)
        rec = intersect.nearest_hit(td.planes, cam.position.expand(h, w, 3), d,
                                    t_max=cfg.t_max, eps=cfg.intersect_eps)
        hit = rec.hit.reshape(-1)
        assert torch.equal(ok.any(dim=-1), hit)
        assert torch.equal(culled_prim[hit], rec.prim.reshape(-1)[hit])
        if t == 32:
            # and the JAX package's G-buffer (primID + 1, 0 for the background)
            pos, rot = jnp.asarray(cam.position.numpy()), jnp.asarray(cam.rotation.numpy())
            jview, jproj = jframe.camera_matrices(pos, cfg)
            ref = _jax_visibility(cornell_tri_data, pos, jview, jproj, cfg, rot)
            vis = torch.where(hit, culled_prim + 1, torch.zeros_like(culled_prim))
            np.testing.assert_array_equal(vis.reshape(h, w).numpy().astype(np.float32),
                                          np.asarray(ref.visibility))

        # the counts a CPU call of the dense wrapper writes: each pixel's
        # tile's survivors
        counts = cuda_geometry.dense_counts(cfg, "cpu")
        view, proj = tframe.camera_matrices(cam, cfg)
        cuda_geometry.geometry_pass(td, td.lut, cam.position, cam.rotation, *[cam.position] * 4,
                                    view, proj, view, proj, cfg, counts=counts)
        want = survivors.sum(dim=1, dtype=torch.int32)[tiles]
        assert torch.equal(counts[0], want) and torch.equal(counts[1], want)
