"""The port's LBVH (scene/lbvh.py): the build against the JAX package's, the
packed node table, and the plain walks (ops/intersect.py) against the
port's dense test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene import (
    lbvh as jlbvh,
    procedural as jprocedural,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
    intersect,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.gbuffer import pixel_grid
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import lbvh, procedural

torch.set_num_threads(1)

SCENES = {
    "cornell": procedural.cornell_box,
    "soup64": lambda: jprocedural.random_soup(64, seed=2),
    "soup500": lambda: jprocedural.random_soup(500, seed=3),
    "subdivided6": lambda: procedural.subdivided_cornell(6),
}


def _triangles(name):
    verts, idx = SCENES[name]()
    return verts[idx]


@pytest.mark.parametrize("name", list(SCENES))
def test_build_matches_jax(name):
    """Field for field, bit for bit (left, right, leaf_prim, boxes). The
    JAX build is jitted (eager, each of its vmapped loops compiles apart:
    6.4 s against 1.6 s at 500 triangles)."""
    tris = _triangles(name)
    got = lbvh.build_lbvh(tris)
    want = jax.jit(jlbvh.build_lbvh)(jnp.asarray(tris))
    for field in lbvh.LBVH._fields:
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_packed_nodes_reach_every_triangle_once():
    """Every triangle is the leaf of exactly one node child, and every
    packed box holds the boxes below it."""
    tris = _triangles("subdivided6")
    bvh = lbvh.build_lbvh(tris)
    nodes = lbvh.pack_bvh_nodes(bvh, tris)
    child = nodes.view(np.int32)[:, 12:14]
    seen = np.zeros(len(tris), int)
    stack = [0]
    while stack:
        node = stack.pop()
        for side in (0, 1):
            c = int(child[node, side])
            lo, hi = nodes[node, 6 * side:6 * side + 3], nodes[node, 6 * side + 3:6 * side + 6]
            if c < 0:
                seen[-1 - c] += 1
                assert (lo <= tris[-1 - c].min(0)).all() and (hi >= tris[-1 - c].max(0)).all()
            else:
                assert (lo <= nodes[c, [0, 1, 2]]).all() and (lo <= nodes[c, [6, 7, 8]]).all()
                assert (hi >= nodes[c, [3, 4, 5]]).all() and (hi >= nodes[c, [9, 10, 11]]).all()
                stack.append(c)
    assert (seen == 1).all()


def test_too_deep_tree_is_refused():
    """A chain of 65 internal nodes needs more than the walk's stack."""
    num = 66
    internal = np.arange(num - 1)
    left = ((num - 1) + internal).astype(np.int32)
    right = np.where(internal < num - 2, internal + 1, 2 * num - 2).astype(np.int32)
    tris = np.random.default_rng(0).random((num, 3, 3)).astype(np.float32)
    chain = lbvh.LBVH(left=left, right=right, leaf_prim=np.arange(num, dtype=np.int32),
                      aabb_min=np.zeros((2 * num - 1, 3), np.float32),
                      aabb_max=np.ones((2 * num - 1, 3), np.float32))
    assert lbvh.tree_depth(chain) == num - 1
    with pytest.raises(ValueError, match="stack"):
        lbvh.pack_bvh_nodes(chain, tris)


def _rays(verts, idx, n, seed):
    """Seeded rays from around the scene: half aimed at triangle centroids,
    half at vertices (the shared edges and corners of a subdivided wall)."""
    rng = np.random.default_rng(seed)
    tris = verts[idx]
    origins = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32) + np.float32([0, 1, 0])
    targets = tris.mean(axis=1)[rng.integers(0, len(idx), n)]
    half = n // 2
    targets[:half] = tris[rng.integers(0, len(idx), half), rng.integers(0, 3, half)]
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return torch.tensor(origins), torch.tensor(dirs.astype(np.float32))


def _assert_same_record(got, want):
    for field in intersect.HitRecord._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("name", ["subdivided6", "soup500", "cornell"])
def test_walks_equal_dense_test(name):
    """traverse gives the dense nearest_hit's record exactly (t, prim, hit,
    u, v), and any_hit_within its "nearest hit at t <= cap", on seeded rays
    and on the camera's center rays."""
    verts, idx = SCENES[name]()
    td = precompute_triangle_data(Scene.from_arrays(verts, idx), "cpu")
    o, d = _rays(verts, idx, 3000, seed=len(idx))
    cfg = RenderConfig(width=48, height=32)
    cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.02, 1.0)
    py, px = pixel_grid(cfg.height, cfg.width)
    d_cam = cam_ops.pixel_rays(px, py, cfg.width, cfg.height, cfg.fov, rotation=cam.rotation)
    o = torch.cat([o, cam.position.expand(cfg.height * cfg.width, 3)])
    d = torch.cat([d, d_cam.reshape(-1, 3)])
    want = intersect.nearest_hit(td.planes, o, d)
    assert want.hit.double().mean() > 0.3
    _assert_same_record(intersect.traverse(td.bvh, o, d), want)

    cap = torch.tensor(np.random.default_rng(1).uniform(0.0, 4.0, o.shape[0]).astype(np.float32))
    assert torch.equal(intersect.any_hit_within(td.bvh, o, d, cap), want.hit & (want.t <= cap))

    mask = torch.tensor(np.random.default_rng(2).random(o.shape[0]) < 0.5)
    masked = intersect.traverse(td.bvh, o, d, mask=mask)
    assert not masked.hit[~mask].any()
    for field in intersect.HitRecord._fields:
        assert torch.equal(getattr(masked, field)[mask], getattr(want, field)[mask]), field


def test_single_triangle_scene_walks():
    """A one-triangle scene has no radix tree; its packed root holds the
    triangle on both sides, and the walk still equals the dense test."""
    verts, idx = procedural.cornell_box()
    td = precompute_triangle_data(Scene.from_arrays(verts, idx[:1]), "cpu")
    assert td.bvh.nodes.shape == (1, lbvh.NODE_WORDS)
    o, d = _rays(verts, idx[:1], 500, seed=7)
    _assert_same_record(intersect.traverse(td.bvh, o, d), intersect.nearest_hit(td.planes, o, d))


def test_scene_queries_route_by_size():
    """Below BVH_MIN_TRIANGLES the scene queries take the dense test, from it
    on the walk; both give the same records."""
    assert intersect.BVH_MIN_TRIANGLES == 128
    small = precompute_triangle_data(Scene.from_arrays(*procedural.subdivided_cornell(1)), "cpu")
    large = precompute_triangle_data(Scene.from_arrays(*procedural.subdivided_cornell(2)), "cpu")
    assert not intersect.uses_bvh(small) and intersect.uses_bvh(large)
    verts, idx = procedural.subdivided_cornell(2)
    o, d = _rays(verts, idx, 1000, seed=4)
    _assert_same_record(intersect.scene_nearest_hit(large, o, d),
                        intersect.nearest_hit(large.planes, o, d))
    cap = torch.full((1000,), 2.0)
    rec = intersect.nearest_hit(large.planes, o, d)
    assert torch.equal(intersect.scene_occluded(large, o, d, cap), rec.hit & (rec.t <= cap))
