"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    Light,
    Renderer,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    _build,
    atrous as cuda_atrous,
    geometry as cuda_geometry,
    micro as cuda_micro,
    model as cuda_model,
    pathtrace as cuda_pathtrace,
    wavefront as cuda_wavefront,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import camera as cam_ops
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
CFG = RenderConfig()  # the reference's 1000x800 frame


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _seeded(seed, dev, cfg=CFG):
    """Seeded HDR color and history, lambda and a random backprojection."""
    r = np.random.default_rng(seed)
    h, w = cfg.height, cfg.width

    def t(a):
        return torch.tensor(a, device=dev)

    return (t(r.exponential(0.5, (h, w, 3)).astype(np.float32)),
            t(r.exponential(0.5, (h, w, 3)).astype(np.float32)),
            t(r.uniform(0.0, 1.0, (h, w)).astype(np.float32)),
            t(r.integers(0, h, (h, w)).astype(np.int32)),
            t(r.integers(0, w, (h, w)).astype(np.int32)))


def _geometry_args(dev, cfg=CFG):
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    cam, light = Camera.default(dev), Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    view_p, proj_p = frame.camera_matrices(
        cam.position + torch.tensor([0.0, 0.0, 0.5], device=dev), cfg
    )
    return (td, td.lut, cam.position, cam.rotation, light.position,
            light.position + torch.tensor([0.5, 0.0, 0.0], device=dev),
            light.color, light.color * 0.5, view, proj, view_p, proj_p, cfg)


# The a-trous kernels' frames: the reference's 1000x800, one that splits
# unevenly into the kernels' 64-column, 8-lattice-row tiles, and 13 rows by
# 37 columns, where for k >= 7 the taps +-k clamp at both ends of every
# column and the tile's halo clamps on every side.
ATROUS_SIZES = [(1000, 800), (1003, 797), (37, 13)]


@pytest.mark.parametrize("tris", [32, 128, 288])
@pytest.mark.parametrize("size", ATROUS_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pose", ["default", "orbit", "near_wall"])
def test_geometry_kernel(dev, pose, size, tris):
    """Every plane of the dense kernel is bit-equal to the plain version: the
    full mode with and without the albedo planes, its counting launch and
    the visibility-only mode; the counted tests and survivors equal the
    tile cull's plain twin."""
    cfg = dataclasses.replace(CFG, width=size[0], height=size[1])
    td = (precompute_triangle_data(Scene.cornell_box(), dev) if tris == 32
          else _stress({128: 2, 288: 3}[tris], dev))
    cams = chip_smoke.dense_poses(pt, dev)[pose]
    cam = cams[0]
    view, proj = frame.camera_matrices(cam, cfg)
    args = chip_smoke.dense_geometry_args(pt, td, cfg, cams, dev)
    _build.LAUNCHES.clear()
    full = cuda_geometry.geometry_pass(*args, emit_albedo=True)
    assert dict(_build.LAUNCHES) == {"geometry": 1}
    bare = cuda_geometry.geometry_pass(*args)
    counts = cuda_geometry.dense_counts(cfg, dev)
    counted = cuda_geometry.geometry_pass(*args, emit_albedo=True, counts=counts)
    vis = cuda_geometry.visibility_pass_dense(td, cam.position, view, proj, cfg,
                                              rotation=cam.rotation)
    assert _build.LAUNCHES["geometry[visibility]"] == 1
    plain = cuda_geometry.geometry_pass_plain(*args, emit_albedo=True)
    assert torch.isfinite(full.depth).all() and torch.isfinite(full.lam).all()
    for name in plain._fields:
        assert torch.equal(getattr(full, name), getattr(plain, name)), name
        assert torch.equal(getattr(counted, name), getattr(plain, name)), name
        if name != "albedo":
            assert torch.equal(getattr(bare, name), getattr(plain, name)), name
    assert bare.albedo is None
    for name in vis._fields:
        assert torch.equal(getattr(vis, name), getattr(plain, name)), name
    want = cuda_geometry.dense_counts_plain(td, cam.position, cam.rotation, cfg)
    assert torch.equal(counts, want)
    assert counts[0].double().mean().item() < tris  # the cull drops most triangles


@pytest.mark.parametrize("walls", [True, False], ids=["through_walls", "respects_walls"])
def test_trace_kernel(dev, walls):
    cfg = dataclasses.replace(CFG, light_through_walls=walls)
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    cam, light = Camera.default(dev), Light.default(dev)
    _build.LAUNCHES.clear()
    k = cuda_pathtrace.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation)
    assert _build.LAUNCHES["trace"] == 1
    # the instantiation without the count gives the same image
    assert torch.equal(k, cuda_pathtrace.path_trace_pass(td, cam.position, light, 5, cfg,
                                                         cam.rotation))
    p = cuda_pathtrace.path_trace_pass_plain(td, cam.position, light, 5, cfg,
                                             rotation=cam.rotation)
    assert torch.isfinite(k).all()
    outside = 1.0 - torch.isclose(k, p, rtol=1e-5, atol=1e-5).double().mean().item()
    assert outside <= 1e-3


@pytest.mark.parametrize("size", ATROUS_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k", range(1, 10))
def test_atrous_iter_kernel(dev, k, size):
    cfg = dataclasses.replace(CFG, width=size[0], height=size[1])
    geo = cuda_geometry.geometry_pass(*_geometry_args(dev, cfg))
    color = _seeded(k, dev, cfg)[0]
    assert torch.equal(
        cuda_atrous.atrous_iteration(color, geo.normal, geo.depth, k, cfg),
        cuda_atrous.atrous_iteration_plain(color, geo.normal, geo.depth, k, cfg),
    )


@pytest.mark.parametrize("frame_idx", [0, 3])
@pytest.mark.parametrize("adaptive", [False, True])
def test_temporal_blend_kernel(dev, frame_idx, adaptive):
    cfg = dataclasses.replace(CFG, adaptive_alpha=adaptive)
    color, prev, lam, py, px = _seeded(frame_idx, dev)
    torch.testing.assert_close(
        cuda_atrous.temporal_blend(color, prev, py, px, frame_idx, lam, cfg),
        cuda_atrous.temporal_blend_plain(color, prev, py, px, frame_idx, lam, cfg),
        rtol=1e-6, atol=1e-6,
    )


def test_wrappers_reject_bad_input(dev):
    color, prev, lam, py, px = _seeded(0, dev)
    with pytest.raises(ValueError, match="int32"):
        cuda_atrous.temporal_blend(color, prev, py.long(), px, 1, lam, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_atrous.temporal_blend(color.transpose(0, 1).contiguous().transpose(0, 1),
                                   prev, py, px, 1, lam, CFG)
    with pytest.raises(ValueError, match="in place"):
        cuda_atrous.atrous_iteration(color, color, lam, 1, CFG, out=color)


def test_renderer_routes_agree(dev):
    cfg = RenderConfig(width=160, height=128, max_bounces=8)
    r_k = Renderer(Scene.cornell_box(), cfg, device=dev)
    r_p = Renderer(Scene.cornell_box(), dataclasses.replace(cfg, backend="xla"), device=dev)
    _build.LAUNCHES.clear()
    for _ in range(3):
        for r in (r_k, r_p):
            r.move_camera(dx=0.05)
            r.move_light(dx=0.1)
        a, b = r_k.step(), r_p.step()
        assert torch.isfinite(a).all()
        assert torch.isclose(a, b, rtol=0, atol=1e-3).double().mean().item() >= 0.99
        assert (a - b).abs().mean().item() <= 1e-4
    assert dict(_build.LAUNCHES) == {"geometry": 3, "trace": 3, "atrous_iter": 27,
                                     "temporal_blend": 3}


def test_geometry_albedo_planes(dev):
    args = _geometry_args(dev)
    k = cuda_geometry.geometry_pass(*args, emit_albedo=True)
    p = cuda_geometry.geometry_pass_plain(*args, emit_albedo=True)
    same = k.visibility == p.visibility
    assert torch.equal(k.albedo[same], p.albedo[same])
    assert cuda_geometry.geometry_pass(*args).albedo is None


@pytest.mark.parametrize(
    "overrides",
    [dict(), dict(nee=True), dict(rr_start_bounce=4), dict(spp=2, sample_batches=2),
     dict(truncate_radiance=True), dict(nee=True, spp=4, rr_start_bounce=2)],
    ids=["parity", "nee", "rr4", "spp2_batches2", "truncate", "nee_spp4_rr2"],
)
def test_trace_kernel_modes(dev, overrides):
    cfg = dataclasses.replace(CFG, **overrides)
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    cam, light = Camera.default(dev), Light.default(dev)
    _build.LAUNCHES.clear()
    tests = torch.zeros((cfg.height, cfg.width), dtype=torch.int32, device=dev)
    k = cuda_pathtrace.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation, tests=tests)
    assert _build.LAUNCHES["trace"] == 1
    # the instantiation without the count gives the same image
    assert torch.equal(k, cuda_pathtrace.path_trace_pass(td, cam.position, light, 5, cfg,
                                                         cam.rotation))
    p = cuda_pathtrace.path_trace_pass_plain(td, cam.position, light, 5, cfg,
                                             rotation=cam.rotation)
    assert torch.isfinite(k).all()
    outside = 1.0 - torch.isclose(k, p, rtol=1e-5, atol=1e-5).double().mean().item()
    assert outside <= 1e-3
    # every sample runs at least one nearest-hit walk over all triangles
    assert tests.min().item() >= cfg.spp * cfg.sample_batches * td.num_triangles


@pytest.mark.parametrize("size", ATROUS_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k", range(1, 10))
def test_atrous_iter_var_kernel(dev, k, size):
    cfg = dataclasses.replace(CFG, width=size[0], height=size[1])
    geo = cuda_geometry.geometry_pass(*_geometry_args(dev, cfg))
    color = _seeded(k, dev, cfg)[0]
    var = 0.1 * _seeded(k + 10, dev, cfg)[2]
    got_c, got_v = cuda_atrous.atrous_iteration_var(color, var, geo.normal, geo.depth, k, cfg)
    want_c, want_v = cuda_atrous.atrous_iteration_var_plain(color, var, geo.normal, geo.depth,
                                                             k, cfg)
    assert torch.equal(got_c, want_c) and torch.equal(got_v, want_v)


@pytest.mark.parametrize("frame_idx", [0, 3])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("mode", ["id", "normal"])
def test_temporal_blend_ramp_kernel(dev, frame_idx, adaptive, mode):
    cfg = dataclasses.replace(CFG, accumulation_ramp=True, adaptive_alpha=adaptive,
                              ramp_reset_mode=mode)
    color, prev, lam, py, px = _seeded(frame_idx, dev)
    geo = cuda_geometry.geometry_pass(*_geometry_args(dev))
    if mode == "normal":
        prev_cons = atrous.normal_class(geo.normal.flip(1), geo.visibility.flip(1))
        cur_cons = atrous.normal_class(geo.normal, geo.visibility)
    else:
        prev_cons, cur_cons = geo.visibility.flip(0).contiguous(), geo.visibility
    prev_age = torch.floor(40.0 * _seeded(frame_idx + 20, dev)[2])
    args = (color, prev, py, px, frame_idx, lam, prev_age, prev_cons, cur_cons, cfg)
    got_rgb, got_age = cuda_atrous.temporal_blend_ramp(*args)
    want_rgb, want_age = cuda_atrous.temporal_blend_ramp_plain(*args)
    assert torch.equal(got_age, want_age)
    torch.testing.assert_close(got_rgb, want_rgb, rtol=1e-6, atol=1e-6)


def test_svgf_wrappers_reject_bad_input(dev):
    color, prev, lam, py, px = _seeded(0, dev)
    geo = cuda_geometry.geometry_pass(*_geometry_args(dev))
    with pytest.raises(ValueError, match="in place"):
        cuda_atrous.atrous_iteration_var(color, lam, geo.normal, geo.depth, 1, CFG,
                                         out=(color, torch.empty_like(lam)))
    with pytest.raises(ValueError, match="accumulation_ramp"):
        cuda_atrous.temporal_blend_ramp(color, prev, py, px, 1, lam, lam, lam, lam, CFG)


@pytest.mark.parametrize("name", ["cornell_box_quality", "cornell_box_interactive"])
def test_preset_routes_agree(dev, name):
    small = dict(width=160, height=128, max_bounces=8)
    r_k = getattr(presets, name)(device=dev, **small)
    r_p = getattr(presets, name)(device=dev, backend="xla", **small)
    _build.LAUNCHES.clear()
    for _ in range(3):
        for r in (r_k, r_p):
            r.move_camera(dx=0.05)
            r.move_light(dx=0.1)
        a, b = r_k.step(), r_p.step()
        assert torch.isfinite(a).all()
        assert torch.isclose(a, b, rtol=0, atol=1e-3).double().mean().item() >= 0.99
        assert (a - b).abs().mean().item() <= 1e-4
    assert dict(_build.LAUNCHES) == {"geometry": 3, "trace": 3, "atrous_iter_var": 27,
                                     "temporal_blend_ramp": 3}


# --- the large-scene slice: LBVH kernels, segment tracer, shadow segment ---

def _stress(splits, dev):
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    return precompute_triangle_data(Scene.from_arrays(*procedural.subdivided_cornell(splits)), dev)


def _orbit(i, dev):
    return Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0, device=dev)


# The LBVH geometry kernel's frames: the reference's, one that splits
# unevenly into its 16x16 blocks of 8x4 warp tiles, and one smaller than a
# block, with partial warp tiles on both axes.
GEOMETRY_BVH_SIZES = [(1000, 800), (1003, 797), (37, 13)]


def _check_walk_lanes(lanes, rays):
    """The lane counts of an LBVH geometry or shadow launch over ``rays``
    rays (lanes with a ray, warps; walk lanes, walk steps) are consistent:
    every ray tested the root's boxes, and no count exceeds 32 lanes a
    warp step."""
    ray_lanes, warps, walk_lanes, walk_steps = (int(v) for v in lanes.tolist())
    assert ray_lanes == rays and 0 < ray_lanes <= 32 * warps
    assert rays <= walk_lanes <= 32 * walk_steps


@pytest.mark.parametrize("size", GEOMETRY_BVH_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bvh_geometry_kernel_equals_dense_kernel(dev, size):
    """At 288 triangles both kernels run; every plane of the LBVH kernel is
    bit-equal to the dense kernel's and to the plain version's, in both
    modes, and the counting launch gives the same planes."""
    cfg = dataclasses.replace(CFG, width=size[0], height=size[1])
    td = _stress(3, dev)
    args = (td, td.lut) + _geometry_args(dev, cfg)[2:]
    _build.LAUNCHES.clear()
    dense = cuda_geometry.geometry_pass(*args, emit_albedo=True)
    counts = cuda_geometry.WalkCounts.zeros(cfg.height * cfg.width, td)
    lanes = torch.zeros(4, dtype=torch.int64, device=dev)
    bvh = cuda_geometry.geometry_pass_bvh(*args, emit_albedo=True)
    counted = cuda_geometry.geometry_pass_bvh(*args, emit_albedo=True, counts=counts, lanes=lanes)
    assert _build.LAUNCHES["geometry_bvh"] == 2
    plain = cuda_geometry.geometry_pass_plain(*args, emit_albedo=True)
    for name in dense._fields:
        assert torch.equal(getattr(dense, name), getattr(bvh, name)), name
        assert torch.equal(getattr(counted, name), getattr(bvh, name)), name
        assert torch.equal(getattr(plain, name), getattr(bvh, name)), name
    assert counts.tests[1].min().item() >= 2  # every pixel tests the root's two boxes
    assert counts.nodes[0].item() == 1 and counts.tris.sum().item() > 0
    # the rows read hold every committed triangle
    committed = bvh.visibility[bvh.visibility > 0].to(torch.int64) - 1
    assert (counts.tris[committed] == 1).all()
    _check_walk_lanes(lanes, cfg.width * cfg.height)
    # the visibility-only mode: the same planes
    view, proj = args[8], args[9]
    vis = cuda_geometry.visibility_pass(td, args[2], view, proj, cfg, rotation=args[3])
    assert _build.LAUNCHES["geometry_bvh[visibility]"] == 1
    for name in vis._fields:
        assert torch.equal(getattr(vis, name), getattr(dense, name)), name


@pytest.mark.parametrize(
    "overrides",
    [dict(), dict(nee=True), dict(rr_start_bounce=2, max_bounces=8),
     dict(spp=2, sample_batches=2, max_bounces=8), dict(truncate_radiance=True),
     dict(nee=True, light_through_walls=False, max_bounces=8)],
    ids=["parity", "nee", "rr2", "spp2_batches2", "truncate", "nee_walls"],
)
def test_segment_tracer_equals_trace_kernel(dev, overrides):
    """At 288 triangles the one-launch dense kernel and the segment tracer
    over the LBVH give the same image bit for bit."""
    cfg = dataclasses.replace(CFG, **overrides)
    td = _stress(3, dev)
    cam, light = _orbit(3, dev), Light.default(dev)
    _build.LAUNCHES.clear()
    dense = cuda_pathtrace.path_trace_pass(td, cam.position, light, 5, cfg, cam.rotation)
    segments = cuda_wavefront.path_trace_wavefront(td, cam.position, light, 5, cfg, cam.rotation)
    assert _build.LAUNCHES["trace_segment"] == cfg.max_bounces * cfg.spp * cfg.sample_batches
    assert torch.equal(dense, segments)


def test_trace_segment_equals_plain(dev):
    """Each segment of a NEE + RR path on 32,768 triangles, each launch
    after the first on the live list the launch before wrote: ray state
    after the kernel equals the plain segment's on the same input."""
    cfg = RenderConfig(width=160, height=128, max_bounces=6, nee=True, rr_start_bounce=2)
    td = _stress(32, dev)
    cam, light = _orbit(1, dev), Light.default(dev)
    n = cfg.width * cfg.height
    rays = cuda_wavefront.RayState.empty(n, dev)
    counts = cuda_geometry.WalkCounts.zeros(n, td)
    for seg in range(cfg.max_bounces):
        plain = cuda_wavefront.RayState(*(t.clone() for t in rays))
        cuda_wavefront.trace_segment(rays, seg, 0, 1, td, cam.position, cam.rotation, light, 3,
                                     cfg, counts=counts, first=seg == 0)
        cuda_wavefront.trace_segment_plain(plain, seg, 0, 1, td, cam.position, cam.rotation,
                                           light, 3, cfg)
        for a, b in zip(rays, plain):
            assert torch.equal(a, b), seg
    assert counts.tests[0].sum().item() > 0 and counts.tests[1].sum().item() > 0
    assert counts.nodes.sum().item() > 0 and counts.tris.sum().item() > 0


def _shadow_case(case, dev):
    """(tri_data, cfg, origins, dirs, cap, mask, width) of a shadow_segment
    case."""
    cfg = RenderConfig()
    td = _stress(32, dev)
    if case == "path_c":  # path C's bounce-0 shadow rays (G-buffer seed, NEE), partial tiles
        from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
            camera as cam_ops,
            pathtrace,
            rng as rng_ops,
        )

        cfg = RenderConfig(width=157, height=101, max_bounces=8, rr_start_bounce=2,
                           gbuffer_primary=True, nee=True)
        cam, light = _orbit(3, dev), Light.default(dev)
        view, proj = frame.camera_matrices(cam, cfg)
        geo = cuda_geometry.geometry_pass_bvh(td, td.lut, cam.position, cam.rotation,
                                              light.position, light.position, light.color,
                                              light.color, view, proj, view, proj, cfg,
                                              emit_albedo=True)
        n = cfg.width * cfg.height
        idx = torch.arange(n, device=dev)
        px, py = idx % cfg.width, torch.div(idx, cfg.width, rounding_mode="floor")
        state, gx, gy = rng_ops.sample_jitter(px, py, 5, 0, 0)
        dirs = cam_ops.pixel_rays(px, py, cfg.width, cfg.height, cfg.fov, jitter_x=0.0 * gx,
                                  jitter_y=0.0 * gy, rotation=cam.rotation)
        carry = pathtrace.primary_carry(
            cam.position.expand(n, 3), dirs, state, geo.visibility.reshape(n),
            geo.world_pos.reshape(n, 3), geo.normal.reshape(n, 3), geo.albedo.reshape(n, 3),
            light.position, light.color * cfg.light_intensity, cfg, defer_nee_shadow=True)
        w_l, s_t, _, mask = carry[6]
        cap = torch.where(mask, s_t, torch.zeros_like(s_t))
        return td, cfg, carry[0], w_l, cap, mask, cfg.width
    if case == "one_triangle":  # the ceiling's larger triangle
        from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

        verts, idx = procedural.cornell_box()
        td = precompute_triangle_data(Scene.from_arrays(verts, idx[3:4]), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1_017 if case == "partial_warp" else 100_000
    o = torch.rand((n, 3), generator=g, device=dev) * 1.8 - torch.tensor([0.9, -0.05, 0.9],
                                                                         device=dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
    cap = torch.rand(n, generator=g, device=dev) * 2.0
    mask = torch.rand(n, generator=g, device=dev) < 0.7
    if case == "masked_warps":  # a range of warps with no lane to walk, one with every lane
        mask[256:1024] = False
        mask[1024:2048] = True
    return td, cfg, o, d, cap, mask, None


@pytest.mark.parametrize("case", ["random", "path_c", "partial_warp", "masked_warps",
                                  "one_triangle"])
def test_shadow_segment_equals_plain(dev, case):
    """The kernel reads its inputs in place and equals the plain any-hit walk
    bit for bit: random rays (some with the counting launch), path C's
    coherent rays of a frame (8x4 pixels a warp, partial tiles on both
    axes), a ray count not a multiple of 32, warps whose lanes are all
    outside or all inside the mask, a one-triangle scene."""
    td, cfg, o, d, cap, mask, width = _shadow_case(case, dev)
    _build.LAUNCHES.clear()
    got = cuda_wavefront.shadow_segment(o, d, cap, mask, td, cfg, width=width)
    assert _build.LAUNCHES["shadow_segment"] == 1
    want = cuda_wavefront.shadow_segment_plain(o, d, cap, mask, td, cfg)
    assert torch.equal(got, want) and want.any() and (mask & ~want).any()
    if case == "random":
        counts = cuda_geometry.WalkCounts.zeros(mask.shape[0], td)
        lanes = torch.zeros(4, dtype=torch.int64, device=dev)
        counted = cuda_wavefront.shadow_segment(o, d, cap, mask, td, cfg, counts=counts,
                                                lanes=lanes)
        assert torch.equal(counted, want)
        assert (counts.tests[1][~mask] == 0).all() and (counts.tests[1][mask] >= 2).all()
        _check_walk_lanes(lanes, int(mask.sum().item()))
        with pytest.raises(ValueError, match="bool"):
            cuda_wavefront.shadow_segment(o, d, cap, mask.to(torch.int32), td, cfg)
        with pytest.raises(ValueError, match="contiguous"):
            cuda_wavefront.shadow_segment(o.T.contiguous().T, d, cap, mask, td, cfg)


@pytest.mark.parametrize(
    "overrides, per_frame",
    [(dict(), {"geometry_bvh": 1, "trace_segment": 8, "atrous_iter": 9, "temporal_blend": 1}),
     (dict(gbuffer_primary=True, nee=True),
      {"geometry_bvh": 1, "shadow_segment": 1, "trace_segment": 7, "atrous_iter": 9,
       "temporal_blend": 1})],
    ids=["A", "C"],
)
def test_large_scene_routes_agree(dev, overrides, per_frame):
    """Paths A and C of the slice (32,768 triangles, 8 bounces, RR from 2,
    adaptive alpha, orbit camera) at 160x128: both routes agree frame by
    frame, and the kernel route launches the slice's kernels."""
    small = dict(width=160, height=128, max_bounces=8, rr_start_bounce=2, adaptive_alpha=True,
                 **overrides)
    r_k = presets.cornell_stress(splits=32, device=dev, **small)
    r_p = presets.cornell_stress(splits=32, device=dev, backend="xla", **small)
    _build.LAUNCHES.clear()
    for i in range(3):
        r_k.camera = r_p.camera = _orbit(i, dev)
        a, b = r_k.step(), r_p.step()
        assert torch.isfinite(a).all()
        assert torch.isclose(a, b, rtol=0, atol=1e-3).double().mean().item() >= 0.99
        assert (a - b).abs().mean().item() <= 1e-4
    assert dict(_build.LAUNCHES) == {k: 3 * v for k, v in per_frame.items()}


def test_cornell_stress_default_runs_on_the_kernel_route(dev):
    """512 triangles: over the dense kernels' tables, so the LBVH kernels."""
    r = presets.cornell_stress(device=dev, width=160, height=128, max_bounces=4)
    _build.LAUNCHES.clear()
    assert torch.isfinite(r.step()).all()
    assert _build.LAUNCHES["geometry_bvh"] == 1 and _build.LAUNCHES["trace_segment"] == 4


# --- the path-gradient / multi-res slice: explicit pixels, visibility mode ---

@pytest.mark.parametrize("seeded", [False, True], ids=["stratum_pixels", "seeded_coarse_tail"])
def test_explicit_pixel_segments_equal_plain(dev, seeded):
    """The segment tracer's explicit-pixel mode on 32,768 triangles at 160x128:
    at the path gradient's stratum pixels from segment 0, or on the phased
    coarse tail seeded from the G-buffer from segment 1, each segment's ray
    state equals the plain segment's on the same input, and the whole trace
    equals ops/pathtrace.trace_pixels."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
        multires,
        pathgrad,
        pathtrace,
    )

    cfg = RenderConfig(width=160, height=128, max_bounces=6, rr_start_bounce=2,
                       indirect_split=1, indirect_stride=4, gbuffer_primary=seeded,
                       indirect_jitter=True)
    td = _stress(32, dev)
    cam, light = _orbit(1, dev), Light.default(dev)
    _, tail_cfg = multires.split_cfgs(cfg)
    primary = None
    if seeded:
        phase = multires.grid_phase(5, cfg.indirect_stride)
        py, px = multires.coarse_pixels(cfg, phase, dev)
        view, proj = frame.camera_matrices(cam, cfg)
        geo = cuda_geometry.geometry_pass_bvh(td, td.lut, cam.position, cam.rotation,
                                              light.position, light.position, light.color,
                                              light.color, view, proj, view, proj, cfg,
                                              emit_albedo=True)
        primary = tuple(multires._subsample(p, cfg.indirect_stride, phase)
                        for p in (geo.visibility, geo.world_pos, geo.normal, geo.albedo))
    else:
        py, px = pathgrad.stratum_pixels(cfg.height, cfg.width, 4, 3, dev)
    pixels = tuple(t.reshape(-1).to(torch.int32).contiguous() for t in (px, py))
    n = pixels[0].numel()
    rays = cuda_wavefront.RayState.empty(n, dev)
    start = 0
    if seeded:
        cuda_wavefront._seed_from_gbuffer(rays, primary, 0, 0, td, cam.position, cam.rotation,
                                          light, 5, tail_cfg, None, pixels)
        start = 1
    _build.LAUNCHES.clear()
    for seg in range(start, tail_cfg.max_bounces):
        plain = cuda_wavefront.RayState(*(t.clone() for t in rays))
        cuda_wavefront.trace_segment(rays, seg, 0, 0, td, cam.position, cam.rotation, light, 5,
                                     tail_cfg, pixels=pixels, first=seg == start)
        cuda_wavefront.trace_segment_plain(plain, seg, 0, 0, td, cam.position, cam.rotation,
                                           light, 5, tail_cfg, pixels)
        for a, b in zip(rays, plain):
            assert torch.equal(a, b), seg
    assert _build.LAUNCHES["trace_segment"] == tail_cfg.max_bounces - start
    got = cuda_wavefront.trace_pixels_wavefront(td, cam.position, light, 5, px, py, tail_cfg,
                                                cam.rotation, primary=primary)
    want = pathtrace.trace_pixels(td, cam.position, light, 5, px, py, tail_cfg,
                                  rotation=cam.rotation, primary=primary)
    assert torch.equal(got, want)


@pytest.mark.parametrize("splits", [None, 32], ids=["dense", "lbvh"])
def test_visibility_mode_equals_plain(dev, splits):
    """The geometry kernels' visibility-only mode gives ops/gbuffer.
    visibility_pass's planes and the full mode's, bit for bit, in one launch."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import gbuffer

    cfg = RenderConfig(width=320, height=192)
    td = (precompute_triangle_data(Scene.cornell_box(), dev) if splits is None
          else _stress(splits, dev))
    cam, light = _orbit(2, dev), Light.default(dev)
    view, proj = frame.camera_matrices(cam, cfg)
    _build.LAUNCHES.clear()
    got = cuda_geometry.visibility_pass(td, cam.position, view, proj, cfg, rotation=cam.rotation)
    name = "geometry[visibility]" if splits is None else "geometry_bvh[visibility]"
    assert dict(_build.LAUNCHES) == {name: 1}
    want = gbuffer.visibility_pass(td, cam.position, view, proj, cfg, rotation=cam.rotation)
    full_pass = cuda_geometry.geometry_pass if splits is None else cuda_geometry.geometry_pass_bvh
    full = full_pass(td, td.lut, cam.position, cam.rotation, light.position, light.position,
                     light.color, light.color, view, proj, view, proj, cfg)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name), getattr(full, name)), name


@pytest.mark.parametrize(
    "path, per_frame",
    [("D", {"geometry_bvh": 1, "trace_segment": 7, "atrous_iter_var": 9,
            "temporal_blend_ramp": 1}),
     ("E", {"geometry": 1, "trace": 1, "trace_segment": 32, "atrous_iter_var": 9,
            "temporal_blend_ramp": 1})],
)
def test_gradient_paths_routes_agree(dev, path, per_frame):
    """Path D (the JAX suite's row 4c'': 32,768 triangles, multi-res
    indirect, G-buffer seed, grid jitter, variance-guided SVGF, the ramp;
    orbit camera) at 160x128 and path E (row 2e: the Cornell box with the
    path gradient under a drifting light) at 512x512: both routes agree
    frame by frame over 2 frames, with the expected launches."""
    if path == "D":
        flags = dict(width=160, height=128, max_bounces=8, rr_start_bounce=2,
                     adaptive_alpha=True, indirect_split=1, indirect_stride=4,
                     gbuffer_primary=True, indirect_jitter=True, variance_guided=True,
                     accumulation_ramp=True, ramp_reset_mode="normal")
        r_k = presets.cornell_stress(splits=32, device=dev, **flags)
        r_p = presets.cornell_stress(splits=32, device=dev, backend="xla", **flags)
    else:
        cfg = RenderConfig(width=512, height=512, variance_guided=True, accumulation_ramp=True,
                           path_gradient=True)
        r_k = Renderer(Scene.cornell_box(), cfg, device=dev)
        r_p = Renderer(Scene.cornell_box(), dataclasses.replace(cfg, backend="xla"), device=dev)
    _build.LAUNCHES.clear()
    for i in range(2):
        for r in (r_k, r_p):
            if path == "D":
                r.camera = _orbit(i, dev)
            else:
                r.move_light(dx=0.05)
        a, b = r_k.step(), r_p.step()
        assert torch.isfinite(a).all()
        assert torch.isclose(a, b, rtol=0, atol=1e-3).double().mean().item() >= 0.99
        assert (a - b).abs().mean().item() <= 1e-4
    assert dict(_build.LAUNCHES) == {k: 2 * v for k, v in per_frame.items()}


# --- the redesigned trace kernels: pixel-persistent dense tracer, live-list
# segment tracer ---

SMALL = dict(width=96, height=64)


# Scenes for the NEE shadow loop's plane-first cut: the light's position and
# the camera's (position, target), None for the defaults.
TRACE_SCENES = {
    "default": (None, None),
    # the light's centre behind the right wall's plane (x = 1): the wall
    # occludes much of the sphere
    "light_behind_wall": ([1.05, 1.0, -0.4], None),
    # the camera in the floor's plane, looking along it: with no jitter and
    # an odd height, the middle row's rays run parallel to the floor
    "along_floor": (None, ([-0.001, 0.0, 6.0], [-0.001, 0.0, 0.0])),
    # the sphere (radius 0.2) rests on the short box's top face (y = 0.6):
    # rays enter it where that face's plane is
    "light_on_box": ([0.33, 0.8, 0.37], None),
}


@pytest.mark.parametrize(
    "overrides, scene",
    [(dict(), "default"), (dict(nee=True), "default"), (dict(rr_start_bounce=2), "default"),
     (dict(spp=3, sample_batches=2), "default"), (dict(truncate_radiance=True), "default"),
     (dict(nee=True, spp=2, rr_start_bounce=1, max_bounces=5), "default"),
     (dict(nee=True), "light_behind_wall"),
     (dict(nee=True, aa_sigma=0.0, height=63), "along_floor"),
     (dict(nee=True), "light_on_box")],
    ids=["parity", "nee", "rr2", "spp3_batches2", "truncate", "nee_spp2_rr1",
         "nee_light_behind_wall", "nee_along_floor", "nee_light_on_box"],
)
def test_trace_kernel_bit_equal_to_plain(dev, overrides, scene):
    """The persistent dense kernel gives the plain tracer's image bit for
    bit, and its counting launch the same image, a lane efficiency whose
    triangle loops count the whole tests and, under NEE only, a shadow loop
    whose barycentric pass takes fewer warp steps than its plane pass."""
    cfg = RenderConfig(**{**SMALL, **overrides})
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    light_at, view = TRACE_SCENES[scene]
    cam, light = Camera.default(dev), Light.default(dev)
    if light_at is not None:
        light = Light(torch.tensor(light_at, dtype=torch.float32, device=dev), light.color)
    if view is not None:
        cam = Camera.looking_at(*view, device=dev)
    k = cuda_pathtrace.path_trace_pass(td, cam.position, light, 4, cfg, cam.rotation)
    p = cuda_pathtrace.path_trace_pass_plain(td, cam.position, light, 4, cfg,
                                             rotation=cam.rotation)
    assert torch.equal(k, p)
    lanes = torch.zeros(4, dtype=torch.int64, device=dev)
    shadow = torch.zeros(4, dtype=torch.int64, device=dev)
    tests = torch.zeros((cfg.height, cfg.width), dtype=torch.int32, device=dev)
    path_len = torch.zeros((cfg.sample_batches * cfg.spp, cfg.height, cfg.width),
                           dtype=torch.int32, device=dev)
    counted = cuda_pathtrace.path_trace_pass(td, cam.position, light, 4, cfg, cam.rotation,
                                             tests=tests, path_len=path_len, lanes=lanes,
                                             shadow=shadow)
    assert torch.equal(counted, k)
    assert path_len.min().item() >= 1 and path_len.max().item() <= cfg.max_bounces
    # every bounce of every path is one lane step of the bounce loop, and
    # every whole triangle test one lane step of the triangle loops
    assert lanes[0].item() == path_len.sum(dtype=torch.int64).item()
    assert 0 < lanes[0].item() <= 32 * lanes[1].item()
    assert lanes[2].item() == tests.sum(dtype=torch.int64).item()
    assert 0 < lanes[2].item() <= 32 * lanes[3].item()
    planes, plane_steps, bary, bary_steps = shadow.tolist()
    if cfg.nee:
        # the barycentric pass's whole tests are some of the triangle loops'
        # steps, and it takes fewer warp steps than the plane pass
        assert 0 < bary_steps < plane_steps and bary_steps < lanes[3].item()
        assert 0 < bary <= 32 * bary_steps and bary < planes <= 32 * plane_steps
    else:
        assert (planes, plane_steps, bary, bary_steps) == (0, 0, 0, 0)


def _occluded_probe(td, rays, eps):
    """DenseTable::occluded and the whole test of every triangle on rays
    (n, 8: origin, direction, cap, t_max; csrc/pathtrace.cu
    occluded_probe_kernel): the two answers and each ray's least valid t."""
    n = rays.shape[0]
    table = cuda_pathtrace.pack_table(td)
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    out = torch.empty((n, 2), dtype=torch.int32, device=rays.device)
    _build.launch("ptsf_occluded_probe", table.data_ptr(), td.num_triangles, rays.data_ptr(), n,
                  eps, t.data_ptr(), out.data_ptr())
    return out[:, 0].bool(), out[:, 1].bool(), t


@pytest.mark.parametrize("scene", ["cornell_box", "one_plane"])
def test_shadow_loop_plane_cut_keeps_boundary_hits(dev, scene):
    """The shadow loop's division-free plane cut (common.cuh may_reach)
    drops no triangle the whole test keeps: segments that end exactly at
    their nearest hit's t, by cap or by t_max, or one float either side of
    it, get from DenseTable::occluded the answer of the whole test of every
    triangle."""
    if scene == "one_plane":  # one large triangle in the plane y = 0.6
        verts = np.array([[-4.0, 0.6, -4.0], [4.0, 0.6, -4.0], [0.0, 0.6, 6.0]], np.float32)
        td = precompute_triangle_data(Scene.from_arrays(verts, np.array([[0, 1, 2]], np.int32)),
                                      dev)
    else:
        td = precompute_triangle_data(Scene.cornell_box(), dev)
    g = torch.Generator().manual_seed(17)
    n = 8192
    o = torch.rand((n, 3), generator=g) * torch.tensor([1.9, 1.9, 1.9]) + torch.tensor(
        [-0.95, 0.04, -1.0])
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    far = torch.full((n, 1), 1e4)
    eps = RenderConfig().intersect_eps
    _, _, least = _occluded_probe(td, torch.cat([o, d, far, far], 1).to(dev).contiguous(), eps)
    keep = torch.isfinite(least)
    assert keep.sum().item() > n // 4
    t = least[keep]
    od = torch.cat([o, d], 1).to(dev)[keep]
    big = torch.full_like(t, 1e4)
    below, above = torch.nextafter(t, t - 1), torch.nextafter(t, t + 1)
    cases = {(True, "cap"): (t, big), (True, "t_max"): (big, t), (True, "both"): (t, t),
             (True, "cap above"): (above, big), (True, "t_max above"): (big, above),
             (False, "cap below"): (below, big), (False, "t_max below"): (big, below)}
    for (hit, name), (cap, t_max) in cases.items():
        rays = torch.cat([od, cap[:, None], t_max[:, None]], 1).contiguous()
        got, want, _ = _occluded_probe(td, rays, eps)
        assert bool(want.all()) if hit else not bool(want.any()), name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("mode", ["frame", "pixels", "gbuffer_seed"])
def test_segment_tracer_bit_equal_to_plain(dev, mode):
    """The live-list segment tracer over a whole frame, on explicit pixels
    and with the G-buffer seed (32,768 triangles, NEE and RR): bit-equal to
    the plain tracer."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import pathtrace

    cfg = RenderConfig(**SMALL, max_bounces=6, nee=True, rr_start_bounce=1,
                       gbuffer_primary=mode == "gbuffer_seed")
    td = _stress(32, dev)
    cam, light = _orbit(2, dev), Light.default(dev)
    _build.LAUNCHES.clear()
    if mode == "pixels":
        g = torch.Generator().manual_seed(5)
        px = torch.randint(0, cfg.width, (40, 30), generator=g).to(dev)
        py = torch.randint(0, cfg.height, (40, 30), generator=g).to(dev)
        got = cuda_wavefront.trace_pixels_wavefront(td, cam.position, light, 4, px, py, cfg,
                                                    cam.rotation)
        want = pathtrace.trace_pixels(td, cam.position, light, 4, px, py, cfg,
                                      rotation=cam.rotation)
    else:
        primary = None
        if mode == "gbuffer_seed":
            view, proj = frame.camera_matrices(cam, cfg)
            geo = cuda_geometry.geometry_pass_bvh(td, td.lut, cam.position, cam.rotation,
                                                  light.position, light.position, light.color,
                                                  light.color, view, proj, view, proj, cfg,
                                                  emit_albedo=True)
            primary = (geo.visibility, geo.world_pos, geo.normal, geo.albedo)
        got = cuda_wavefront.path_trace_wavefront(td, cam.position, light, 4, cfg, cam.rotation,
                                                  primary=primary)
        want = pathtrace.path_trace_pass(td, cam.position, light, 4, cfg, rotation=cam.rotation,
                                         primary=primary)
    assert _build.LAUNCHES["trace_segment"] == cfg.max_bounces - cfg.gbuffer_primary
    assert torch.equal(got, want)


def test_trace_kernels_repeat_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits: the atomics and
    the order in which warps take pixels and rays change nothing."""
    cfg = RenderConfig(**SMALL, nee=True, spp=2, rr_start_bounce=2, max_bounces=8)
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    cam, light = Camera.default(dev), Light.default(dev)
    first = cuda_pathtrace.path_trace_pass(td, cam.position, light, 6, cfg, cam.rotation)
    for _ in range(3):
        assert torch.equal(cuda_pathtrace.path_trace_pass(td, cam.position, light, 6, cfg,
                                                          cam.rotation), first)
    big = _stress(32, dev)
    first = cuda_wavefront.path_trace_wavefront(big, cam.position, light, 6, cfg, cam.rotation)
    for _ in range(3):
        assert torch.equal(cuda_wavefront.path_trace_wavefront(big, cam.position, light, 6, cfg,
                                                               cam.rotation), first)


def test_live_lists_hold_the_live_rays(dev):
    """After each launch the list it wrote holds exactly the slots of the
    rays that go on, and a launch from that list equals one that starts a
    path there (every slot, by the alive flags)."""
    cfg = RenderConfig(**SMALL, max_bounces=6, rr_start_bounce=1)
    td = _stress(32, dev)
    cam, light = _orbit(1, dev), Light.default(dev)
    n = cfg.width * cfg.height
    rays = cuda_wavefront.RayState.empty(n, dev)
    every = cuda_wavefront.RayState.empty(n, dev)
    live = cuda_wavefront.LiveLists(n, dev)
    other = cuda_wavefront.LiveLists(n, dev)
    for seg in range(cfg.max_bounces):
        for r, lists, first in ((rays, live, seg == 0), (every, other, True)):
            cuda_wavefront.trace_segment(r, seg, 0, 0, td, cam.position, cam.rotation, light, 2,
                                         cfg, first=first, lists=lists)
        listed = torch.sort(live.last_list()).values
        assert torch.equal(listed, torch.nonzero(rays.alive).squeeze(1).to(torch.int32)), seg
        for a, b in zip(rays, every):
            assert torch.equal(a, b), seg


@pytest.mark.parametrize("name", list(cuda_micro.PRIMITIVES))
def test_micro_kernel_equals_plain_twin(dev, name):
    """Each micro-kernel at two iteration counts: the output equals the
    input, and the output and every carry equal the plain twin's bits."""
    x = cuda_micro.make_input(dev)
    for iters in (16, 300):
        _build.LAUNCHES.clear()
        got = cuda_micro.run(name, x, iters)
        assert _build.LAUNCHES == {f"micro_{cuda_micro.PRIMITIVES[name].kernel}": 1}
        want = cuda_micro.run_plain(name, x, iters)
        assert sorted(got) == sorted(want)
        assert torch.equal(got["out"], x)
        for key in want:
            assert torch.equal(got[key], want[key]), (name, iters, key)


def test_bench_and_quick_suite_row_run_on_the_card(dev):
    """bench_torch's frame and one row of the port's suite (--quick, with
    device time) give finite times on the card."""
    import bench_torch
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import suite

    ms, name = bench_torch.run_bench(320, 240, frames=2, warmup=1, device=dev)
    assert np.isfinite(ms) and ms > 0 and name == torch.cuda.get_device_name(dev)
    (row, result), = suite.run_suite(True, only="cornell_512_spatial_only", device=dev,
                                     device_time=True)
    assert row == "cornell_512_spatial_only"
    assert np.isfinite(result["ms"]) and result["device_ms"] > 0 and result["launches"] > 0


# --- the per-frame model matrix: the move's two kernels ---

MODEL_POSES = {
    "identity": np.eye(4, dtype=np.float32),
    "rotation_0": chip_smoke.model_rotation(0.0),
    "rotated": chip_smoke.model_rotation(4 * chip_smoke.MODEL_STEP),
}


@pytest.mark.parametrize("pose", list(MODEL_POSES))
@pytest.mark.parametrize("tris", [32, 128, 32768])
def test_model_kernels_equal_plain(dev, tris, pose):
    """transform_tables and bvh_refit equal their plain versions bit for
    bit (the node table as bits: its child ids are NaN as floats), the
    refitted table the host's pack of the rest tree over the moved
    triangles; at identity the move gives the rest pose's tables."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import lbvh, procedural

    splits = chip_smoke.MODEL_SCENES[tris]
    verts, idx = procedural.cornell_box() if splits is None else procedural.subdivided_cornell(splits)
    td = precompute_triangle_data(Scene.from_arrays(verts, idx), dev)
    m = torch.tensor(MODEL_POSES[pose], device=dev)
    tables, workspace = cuda_model.transform_tables(td, m)
    want, coord_max = cuda_model.transform_tables_plain(td, m)
    for k in cuda_model.TABLES:
        assert torch.equal(tables[k], want[k]), k
    assert torch.equal(workspace[:1].view(torch.float32)[0], coord_max)
    nodes = cuda_model.bvh_refit(td.bvh, tables["lut"], workspace).view(torch.int32)
    assert torch.equal(nodes, cuda_model.bvh_refit_plain(td.bvh, want["lut"][1:]).view(torch.int32))
    moved = want["lut"][1:].cpu().numpy()
    host = lbvh.pack_bvh_nodes(lbvh.refit_lbvh(lbvh.build_lbvh(verts[idx]), moved), moved)
    np.testing.assert_array_equal(nodes.cpu().numpy(), host.view(np.int32))
    if pose == "identity":
        assert torch.equal(tables["lut"], td.lut) and torch.equal(tables["tests"], td.bvh.tris)
        assert torch.equal(nodes, td.bvh.nodes.view(torch.int32))


@pytest.mark.parametrize("splits", [None, 2], ids=["dense", "lbvh"])
def test_identity_model_kernel_route_bit_identical(dev, splits):
    """On the kernel route an identity model gives frames bit-identical to
    no model, and launches the move's kernels a frame: the refit only on
    the scene that walks the LBVH."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    scene = (Scene.cornell_box() if splits is None
             else Scene.from_arrays(*procedural.subdivided_cornell(splits)))
    cfg = RenderConfig(width=160, height=128, max_bounces=8)
    plain, still = Renderer(scene, cfg, device=dev), Renderer(scene, cfg, device=dev)
    still.set_model(np.eye(4))
    _build.LAUNCHES.clear()
    for _ in range(3):
        assert torch.equal(still.step(), plain.step())
    assert _build.LAUNCHES["transform_tables"] == 3
    assert _build.LAUNCHES["bvh_refit"] == (0 if splits is None else 3)


def test_native_loader_and_apply_keys_on_the_card(dev, tmp_path):
    """The native OBJ loader builds with the machine's g++ and equals the
    Python parser on the 32,768-triangle box; apply_keys on the card's
    tensors runs every binding and both wraps without a sync
    (set_sync_debug_mode "error") and equals the CPU."""
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.native import loader
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import obj, procedural

    path = str(tmp_path / "box.obj")
    procedural.write_obj(path, *procedural.subdivided_cornell(32))
    for got, want in zip(loader.load_obj(path), obj.load_obj_python(path)):
        np.testing.assert_array_equal(got, want)
    assert chip_smoke.input_sync_check(pt, dev) == len(chip_smoke.KEY_SETS)


def _matrices_copied_up(camera, cfg, dev):
    """camera_matrices as every frame once built them on the card: the
    numpy projection copied up and flipped there, the view's last row made
    by torch.tensor."""
    proj = cam_ops.perspective(cfg.fov * 2.0, cfg.width / cfg.height, cfg.near, cfg.far,
                               device=dev)
    proj[1, 1] = -proj[1, 1]
    rt = camera.rotation.T
    top = torch.cat([rt, -cam_ops.mat_apply(rt, camera.position, w=False)[:, None]], dim=1)
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    return torch.cat([top, last]), proj


@pytest.mark.parametrize("traffic", ["quality_orbit", "interactive_orbit_dense"])
def test_frame_matrices_make_no_sync(dev, traffic):
    """Once the renderer has made its first history, frame.camera_matrices
    copies nothing from the host: under set_sync_debug_mode("error") it
    raises nothing, nor do two Renderer.step() frames of the benchmark
    cell's render mode at 160x128, and its matrices equal those built by
    copying up from the host."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "perfbench", "traffic", f"{traffic}.json")) as f:
        cfg = RenderConfig(width=160, height=128, **json.load(f)["render"])
    _build.library()
    r = Renderer(Scene.cornell_box(), cfg, device=dev)
    cams = [Camera.orbit([0.0, 1.0, 0.0], 6.0, a, 1.0, device=dev) for a in (0.1, 0.11)]
    want = [_matrices_copied_up(c, cfg, dev) for c in cams]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [frame.camera_matrices(c, cfg) for c in cams]
        for c in cams:
            r.camera = c
            r.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (view, proj), (want_view, want_proj) in zip(got, want):
        assert torch.equal(view, want_view)
        assert torch.equal(proj, want_proj)
