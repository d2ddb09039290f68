"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

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
    pathtrace as cuda_pathtrace,
    wavefront as cuda_wavefront,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
CFG = RenderConfig()  # the reference's 1000x800 frame


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _seeded(seed, dev):
    """Seeded HDR color and history, lambda and a random backprojection."""
    r = np.random.default_rng(seed)
    h, w = CFG.height, CFG.width

    def t(a):
        return torch.tensor(a, device=dev)

    return (t(r.exponential(0.5, (h, w, 3)).astype(np.float32)),
            t(r.exponential(0.5, (h, w, 3)).astype(np.float32)),
            t(r.uniform(0.0, 1.0, (h, w)).astype(np.float32)),
            t(r.integers(0, h, (h, w)).astype(np.int32)),
            t(r.integers(0, w, (h, w)).astype(np.int32)))


def _geometry_args(dev):
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    cam, light = Camera.default(dev), Light.default(dev)
    view, proj = frame.camera_matrices(cam, CFG)
    view_p, proj_p = frame.camera_matrices(
        cam.position + torch.tensor([0.0, 0.0, 0.5], device=dev), CFG
    )
    return (td, td.lut, cam.position, cam.rotation, light.position,
            light.position + torch.tensor([0.5, 0.0, 0.0], device=dev),
            light.color, light.color * 0.5, view, proj, view_p, proj_p, CFG)


def test_geometry_kernel(dev):
    args = _geometry_args(dev)
    _build.LAUNCHES.clear()
    k = cuda_geometry.geometry_pass(*args)
    assert _build.LAUNCHES["geometry"] == 1
    p = cuda_geometry.geometry_pass_plain(*args)
    assert (k.visibility != p.visibility).double().mean().item() <= 1e-4
    same = k.visibility == p.visibility
    torch.testing.assert_close(k.depth[same], p.depth[same], atol=1e-5, rtol=0)
    torch.testing.assert_close(k.normal[same], p.normal[same], atol=1e-6, rtol=0)
    torch.testing.assert_close(k.world_pos[same], p.world_pos[same], atol=1e-5, rtol=0)
    torch.testing.assert_close(k.lam[same], p.lam[same], atol=2e-4, rtol=0)
    for a, b in ((k.prev_y, p.prev_y), (k.prev_x, p.prev_x)):
        d = (a - b).abs()
        assert d.max().item() <= 1 and (d > 0).double().mean().item() < 1e-3


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


@pytest.mark.parametrize("k", range(1, 10))
def test_atrous_iter_kernel(dev, k):
    geo = cuda_geometry.geometry_pass(*_geometry_args(dev))
    color = _seeded(k, dev)[0]
    torch.testing.assert_close(
        cuda_atrous.atrous_iteration(color, geo.normal, geo.depth, k, CFG),
        cuda_atrous.atrous_iteration_plain(color, geo.normal, geo.depth, k, CFG),
        rtol=1e-5, atol=1e-5,
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


@pytest.mark.parametrize("k", range(1, 10))
def test_atrous_iter_var_kernel(dev, k):
    geo = cuda_geometry.geometry_pass(*_geometry_args(dev))
    color = _seeded(k, dev)[0]
    var = 0.1 * _seeded(k + 10, dev)[2]
    got_c, got_v = cuda_atrous.atrous_iteration_var(color, var, geo.normal, geo.depth, k, CFG)
    want_c, want_v = cuda_atrous.atrous_iteration_var_plain(color, var, geo.normal, geo.depth,
                                                             k, CFG)
    torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-5)


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


def test_bvh_geometry_kernel_equals_dense_kernel(dev):
    """At 288 triangles both kernels run; every plane is bit-equal, and the
    counting launch gives the same planes."""
    td = _stress(3, dev)
    args = (td, td.lut) + _geometry_args(dev)[2:]
    _build.LAUNCHES.clear()
    dense = cuda_geometry.geometry_pass(*args, emit_albedo=True)
    counts = cuda_geometry.WalkCounts.zeros(CFG.height * CFG.width, td)
    bvh = cuda_geometry.geometry_pass_bvh(*args, emit_albedo=True)
    counted = cuda_geometry.geometry_pass_bvh(*args, emit_albedo=True, counts=counts)
    assert _build.LAUNCHES["geometry_bvh"] == 2
    for name in dense._fields:
        assert torch.equal(getattr(dense, name), getattr(bvh, name)), name
        assert torch.equal(getattr(counted, name), getattr(bvh, name)), name
    assert counts.tests[1].min().item() >= 2  # every pixel tests the root's two boxes
    assert counts.nodes[0].item() == 1 and counts.tris.sum().item() > 0
    # the rows read hold every committed triangle
    committed = bvh.visibility[bvh.visibility > 0].to(torch.int64) - 1
    assert (counts.tris[committed] == 1).all()


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


def test_shadow_segment_equals_plain(dev):
    cfg = RenderConfig()
    td = _stress(32, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    n = 100_000
    o = torch.rand((n, 3), generator=g, device=dev) * 1.8 - torch.tensor([0.9, -0.05, 0.9], device=dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
    cap = torch.rand(n, generator=g, device=dev) * 2.0
    mask = torch.rand(n, generator=g, device=dev) < 0.7
    _build.LAUNCHES.clear()
    got = cuda_wavefront.shadow_segment(o, d, cap, mask, td, cfg)
    assert _build.LAUNCHES["shadow_segment"] == 1
    want = cuda_wavefront.shadow_segment_plain(o, d, cap, mask, td, cfg)
    assert torch.equal(got, want) and want.any() and (mask & ~want).any()


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


@pytest.mark.parametrize(
    "overrides",
    [dict(), dict(nee=True), dict(rr_start_bounce=2), dict(spp=3, sample_batches=2),
     dict(truncate_radiance=True), dict(nee=True, spp=2, rr_start_bounce=1, max_bounces=5)],
    ids=["parity", "nee", "rr2", "spp3_batches2", "truncate", "nee_spp2_rr1"],
)
def test_trace_kernel_bit_equal_to_plain(dev, overrides):
    """The persistent dense kernel gives the plain tracer's image bit for
    bit, and its counting launch the same image and a lane efficiency."""
    cfg = RenderConfig(**SMALL, **overrides)
    td = precompute_triangle_data(Scene.cornell_box(), dev)
    cam, light = Camera.default(dev), Light.default(dev)
    k = cuda_pathtrace.path_trace_pass(td, cam.position, light, 4, cfg, cam.rotation)
    p = cuda_pathtrace.path_trace_pass_plain(td, cam.position, light, 4, cfg,
                                             rotation=cam.rotation)
    assert torch.equal(k, p)
    lanes = torch.zeros(4, dtype=torch.int64, device=dev)
    path_len = torch.zeros((cfg.sample_batches * cfg.spp, cfg.height, cfg.width),
                           dtype=torch.int32, device=dev)
    counted = cuda_pathtrace.path_trace_pass(td, cam.position, light, 4, cfg, cam.rotation,
                                             path_len=path_len, lanes=lanes)
    assert torch.equal(counted, k)
    assert path_len.min().item() >= 1 and path_len.max().item() <= cfg.max_bounces
    # every bounce of every path is one lane step of the bounce loop
    assert lanes[0].item() == path_len.sum(dtype=torch.int64).item()
    assert 0 < lanes[0].item() <= 32 * lanes[1].item()
    assert 0 < lanes[2].item() <= 32 * lanes[3].item()


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
