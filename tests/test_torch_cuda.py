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
    pathtrace as cuda_pathtrace,
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
