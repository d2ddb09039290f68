"""The large-scene slice: the port's plain LBVH frame against the JAX
package's XLA frame, the kernel route's wiring (LBVH geometry pass, segment
tracer, shadow segment) on CPU tensors, and the G-buffer seed.

The scene is subdivided_cornell(6): 1,152 triangles, at or above both
ops/intersect.BVH_MIN_TRIANGLES (so the port walks the LBVH) and the JAX
package's _NUMPY_PREP_MIN_TRIS (so both packages build the same numpy
tables). The frames are cut to 48x32, 6 bounces and 3 a-trous iterations,
with the orbit camera of the JAX package's benchmark suite.
"""

import dataclasses

import numpy as np
import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    Light,
    Renderer,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    atrous,
    gbuffer,
    intersect,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    _build,
    wavefront,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural
from test_torch_estimators import assert_nee_matches

torch.set_num_threads(1)

SPLITS = 6
CUT = dict(width=48, height=32, max_bounces=6, wavelet_iterations=3)
# path A's levers (the JAX suite's interactive mid-scale row) and path C's
# flags on top of them
PATHS = {
    "A": dict(rr_start_bounce=2, adaptive_alpha=True),
    "C": dict(rr_start_bounce=2, adaptive_alpha=True, gbuffer_primary=True, nee=True),
}
FRAMES = 3


def _orbit(i, jax_camera=False):
    cls = jx.Camera if jax_camera else Camera
    return cls.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0)


def _scene():
    return Scene.from_arrays(*procedural.subdivided_cornell(SPLITS))


@pytest.fixture(scope="module")
def jax_tri_data():
    return jx.precompute_triangle_data(jx.Scene.from_arrays(*procedural.subdivided_cornell(SPLITS)))


@pytest.mark.parametrize("path", list(PATHS))
def test_plain_frame_matches_jax(jax_tri_data, path):
    """3 orbit frames of the plain route (LBVH queries) against the jitted
    JAX XLA frame (dense queries), at the golden criterion."""
    cfg = RenderConfig(**CUT, **PATHS[path], backend="xla")
    r = Renderer(_scene(), cfg, device="cpu")
    assert intersect.uses_bvh(r.tri_data)
    hist = jframe.init_history(jax_tri_data, cfg)
    for i in range(FRAMES):
        want, hist = jframe.render_frame(jax_tri_data, _orbit(i, True), jx.Light.default(),
                                         hist, cfg)
        r.camera = _orbit(i)
        assert_nee_matches(r.step().numpy(), np.asarray(want))


@pytest.mark.parametrize("path", list(PATHS))
def test_kernel_route_wiring_matches_plain_route(path):
    """The kernel route on CPU tensors -- LBVH geometry pass, segment
    tracer, under C the G-buffer seed and the shadow segment, each wrapper
    running its plain version -- gives the plain route's frames and
    histories exactly, and launches nothing."""
    cfg = RenderConfig(**CUT, **PATHS[path])
    r = Renderer(_scene(), cfg, device="cpu")
    hist = r.history
    _build.LAUNCHES.clear()
    for i in range(2):
        r.camera = _orbit(i)
        want, hist_next = tframe.render_frame_impl(r.tri_data, r.camera, r.light, hist,
                                                   dataclasses.replace(cfg, backend="xla"))
        got, got_hist = tframe._render_frame_kernels(r.tri_data, r.camera, r.light, hist, cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(got_hist.image, hist_next.image, rtol=0, atol=0)
        hist = hist_next
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize(
    "overrides",
    [dict(), dict(nee=True), dict(rr_start_bounce=2), dict(spp=2, sample_batches=2),
     dict(truncate_radiance=True)],
    ids=["parity", "nee", "rr2", "spp2_batches2", "truncate"],
)
def test_segment_tracer_equals_one_launch_tracer(overrides):
    """The segment tracer's host loop (samples in sequence, the fall-through
    epilogue, the (sum / spp) / batches average) over the plain segments
    gives ops/pathtrace's image bit for bit, as the kernels do on the card."""
    cfg = RenderConfig(width=24, height=16, max_bounces=5, **overrides)
    td = precompute_triangle_data(_scene(), "cpu")
    cam, light = _orbit(2), Light.default()
    want = pathtrace.path_trace_pass(td, cam.position, light, 4, cfg, rotation=cam.rotation)
    got = wavefront.path_trace_wavefront(td, cam.position, light, 4, cfg, cam.rotation)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_gbuffer_seed(nee):
    """Bounce 0 off the G-buffer: without NEE the trace equals a full trace
    at aa_sigma = 0 (the jitter draws still advance the stream); the
    segment tracer with its deferred shadow segment equals the plain
    tracer with the shadow test in place."""
    cfg = RenderConfig(width=24, height=16, max_bounces=5, nee=nee)
    td = precompute_triangle_data(_scene(), "cpu")
    cam, light = _orbit(1), Light.default()
    view, proj = tframe.camera_matrices(cam, cfg)
    gbuf = gbuffer.visibility_pass(td, cam.position, view, proj, cfg, rotation=cam.rotation)
    primary = (gbuf.visibility, gbuf.world_pos, td.lut_normals[gbuf.visibility.long()],
               atrous.albedo_image(td, gbuf.visibility))
    seeded = dataclasses.replace(cfg, gbuffer_primary=True)
    got = pathtrace.path_trace_pass(td, cam.position, light, 3, seeded, rotation=cam.rotation,
                                    primary=primary)
    if not nee:
        full = pathtrace.path_trace_pass(td, cam.position, light, 3,
                                         dataclasses.replace(cfg, aa_sigma=0.0),
                                         rotation=cam.rotation)
        torch.testing.assert_close(got, full, rtol=0, atol=0)
    segments = wavefront.path_trace_wavefront(td, cam.position, light, 3, seeded, cam.rotation,
                                              primary=primary)
    torch.testing.assert_close(segments, got, rtol=0, atol=0)


def test_shadow_segment_plain_equals_scene_occlusion():
    td = precompute_triangle_data(_scene(), "cpu")
    rng = np.random.default_rng(5)
    o = torch.tensor(rng.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32)) + torch.tensor([0, 1, 0])
    d = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(2000, 3)).astype(np.float32)),
                                      dim=-1)
    cap = torch.tensor(rng.uniform(0.0, 2.0, 2000).astype(np.float32))
    mask = torch.tensor(rng.random(2000) < 0.6)
    cfg = RenderConfig()
    got = wavefront.shadow_segment(o, d, cap, mask, td, cfg)
    want = intersect.scene_occluded(td, o, d, cap) & mask
    assert torch.equal(got, want) and want.any() and (mask & ~want).any()
