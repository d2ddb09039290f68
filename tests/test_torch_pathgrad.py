"""The A-SVGF path gradient (ops/pathgrad.py) and the segment tracer's
explicit-pixel mode against the JAX package.

At golden scale: 48x32, 6 bounces. The stratum pixels are bit-equal to the
JAX package's over 64 frames; the gradient pass is exactly 0 on a static
scene (with and without the G-buffer seed) and equals the JAX package's
after the light moves; the segment tracer traces pixel lists as the plain
tracer does, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    pathgrad as jpathgrad,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Light,
    Renderer,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    atrous,
    gbuffer,
    multires,
    pathgrad,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import wavefront
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

torch.set_num_threads(1)

CUT = dict(width=48, height=32, max_bounces=6, wavelet_iterations=3)
LIGHT_STEP = np.float32([0.1, 0.0, 0.0])


def test_stratum_pixels_match_jax():
    """Bit-equal over 64 frames, on an even and a ragged frame, at the
    default stratum and at 4."""
    jit_pixels = jax.jit(jpathgrad.stratum_pixels, static_argnums=(0, 1, 3))
    for h, w in ((32, 48), (35, 50)):
        for stratum in (3, 4):
            for f in range(64):
                gy, gx = pathgrad.stratum_pixels(h, w, f, stratum)
                jy, jx_ = jit_pixels(h, w, jnp.int32(f), stratum)
                np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))
                np.testing.assert_array_equal(gx.numpy(), np.asarray(jx_))


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "gbuffer_primary"])
def test_path_gradient_pass(cornell_tri_data, seeded):
    """After one frame on a static scene the re-trace reproduces the stored
    luminance, so the gradient is exactly 0 (also on the segment tracer);
    after the light moves it equals the JAX package's pass on the same
    inputs at the golden tolerance, and the segment tracer's bit for bit."""
    cfg = RenderConfig(**CUT, adaptive_alpha=True, path_gradient=True, gbuffer_primary=seeded)
    r = Renderer(Scene.cornell_box(), cfg, device="cpu")
    r.step()
    hist, cam = r.history, r.camera
    view, proj = tframe.camera_matrices(cam, cfg)
    gbuf = gbuffer.visibility_pass(r.tri_data, cam.position, view, proj, cfg,
                                   rotation=cam.rotation)
    py, px = atrous.backproject_pixels(gbuf, hist.lut, hist.view, hist.proj, cfg)

    def grad(light, trace_fn=None):
        return pathgrad.path_gradient_pass(
            r.tri_data, light, 1, cfg, hist.noisy_lum, hist.cam_pos, hist.cam_rot, py, px,
            gbuf.visibility, hist.visibility, trace_fn=trace_fn)

    for trace_fn in (None, wavefront.trace_pixels_wavefront):
        assert torch.count_nonzero(grad(r.light, trace_fn)) == 0

    moved = Light(position=r.light.position + torch.tensor(LIGHT_STEP), color=r.light.color)
    got = grad(moved)
    assert torch.count_nonzero(got) > 0
    torch.testing.assert_close(grad(moved, wavefront.trace_pixels_wavefront), got, rtol=0, atol=0)
    jlight = jx.Light(position=jnp.asarray(moved.position.numpy()),
                      color=jnp.asarray(moved.color.numpy()))
    args = [hist.noisy_lum, hist.cam_pos, hist.cam_rot, py.to(torch.int32), px.to(torch.int32),
            gbuf.visibility, hist.visibility]
    jgrad = jax.jit(functools.partial(jpathgrad.path_gradient_pass, cornell_tri_data, jlight,
                                      jnp.int32(1), cfg))
    want = jgrad(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_trace_pixels_wavefront_equals_trace_pixels():
    """On an LBVH scene: the segment tracer's explicit-pixel mode (plain
    segments) equals ops/pathtrace.trace_pixels at the stratum pixels, and
    under the multi-res split (G-buffer seed, throughput, phased coarse
    grid) it equals the plain traces bit for bit; the coarse tail's
    truncated prefix equals the full-res truncated trace at those pixels
    (the PCG-prefix identity the split rests on)."""
    cfg = RenderConfig(**CUT, rr_start_bounce=2, gbuffer_primary=True, indirect_split=1,
                       indirect_stride=4, indirect_jitter=True)
    td = precompute_triangle_data(Scene.from_arrays(*procedural.subdivided_cornell(2)), "cpu")
    cam = Renderer(Scene.cornell_box(), cfg, device="cpu").camera
    light = Light.default()
    gy, gx = pathgrad.stratum_pixels(cfg.height, cfg.width, 3, 3)
    plain_cfg = dataclasses.replace(cfg, gbuffer_primary=False, indirect_split=0,
                                    indirect_jitter=False)
    want = pathtrace.trace_pixels(td, cam.position, light, 2, gx, gy, plain_cfg,
                                  rotation=cam.rotation)
    got = wavefront.trace_pixels_wavefront(td, cam.position, light, 2, gx, gy, plain_cfg,
                                           cam.rotation)
    assert got.shape == gy.shape + (3,)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    view, proj = tframe.camera_matrices(cam, cfg)
    gbuf = gbuffer.visibility_pass(td, cam.position, view, proj, cfg, rotation=cam.rotation)
    primary = (gbuf.visibility, gbuf.world_pos, td.lut_normals[gbuf.visibility.long()],
               atrous.albedo_image(td, gbuf.visibility))
    split_cfg, tail_cfg = multires.split_cfgs(cfg)
    phase = multires.grid_phase(5, cfg.indirect_stride)
    assert phase != (0, 0)
    prim_c = tuple(multires._subsample(p, cfg.indirect_stride, phase) for p in primary)
    py_c, px_c = multires.coarse_pixels(cfg, phase)

    def assert_equal(got, want):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)

    trunc = pathtrace.path_trace_pass(td, cam.position, light, 5, split_cfg, rotation=cam.rotation,
                                      emit_throughput=True, primary=primary)
    assert_equal(wavefront.path_trace_wavefront(td, cam.position, light, 5, split_cfg,
                                                cam.rotation, primary=primary,
                                                emit_throughput=True), trunc)
    for c in (split_cfg, tail_cfg):
        want = pathtrace.trace_pixels(td, cam.position, light, 5, px_c, py_c, c,
                                      rotation=cam.rotation, emit_throughput=True, primary=prim_c)
        assert_equal(wavefront.trace_pixels_wavefront(td, cam.position, light, 5, px_c, py_c, c,
                                                      cam.rotation, primary=prim_c,
                                                      emit_throughput=True), want)
        if c is split_cfg:
            assert_equal(want, [multires._subsample(t, cfg.indirect_stride, phase) for t in trunc])
