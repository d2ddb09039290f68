"""The path-gradient and multi-res slice as a whole: 3-frame sequences with
cfg.path_gradient against the jitted JAX frame (with checkpoints across
packages), and the kernel route's wiring under both features on CPU
tensors.

Golden scale (48x32, 6 bounces, 3 a-trous iterations), the JAX suite's row
2e levers (variance-guided SVGF, the ramp, the path gradient), the camera
and the light moving every frame, on the Cornell box and on
subdivided_cornell(2), whose 128 triangles take the LBVH route.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Renderer,
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import intersect
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from test_torch_multires import CUT, RECOMMENDED, SCENES, run_sequences, scene_arrays

torch.set_num_threads(1)

# benchmarks/suite.py row 2e of the JAX package
PATHGRAD = dict(variance_guided=True, accumulation_ramp=True, path_gradient=True)
GRADIENT_PLANES = ("image", "moments", "age", "noisy_lum", "cam_pos", "cam_rot")


@pytest.mark.parametrize("name", list(SCENES))
def test_path_gradient_frames_match_jax(name, tmp_path):
    """Image and history planes frame by frame at the golden tolerance; the
    gradient state resumes across packages: the JAX history after the
    sequence loads in the port, and the port's checkpoint loads in JAX with
    the same leaves."""
    cfg = RenderConfig(**CUT, **PATHGRAD)
    for got, got_hist, want, want_hist in run_sequences(name, cfg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        for plane in GRADIENT_PLANES:
            np.testing.assert_allclose(getattr(got_hist, plane).numpy(),
                                       np.asarray(getattr(want_hist, plane)),
                                       rtol=1e-5, atol=1e-6)
    assert got_hist.vis_class is None

    scene, jscene = scene_arrays(name)
    jr = jx.Renderer(jscene, cfg)
    jr.history = want_hist
    path = os.path.join(tmp_path, "state.npz")
    jr.save_state(path)
    r = Renderer(scene, cfg, device="cpu")
    r.load_state(path)
    for plane in GRADIENT_PLANES:
        np.testing.assert_array_equal(getattr(r.history, plane).numpy(),
                                      np.asarray(getattr(want_hist, plane)))
    r.save_state(path)
    jr.history = jax.tree.map(jnp.zeros_like, jr.history)
    jr.load_state(path)
    for plane in GRADIENT_PLANES:
        np.testing.assert_array_equal(np.asarray(getattr(jr.history, plane)),
                                      getattr(r.history, plane).numpy())


@pytest.mark.parametrize("flags", [PATHGRAD, RECOMMENDED], ids=["path_gradient", "multires"])
def test_kernel_route_wiring_matches_plain_route(flags):
    """The kernel route on CPU tensors (the LBVH geometry pass, the segment
    tracer's explicit-pixel re-trace and coarse tail, each wrapper running
    its plain version) gives the plain route's frames and histories
    exactly, and launches nothing."""
    cfg = RenderConfig(**CUT, **flags)
    scene, _ = scene_arrays("subdivided_cornell_2")
    r = Renderer(scene, cfg, device="cpu")
    assert intersect.uses_bvh(r.tri_data)
    hist = r.history
    _build.LAUNCHES.clear()
    for _ in range(2):
        r.move_camera(0.05)
        r.move_light(0.1)
        want, hist_next = tframe.render_frame_impl(r.tri_data, r.camera, r.light, hist,
                                                   dataclasses.replace(cfg, backend="xla"))
        got, got_hist = tframe._render_frame_kernels(r.tri_data, r.camera, r.light, hist, cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for f in dataclasses.fields(hist_next):
            a, b = getattr(got_hist, f.name), getattr(hist_next, f.name)
            assert (a is None) == (b is None), f.name
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        hist = hist_next
    assert sum(_build.LAUNCHES.values()) == 0
