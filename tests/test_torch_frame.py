"""The port's whole frame against the JAX package: golden snapshot, a moving
camera+light sequence, checkpoint resume across packages and the kernel
route's wiring."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    Renderer,
    RenderConfig,
    Scene,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import camera as cam_ops
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.history import (
    history_from_numpy,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "perfbench")
CFG = RenderConfig(width=48, height=32, max_bounces=6, wavelet_iterations=3, backend="xla")
CAM_STEP = np.float32([0.05, 0.0, 0.0])
LIGHT_STEP = np.float32([0.1, 0.0, 0.0])
FRAMES = 3


def _renderer(cfg=CFG) -> Renderer:
    return Renderer(Scene.cornell_box(), cfg, device="cpu")


def _assert_matches(got, want):
    """The golden tolerance of tests/test_golden.py: measured, every
    element of these 48x32 frames stays inside it."""
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _advance_port(r: Renderer) -> torch.Tensor:
    r.move_camera(*CAM_STEP)
    r.move_light(*LIGHT_STEP)
    return r.step()


@pytest.fixture(scope="module")
def jax_sequence(cornell_tri_data):
    """JAX XLA frames with the camera and light moving every frame (the
    jitted frame, which donates its history: the state kept is a copy);
    also the JAX state before the last frame."""
    cam, light = jx.Camera.default(), jx.Light.default()
    hist = jframe.init_history(cornell_tri_data, CFG)
    frames, before_last = [], None
    for i in range(FRAMES):
        cam = dataclasses.replace(cam, position=np.asarray(cam.position) + CAM_STEP)
        light = dataclasses.replace(light, position=np.asarray(light.position) + LIGHT_STEP)
        if i == FRAMES - 1:
            before_last = (jax.tree_util.tree_map(jnp.copy, hist), cam, light)
        rgb, hist = jframe.render_frame(cornell_tri_data, cam, light, hist, CFG)
        frames.append(np.asarray(rgb))
    return frames, before_last


def test_frame_matches_golden():
    """tests/test_golden.py's 3-frame snapshot at its tolerance (measured:
    every element inside it)."""
    r = _renderer()
    rgb = r.render(3)
    golden = np.load(os.path.join(GOLDEN, "frame3_48x32.npy"))
    np.testing.assert_allclose(rgb.numpy(), golden, rtol=1e-5, atol=1e-6)
    assert r.frame_count == 3


def test_moving_sequence_matches_jax(jax_sequence):
    frames, _ = jax_sequence
    r = _renderer()
    for want in frames:
        _assert_matches(_advance_port(r).numpy(), want)


def test_jax_checkpoint_resumes_in_port(jax_sequence, tmp_path):
    frames, (hist, cam, light) = jax_sequence
    jr = jx.Renderer(jx.Scene.cornell_box(), CFG)
    jr.history, jr.camera, jr.light = hist, cam, light
    path = os.path.join(tmp_path, "state.npz")
    jr.save_state(path)

    r = _renderer()
    r.load_state(path)
    assert r.frame_count == FRAMES - 1
    np.testing.assert_array_equal(r.history.image.numpy(), np.asarray(hist.image))
    rgb = r.step().numpy()  # camera and light were saved already moved
    _assert_matches(rgb, frames[-1])

    # and back: the port's checkpoint has the JAX layout
    r.save_state(path)
    jr.load_state(path)
    assert int(jr.history.frame) == FRAMES
    np.testing.assert_array_equal(np.asarray(jr.history.image), rgb)


def test_checkpoint_rejects_other_resolution(tmp_path):
    path = os.path.join(tmp_path, "state.npz")
    _renderer().save_state(path)
    other = _renderer(dataclasses.replace(CFG, width=40))
    with pytest.raises(ValueError, match="shape"):
        other.load_state(path)


def test_kernel_route_wiring_matches_plain_route():
    """The kernel route on CPU tensors (each wrapper runs its plain version)
    gives the plain route's frames: prev_y/prev_x from the geometry pass
    feed the blend the way backproject_pixels does."""
    r = _renderer(dataclasses.replace(CFG, adaptive_alpha=True))
    hist = r.history
    for _ in range(FRAMES):
        _advance_port(r)
        want, hist_next = tframe.render_frame_impl(r.tri_data, r.camera, r.light, hist, r.cfg)
        got, _ = tframe._render_frame_kernels(r.tri_data, r.camera, r.light, hist, r.cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        hist = hist_next


def test_adaptive_alpha_and_walls_match_jax(cornell_tri_data):
    cfg = dataclasses.replace(CFG, adaptive_alpha=True, light_through_walls=False)
    cam, light = jx.Camera.default(), jx.Light.default()
    hist = jframe.init_history(cornell_tri_data, cfg)
    r = _renderer(cfg)
    for _ in range(2):
        light = dataclasses.replace(light, position=np.asarray(light.position) + LIGHT_STEP)
        want, hist = jframe.render_frame(cornell_tri_data, cam, light, hist, cfg)
        r.move_light(*LIGHT_STEP)
        _assert_matches(r.step().numpy(), want)


def test_move_light_wraps_x():
    r = _renderer()
    r.move_light(dx=1.5)  # x: 1 -> 2.5 > 2 wraps to -20
    assert r.light.position[0].item() == CFG.light_x_wrap_lo
    r.move_light(dx=-0.5)  # -20.5 < -20 wraps to 2
    assert r.light.position[0].item() == CFG.light_x_wrap_hi
    np.testing.assert_allclose(r.light.position[1:].numpy(), [1.0, -0.4])


def test_history_from_numpy_carries_jax_history(cornell_tri_data):
    hist = jframe.init_history(cornell_tri_data, CFG)
    fields = ("image", "visibility", "lut", "view", "proj", "light_pos", "light_color", "frame")
    port = history_from_numpy({f: np.asarray(getattr(hist, f)) for f in fields})
    assert port.frame == 0
    np.testing.assert_array_equal(port.proj.numpy(), np.asarray(hist.proj))
    np.testing.assert_array_equal(port.lut.numpy(), np.asarray(hist.lut))


def _cell_config(traffic: str) -> RenderConfig:
    """A benchmark cell's render settings: the cornell_box configuration's
    display size and the traffic's render mode (perfbench/)."""
    with open(os.path.join(BENCH, "configs", "cornell_box.json")) as f:
        display = json.load(f)["display"]
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        render = json.load(f)["render"]
    return RenderConfig(width=display["width"], height=display["height"], **render)


MATRIX_CONFIGS = {
    "quality_orbit": lambda: _cell_config("quality_orbit"),
    "interactive_orbit_dense": lambda: _cell_config("interactive_orbit_dense"),
    "fov035_160x128": lambda: RenderConfig(width=160, height=128, fov=0.35),
}


def _matrices_from_scratch(camera, cfg):
    """camera_matrices built as every frame once built them: a fresh
    projection from the host, flipped in place, and the view's last row
    made by torch.tensor."""
    proj = cam_ops.perspective(cfg.fov * 2.0, cfg.width / cfg.height, cfg.near, cfg.far)
    proj[1, 1] = -proj[1, 1]
    rt = camera.rotation.T
    top = torch.cat([rt, -cam_ops.mat_apply(rt, camera.position, w=False)[:, None]], dim=1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]])]), proj


@pytest.mark.parametrize("name", list(MATRIX_CONFIGS))
def test_cached_matrices_equal_a_fresh_build(name):
    """The shared projection and the view on the shared last row are bit
    for bit the matrices built from scratch, and a second call hands back
    the same projection object."""
    cfg = MATRIX_CONFIGS[name]()
    camera = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.3, 1.0)
    view, proj = tframe.camera_matrices(camera, cfg)
    want_view, want_proj = _matrices_from_scratch(camera, cfg)
    assert torch.equal(view, want_view)
    assert torch.equal(proj, want_proj)
    again_view, again_proj = tframe.camera_matrices(camera, cfg)
    assert again_proj is proj
    assert torch.equal(again_view, view)


def test_frames_leave_the_cached_projection_unchanged():
    """Two frames of render_frame_impl write nothing into the shared
    projection, which every later frame and the history read."""
    cfg = dataclasses.replace(CFG, variance_guided=True, accumulation_ramp=True,
                              adaptive_alpha=True)
    r = _renderer(cfg)
    proj = tframe.camera_matrices(r.camera, cfg)[1]
    before = proj.clone()
    assert r.history.proj is proj
    for _ in range(2):
        _advance_port(r)
    assert r.history.proj is proj
    assert torch.equal(proj, before)
