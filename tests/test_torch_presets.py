"""The SVGF/estimator slice as a whole: the port's presets against the JAX
package's frame, checkpoints across packages, and the kernel route's
wiring under both presets.

The presets run cut to 48x32, 6 bounces and 3 a-trous iterations (they are
1920x1080, 32 bounces and 9 iterations), over 3 frames with the camera and
the light moving every frame.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from real_time_path_tracing_with_spatiotemporal_filtering_tpu import models as jmodels
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Renderer,
    RenderConfig,
    Scene,
    models,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import (
    frame as tframe,
)
from test_torch_estimators import assert_nee_matches

torch.set_num_threads(1)

CUT = dict(width=48, height=32, max_bounces=6, wavelet_iterations=3)
CAM_STEP = np.float32([0.05, 0.0, 0.0])
LIGHT_STEP = np.float32([0.1, 0.0, 0.0])
FRAMES = 3
PRESETS = {
    "quality": (presets.cornell_box_quality, {}),
    "interactive": (presets.cornell_box_interactive, {}),
    "interactive_normal": (presets.cornell_box_interactive, dict(ramp_reset_mode="normal")),
}
PLANES = ("image", "moments", "age", "vis_class")


def _port(name: str, **overrides) -> Renderer:
    factory, extra = PRESETS[name]
    return factory(device="cpu", **CUT, **extra, **overrides)


def _assert_matches(got, want, cfg):
    """The golden tolerance of tests/test_golden.py (measured: every
    element inside it), or NEE's criterion (test_torch_estimators)."""
    if cfg.nee:
        assert_nee_matches(got, want)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _advance(r: Renderer) -> torch.Tensor:
    r.move_camera(*CAM_STEP)
    r.move_light(*LIGHT_STEP)
    return r.step()


@pytest.fixture(scope="module")
def jax_runs(cornell_tri_data):
    """Per preset: the JAX package's jitted XLA frames and histories of the
    moving sequence, and the JAX state before the last frame. The jitted
    frame donates its history, so each kept history is a copy."""
    runs = {}
    for name in PRESETS:
        cfg = _port(name).cfg
        cam, light = jx.Camera.default(), jx.Light.default()
        hist = jframe.init_history(cornell_tri_data, cfg)
        frames, before_last = [], None
        for i in range(FRAMES):
            cam = dataclasses.replace(cam, position=np.asarray(cam.position) + CAM_STEP)
            light = dataclasses.replace(light, position=np.asarray(light.position) + LIGHT_STEP)
            if i == FRAMES - 1:
                before_last = (jax.tree.map(jnp.array, hist), cam, light)
            rgb, hist = jframe.render_frame(cornell_tri_data, cam, light, hist, cfg)
            frames.append((np.asarray(rgb), jax.tree.map(jnp.array, hist)))
        runs[name] = (cfg, frames, before_last)
    return runs


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_matches_jax(jax_runs, name):
    """Frame by frame, the image and every history plane."""
    cfg, frames, _ = jax_runs[name]
    r = _port(name)
    for want_rgb, want_hist in frames:
        _assert_matches(_advance(r).numpy(), want_rgb, cfg)
        for plane in PLANES:
            got, want = getattr(r.history, plane), getattr(want_hist, plane)
            assert (got is None) == (want is None), plane
            if got is not None:
                _assert_matches(got.numpy(), want, cfg)
    assert r.history.age is not None and r.history.moments is not None
    assert (r.history.vis_class is not None) == (cfg.ramp_reset_mode == "normal")


@pytest.mark.parametrize("name", ["quality", "interactive_normal"])
def test_checkpoint_resumes_across_packages(jax_runs, name, tmp_path):
    """A JAX checkpoint resumes in the port and gives JAX's next frame; the
    port's checkpoint of that frame loads in JAX with the same leaves."""
    cfg, frames, (hist, cam, light) = jax_runs[name]
    jr = jx.Renderer(jx.Scene.cornell_box(), cfg)
    jr.history, jr.camera, jr.light = hist, cam, light
    path = os.path.join(tmp_path, "state.npz")
    jr.save_state(path)

    r = _port(name)
    r.load_state(path)
    assert r.frame_count == FRAMES - 1
    np.testing.assert_array_equal(r.history.age.numpy(), np.asarray(hist.age))
    rgb = r.step().numpy()  # camera and light were saved already moved
    _assert_matches(rgb, frames[-1][0], cfg)

    r.save_state(path)
    jr.load_state(path)
    assert int(jr.history.frame) == FRAMES
    for plane in PLANES:
        got = getattr(r.history, plane)
        if got is not None:
            np.testing.assert_array_equal(np.asarray(getattr(jr.history, plane)), got.numpy())


@pytest.mark.parametrize(
    "name, overrides",
    [("quality", {}), ("interactive_normal", {}),
     ("quality", dict(demodulate_albedo=True, firefly_clamp=2.0))],
    ids=["quality", "interactive_normal", "quality_demodulate_albedo_firefly_clamp"],
)
def test_kernel_route_wiring_matches_plain_route(name, overrides):
    """The kernel route on CPU tensors (each wrapper runs its plain
    version) gives the plain route's frames and history planes; the third
    case takes the geometry kernel's albedo planes, the clamp and the
    re-modulation."""
    r = _port(name, **overrides)
    hist = r.history
    for _ in range(FRAMES):
        r.move_camera(*CAM_STEP)
        r.move_light(*LIGHT_STEP)
        want, hist_next = tframe.render_frame_impl(r.tri_data, r.camera, r.light, hist, r.cfg)
        got, got_hist = tframe._render_frame_kernels(r.tri_data, r.camera, r.light, hist, r.cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for plane in PLANES:
            a, b = getattr(got_hist, plane), getattr(hist_next, plane)
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        hist = hist_next


def test_models_export_the_jax_factories():
    assert models.__all__ == jmodels.__all__
    for name in models.__all__:
        assert callable(getattr(models, name))


def test_preset_configs_match_jax():
    """Each factory's config equals the JAX factory's (device aside)."""
    for name in ("cornell_box_reference", "cornell_box_realtime", "cornell_box_quality",
                 "cornell_box_interactive"):
        port_cfg = getattr(presets, name)(device="cpu", width=16, height=16).cfg
        jax_cfg = getattr(jmodels.presets, name)(width=16, height=16).cfg
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg), name


def test_cornell_stress_and_custom_obj_render(tmp_path):
    """cornell_stress subdivides every quad (identical geometry, as in the
    JAX package); custom_obj parses an OBJ of the Cornell box into the same
    scene as Scene.cornell_box."""
    from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene import (
        procedural as jprocedural,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    tiny = dict(width=16, height=16, max_bounces=2, wavelet_iterations=1)
    stress = presets.cornell_stress(splits=2, device="cpu", **tiny)
    assert stress.tri_data.num_triangles == 128
    for got, want in zip(procedural.subdivided_cornell(3), jprocedural.subdivided_cornell(3)):
        np.testing.assert_array_equal(got, want)
    assert torch.isfinite(stress.step()).all()

    verts, idx = procedural.cornell_box()
    path = os.path.join(tmp_path, "cornell.obj")
    with open(path, "w") as f:
        f.writelines(f"v {x!r} {y!r} {z!r}\n" for x, y, z in verts.tolist())
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in idx.tolist())
    got = presets.custom_obj(path, device="cpu", **tiny).step()
    want = Renderer(Scene.cornell_box(), RenderConfig(**tiny), device="cpu").step()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
