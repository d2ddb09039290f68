"""Multi-res indirect (ops/multires.py) against the JAX package.

The grid phase is bit-equal over 64 frames; combine_planes equals the JAX
package's on seeded planes at every phase, including the east planes'
column padding that the port keeps for parity; 3-frame sequences under
the flags of the JAX suite's recommended-quality row (4c'') match the
jitted JAX frame on the Cornell box and on an LBVH scene. Golden scale:
48x32 (divisible by the stride 4), 6 bounces, 3 a-trous iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    multires as jmultires,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Renderer,
    RenderConfig,
    Scene,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import multires
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

torch.set_num_threads(1)

CUT = dict(width=48, height=32, max_bounces=6, wavelet_iterations=3)
# benchmarks/suite.py row 4c'' of the JAX package (its levers on row 4c's)
RECOMMENDED = dict(rr_start_bounce=2, adaptive_alpha=True, indirect_split=1, indirect_stride=4,
                   gbuffer_primary=True, indirect_jitter=True, variance_guided=True,
                   accumulation_ramp=True, ramp_reset_mode="normal")
SCENES = {"cornell": None, "subdivided_cornell_2": 2}
CAM_STEP = np.float32([0.05, 0.0, 0.0])
LIGHT_STEP = np.float32([0.1, 0.0, 0.0])
FRAMES = 3


def scene_arrays(name):
    """(port Scene, JAX Scene) of a SCENES entry."""
    splits = SCENES[name]
    if splits is None:
        return Scene.cornell_box(), jx.Scene.cornell_box()
    arrays = procedural.subdivided_cornell(splits)
    return Scene.from_arrays(*arrays), jx.Scene.from_arrays(*arrays)


def run_sequences(name, cfg, frames=FRAMES):
    """The port's plain route and the jitted JAX frame over ``frames``
    frames with the camera and the light moving every frame; yields (port
    image, port history, JAX image, JAX history) per frame. The JAX frame
    donates its history, so the JAX history yielded is a copy."""
    scene, jscene = scene_arrays(name)
    r = Renderer(scene, dataclasses.replace(cfg, backend="xla"), device="cpu")
    jtd = jx.precompute_triangle_data(jscene)
    cam, light = jx.Camera.default(), jx.Light.default()
    hist = jframe.init_history(jtd, cfg)
    for _ in range(frames):
        cam = dataclasses.replace(cam, position=np.asarray(cam.position) + CAM_STEP)
        light = dataclasses.replace(light, position=np.asarray(light.position) + LIGHT_STEP)
        want, hist = jframe.render_frame(jtd, cam, light, hist, cfg)
        r.move_camera(*CAM_STEP)
        r.move_light(*LIGHT_STEP)
        got = r.step()
        yield got, r.history, np.asarray(want), jax.tree.map(jnp.array, hist)


def test_grid_phase_matches_jax():
    jit_phase = jax.jit(jmultires.grid_phase, static_argnums=1)
    for stride in (2, 3, 4):
        for f in range(64):
            want = tuple(int(v) for v in jit_phase(jnp.int32(f), stride))
            assert multires.grid_phase(f, stride) == want


def test_combine_planes_matches_jax():
    """Seeded planes at 48x32, stride 4, without a phase and at phases with
    ox = 0 and ox > 0; and, pinned, the phased expansion's column -1: the
    east planes repeat their own first column (the JAX package's
    ops/multires.py:127), the base plane its own."""
    cfg = RenderConfig(**CUT, indirect_split=1, indirect_stride=4, indirect_jitter=True)
    h, w, s = cfg.height, cfg.width, cfg.indirect_stride
    rng = np.random.default_rng(44)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[rng.random((h, w)) < 0.5] = normal[0, 0]  # runs of equal normals
    depth = rng.uniform(0.9, 1.0, (h, w)).astype(np.float32)
    trunc = [rng.exponential(0.5, (h, w)).astype(np.float32) for _ in range(3)]
    thru = [rng.uniform(0.0, 0.8, (h, w)).astype(np.float32) for _ in range(3)]
    thru[0][rng.random((h, w)) < 0.2] = 0.0  # dead paths: the demodulation guard
    full_c = [rng.exponential(0.7, (h // s, w // s)).astype(np.float32) for _ in range(3)]
    guide = [normal[..., 0], normal[..., 1], normal[..., 2], depth]

    def port(phase):
        t = [torch.tensor(a) for a in (*trunc, *thru, *full_c, *guide)]
        return multires.combine_planes(t[0:3], t[3:6], t[6:9], t[9:13], cfg, phase=phase)

    jit_combine = jax.jit(lambda a, phase: jmultires.combine_planes(
        a[0:3], a[3:6], a[6:9], a[9:13], cfg, phase=phase))
    arrays = [jnp.asarray(a) for a in (*trunc, *thru, *full_c, *guide)]
    for phase in (None, (0, 0), (2, 0), (1, 3), (3, 2)):
        got = port(phase)
        jphase = None if phase is None else tuple(jnp.int32(v) for v in phase)
        want = jit_combine(arrays, jphase)
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-6)

    c = torch.tensor(full_c[0])
    oy, ox = 1, 3
    base = multires._expand(c, s, h, w, (oy, ox))
    east = multires._expand(multires._shift_next(c, 1), s, h, w, (oy, ox))
    rows = torch.clamp_min(torch.div(torch.arange(h) - oy, s, rounding_mode="floor"), 0)
    assert torch.equal(base[:, :ox], c[rows, :1].expand(h, ox))
    assert torch.equal(east[:, :ox], c[rows, 1:2].expand(h, ox))


@pytest.mark.parametrize("name", list(SCENES))
def test_frames_match_jax(name):
    """Row 4c'''s flags over 3 moving frames: image and history planes at
    the golden tolerance, against the jitted JAX XLA frame."""
    cfg = RenderConfig(**CUT, **RECOMMENDED)
    for got, got_hist, want, want_hist in run_sequences(name, cfg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        for plane in ("image", "moments", "age", "vis_class"):
            np.testing.assert_allclose(getattr(got_hist, plane).numpy(),
                                       np.asarray(getattr(want_hist, plane)),
                                       rtol=1e-5, atol=1e-6)
    assert got_hist.noisy_lum is None and got_hist.cam_pos is None
