"""What the check must fail: the control and the planted faults.

The control is the reference put in the program's place and computed one
precision below the configuration's: the configuration states float32 with
TF32 off (the program pins its one matrix product, the camera's clip
transform, to full float32), so the control rounds that product's
operands to TF32 (10-bit mantissa, round to nearest even), as a TF32
tensor-core product would. The faults are the measured program with its
timed path broken underneath. Neither runs in the benchmark's own runs:
``calibrate.py`` reads them on the card, the tests on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench import harness
from perfbench.reference import camera as ref_camera, config as ref_config
from perfbench.reference import frame as ref_frame, scene as ref_scene


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def tf32_matmuls():
    """The reference's matrix products with TF32 operands while the block runs."""
    full = ref_camera.matmul_highest
    ref_camera.matmul_highest = lambda a, b: full(tf32_round(a), tf32_round(b))
    try:
        yield
    finally:
        ref_camera.matmul_highest = full


class ReferenceProgram:
    """The reference in the program's place, in TF32 (the control)."""

    def __init__(self, vertices, indices, settings: dict, device: torch.device):
        self.cfg = ref_config.RenderConfig(**settings)
        self.tables = ref_scene.precompute_triangle_data(
            ref_scene.Scene.from_arrays(vertices, indices), device)
        self.history = ref_frame.init_history(self.tables, self.cfg, device)
        self.camera = self.light = None

    def set_inputs(self, m, i: int) -> None:
        self.camera = ref_scene.Camera(position=m.cam_pos[i], rotation=m.cam_rot[i])
        self.light = ref_scene.Light(position=m.light_pos[i], color=m.light_color)

    def step(self) -> torch.Tensor:
        with tf32_matmuls():
            rgb, self.history = ref_frame.render_frame(self.tables, self.camera, self.light,
                                                       self.history, self.cfg)
        return rgb


class StaleState(harness.PortProgram):
    """Fault: a step that renders but returns its state unchanged."""

    def step(self) -> torch.Tensor:
        r = self.renderer
        kept = r.history
        rgb = r.step()
        r.history = kept
        return rgb


class AlteredPixel(harness.PortProgram):
    """Fault: one value of every frame altered where it is produced."""

    def step(self) -> torch.Tensor:
        rgb = self.renderer.step()
        h, w, _ = rgb.shape
        rgb[h // 2, w // 3, 1] += 0.25
        return rgb


class HalfSamples(harness.PortProgram):
    """Fault: half of each pixel's samples left out, the mean taken over
    the rest (cells of more than one sample a pixel)."""

    def __init__(self, vertices, indices, settings: dict, device):
        super().__init__(vertices, indices, {**settings, "spp": settings["spp"] // 2}, device)


FAULTS = {"stale_state": StaleState, "altered_pixel": AlteredPixel, "half_samples": HalfSamples}


def faults_of(settings: dict) -> list[str]:
    """The faults a cell of these render settings can have."""
    return [f for f in FAULTS if f != "half_samples" or settings.get("spp", 1) > 1]
