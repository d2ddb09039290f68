"""Stateful convenience wrapper around the frame function.

Plays the role of the reference's PathTracingApplication main loop
(main.cpp:179-308) minus the window: owns the scene tables, the history
and the frame counter on one device, and exposes step()/checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame as frame_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.history import (
    history_fields,
    history_from_numpy,
    history_leaves,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
    Scene,
    TriangleData,
    precompute_triangle_data,
    tensors_to,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import (
    resolve as resolve_device,
)


class Renderer:
    """Owns scene tables + history on ``device``; one step() per frame.

    ``device`` defaults to the CUDA device, and a machine without one
    raises: the CPU runs the plain versions only when asked (``"cpu"``).
    ``tri_data``: the scene's tables on ``device``, when the caller has
    them already (the benchmark suite builds each scene's LBVH once).
    Checkpoints use the JAX package's .npz layout, so a state saved by
    either package resumes in the other.
    """

    def __init__(
        self,
        scene: Scene,
        cfg: RenderConfig = RenderConfig(),
        camera: Optional[Camera] = None,
        light: Optional[Light] = None,
        device=None,
        tri_data: Optional[TriangleData] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scene = scene
        self.tri_data = (precompute_triangle_data(scene, self.device) if tri_data is None
                         else tri_data)
        self.camera = tensors_to(
            Camera.default() if camera is None else camera, self.device
        )
        self.light = tensors_to(Light.default() if light is None else light, self.device)
        self.model = None
        self.history = frame_mod.init_history(self.tri_data, cfg, self.device)

    def step(self) -> torch.Tensor:
        """Render one frame with the current camera/light; returns (H, W, 3)."""
        rgb, self.history = frame_mod.render_frame_impl(
            self.tri_data, self.camera, self.light, self.history, self.cfg,
            self.model,
        )
        return rgb

    def render(self, num_frames: int) -> torch.Tensor:
        """Render ``num_frames`` and return the last frame."""
        if num_frames < 1:
            raise ValueError("num_frames must be >= 1")
        for _ in range(num_frames):
            rgb = self.step()
        return rgb

    @property
    def frame_count(self) -> int:
        return self.history.frame

    def reset(self) -> None:
        """Restart temporal history (frame 0 then skips blending again)."""
        self.history = frame_mod.init_history(self.tri_data, self.cfg, self.device)

    # --- checkpoint / resume -------------------------------------------
    _STATE_VERSION = 1

    def _leaves(self) -> list[np.ndarray]:
        """History, camera and light leaves in the JAX package's order."""
        extra = (self.camera.position, self.camera.rotation,
                 self.light.position, self.light.color)
        return history_leaves(self.history) + [t.cpu().numpy() for t in extra]

    def save_state(self, path: str) -> None:
        """Serialize history + camera/light to an .npz (exact resume)."""
        leaves = self._leaves()
        np.savez(
            path, *leaves, _num_leaves=len(leaves), _version=self._STATE_VERSION
        )

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            version = int(data["_version"]) if "_version" in data else 0
            if version != self._STATE_VERSION:
                raise ValueError(
                    f"checkpoint version {version} != {self._STATE_VERSION}; "
                    "re-render or migrate the state file"
                )
            leaves = [data[f"arr_{i}"] for i in range(int(data["_num_leaves"]))]
        current = self._leaves()
        if len(leaves) != len(current):
            raise ValueError(
                "checkpoint does not match this renderer's state structure "
                f"({len(leaves)} leaves vs {len(current)}); was it saved with "
                "a different config?"
            )
        for i, (got, cur) in enumerate(zip(leaves, current)):
            if got.shape != cur.shape or got.dtype != cur.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} has shape {got.shape} dtype "
                    f"{got.dtype}, renderer expects {cur.shape} {cur.dtype}; "
                    "was it saved with a different scene/resolution?"
                )
        names = history_fields(self.cfg)
        self.history = history_from_numpy(dict(zip(names, leaves)), self.device, self.cfg)
        cam_pos, cam_rot, light_pos, light_color = (
            torch.tensor(a, device=self.device) for a in leaves[len(names):]
        )
        self.camera = Camera(position=cam_pos, rotation=cam_rot)
        self.light = Light(position=light_pos, color=light_color)

    # --- interaction ----------------------------------------------------
    def _offset(self, dx: float, dy: float, dz: float) -> torch.Tensor:
        return torch.tensor([dx, dy, dz], dtype=torch.float32, device=self.device)

    def move_camera(self, dx: float = 0.0, dy: float = 0.0, dz: float = 0.0):
        pos = self.camera.position + self._offset(dx, dy, dz)
        self.camera = dataclasses.replace(self.camera, position=pos)

    def move_light(self, dx: float = 0.0, dy: float = 0.0, dz: float = 0.0):
        """Light translation with the reference's x wraparound
        (main.cpp:1149-1160: x > 2 wraps to -20 and vice versa), computed
        on the device so that no frame waits for a host read."""
        pos = self.light.position + self._offset(dx, dy, dz)
        x = pos[:1]
        lo, hi = self.cfg.light_x_wrap_lo, self.cfg.light_x_wrap_hi
        x = torch.where(
            x > hi, torch.full_like(x, lo), torch.where(x < lo, torch.full_like(x, hi), x)
        )
        self.light = dataclasses.replace(self.light, position=torch.cat([x, pos[1:]]))
