"""Cross-frame history state.

The reference persists exactly this set between frames by blitting/copying
at end-of-frame (main.cpp:1361-1372, SURVEY.md section 3.5): previous output
image, previous visibility buffer, previous visibility LUT, previous
view/proj matrices, previous light position and color, and the frame
counter. Here it is one frozen dataclass returned by the frame function.
The field order is the JAX package's, which fixes the leaf order of the
checkpoint files both packages read and write.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class History:
    """Everything frame N+1 reads from frame N."""

    image: torch.Tensor            # (H, W, 3) previous final (blended) output
    visibility: torch.Tensor       # (H, W) previous primID+1 image
    lut: torch.Tensor              # (T+1, 3, 3) previous visibility LUT
    view: torch.Tensor             # (4, 4) previous view matrix
    proj: torch.Tensor             # (4, 4) previous projection matrix
    light_pos: torch.Tensor        # (3,) previous light position
    light_color: torch.Tensor      # (3,) previous light base color
    frame: int                     # frame counter, kept on the host
    # Extension state, None unless its flag is on (see config.py):
    # (H, W, 2) accumulated luminance moments (mu1, mu2), cfg.variance_guided
    moments: torch.Tensor | None = None
    # (H, W) consecutive-history length N, cfg.accumulation_ramp
    age: torch.Tensor | None = None
    # (H, W) quantized-normal consistency key (ops.atrous.normal_class),
    # cfg.accumulation_ramp with ramp_reset_mode == "normal"
    vis_class: torch.Tensor | None = None
    # cfg.path_gradient: the previous frame's raw (pre-demodulation,
    # pre-clamp) noisy trace luminance (H, W) and the camera it was traced
    # with, position (3,) and camera->world rotation (3, 3), so that the
    # gradient pass can re-trace the same samples (ops/pathgrad.py)
    noisy_lum: torch.Tensor | None = None
    cam_pos: torch.Tensor | None = None
    cam_rot: torch.Tensor | None = None

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]


def history_fields(cfg=None) -> list[str]:
    """The names of the fields a frame under ``cfg`` fills (None: the
    default config's), in field order."""
    names = [f.name for f in dataclasses.fields(History) if f.default is dataclasses.MISSING]
    if cfg is not None:
        if cfg.variance_guided:
            names.append("moments")
        if cfg.accumulation_ramp:
            names.append("age")
            if cfg.ramp_reset_mode == "normal":
                names.append("vis_class")
        if cfg.path_gradient:
            names += ["noisy_lum", "cam_pos", "cam_rot"]
    return names


def history_leaves(history: History) -> list[np.ndarray]:
    """The history's fields as numpy arrays, in field order (the JAX
    package's pytree leaf order), skipping the fields that are None as
    ``jax.tree_util.tree_leaves`` does; ``frame`` as a 0-d int32."""
    leaves = []
    for f in dataclasses.fields(History):
        v = getattr(history, f.name)
        if f.name == "frame":
            leaves.append(np.asarray(v, np.int32))
        elif v is not None:
            leaves.append(v.detach().cpu().numpy())
    return leaves


def history_from_numpy(arrays: dict, device=None, cfg=None) -> History:
    """History from numpy arrays keyed by field name -- the leaves of the
    JAX package's History, so its state can be resumed in this package.
    ``cfg`` says which extension fields are present (None: none)."""
    values = {}
    for name in history_fields(cfg):
        v = np.asarray(arrays[name])
        if name == "frame":
            values[name] = int(v)
        else:
            values[name] = torch.tensor(v, device=device)
    return History(**values)
