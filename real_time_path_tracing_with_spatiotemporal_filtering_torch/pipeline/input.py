"""Input controller: the reference's key bindings as a pure map.

updateScene (main.cpp:1119-1168) polls GLFW keys each frame and mutates the
camera/light. Here the same bindings transform (Camera, Light) from a set of
pressed key names, so interactive frontends (or scripted motion) share one
tested semantic:

    WASD        camera x/z        (W forward = -z, main.cpp:1131-1146)
    Q / E       camera down / up  (main.cpp:1147-1154 -- E up, Q down)
    I / K       light -z / +z
    J / L       light -x / +x, wrapping at [-20, 2] (main.cpp:1149-1160)
    U / O       light down / up
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
)


def _offset(like: torch.Tensor, dx: float, dy: float, dz: float) -> torch.Tensor:
    """float32 [dx, dy, dz] on ``like``'s device, filled in place: building
    it from a host list would copy it to the card and wait for the copy."""
    off = torch.zeros(3, dtype=torch.float32, device=like.device)
    for i, d in enumerate((dx, dy, dz)):
        if d:
            off[i].fill_(d)
    return off


def apply_keys(
    camera: Camera,
    light: Light,
    keys: Iterable[str],
    cfg: RenderConfig = RenderConfig(),
) -> tuple[Camera, Light, bool]:
    """One frame of input. Returns (camera', light', camera_moved).

    The positions stay on their device and nothing is read back from it, so
    a frame loop never waits on the card here. The results equal the JAX
    package's bit for bit: both add a float32 [dx, dy, dz] to a float32
    position, and the light's x wraps only in the direction of travel.
    """
    keys = {k.lower() for k in keys}
    speed = cfg.move_speed

    cdx = speed * (("d" in keys) - ("a" in keys))
    cdy = speed * (("e" in keys) - ("q" in keys))
    cdz = speed * (("s" in keys) - ("w" in keys))
    camera_moved = bool(cdx or cdy or cdz)
    if camera_moved:
        pos = camera.position + _offset(camera.position, cdx, cdy, cdz)
        camera = dataclasses.replace(camera, position=pos)

    ldx = speed * (("l" in keys) - ("j" in keys))
    ldy = speed * (("o" in keys) - ("u" in keys))
    ldz = speed * (("k" in keys) - ("i" in keys))
    if ldx or ldy or ldz:
        pos = light.position + _offset(light.position, ldx, ldy, ldz)
        # wrap exactly like main.cpp:1151-1160: crossing +2 going right
        # teleports to -20; crossing -20 going left teleports to +2
        x = pos[:1]
        if ldx > 0:
            x = torch.where(x > cfg.light_x_wrap_hi, cfg.light_x_wrap_lo, x)
        elif ldx < 0:
            x = torch.where(x < cfg.light_x_wrap_lo, cfg.light_x_wrap_hi, x)
        light = dataclasses.replace(light, position=torch.cat([x, pos[1:]]))
    return camera, light, camera_moved
