"""The traffic generator: a cell's frame inputs from its traffic file and
the seed.

A traffic file holds the render mode (``render``: RenderConfig overrides)
and a motion script, read here into one camera and one light per frame:

    "camera": {"kind": "sweep", "center": [x, y, z], "radius": r,
               "height": h, "step": rad_per_frame, "arc": [lo, hi]}
        Camera.orbit(center, radius, azimuth, height), the azimuth moving
        ``step`` a frame across the arc and back (a triangle wave), from a
        phase drawn from the seed: every seed renders the same views in
        another order, so that the seed does not change the work.
    "light": {"low": [x, y, z], "high": [x, y, z], "color": [r, g, b]}
        a fixed position drawn from the seed in [low, high].

The same seed gives the same frames. The tables are made once, on the
host in float32 and copied to the device in one call a table, and both the
program and the reference read the same rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SEED_STREAM = 0x5EED  # the motion's stream of the seed; the check's is another


@dataclasses.dataclass(frozen=True)
class Motion:
    """Per-frame inputs: camera position (N, 3), camera->world rotation
    (N, 3, 3), light position (N, 3) and the light's colour (3,)."""

    cam_pos: torch.Tensor
    cam_rot: torch.Tensor
    light_pos: torch.Tensor
    light_color: torch.Tensor

    def __len__(self) -> int:
        return self.cam_pos.shape[0]


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of ``seed`` (any whole number >= 0) and ``stream``."""
    return np.random.default_rng([stream, int(seed)])


def _looking_at(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera->world rotations (N, 3, 3) of cameras at ``pos`` (N, 3)
    looking at ``target`` (3,), up +y: columns right, up, back."""
    f = target[None, :] - pos
    f = f / np.linalg.norm(f, axis=1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), f.shape)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r, axis=1, keepdims=True)
    u = np.cross(r, f)
    return np.stack([r, u, -f], axis=2).astype(np.float32)


def camera_tables(spec: dict, frames: int, gen: np.random.Generator):
    kind = spec["kind"]
    if kind == "sweep":
        lo, hi = spec["arc"]
        period = 2.0 * (hi - lo)
        phase = gen.uniform(0.0, period) + spec["step"] * np.arange(frames, dtype=np.float64)
        az = lo + (hi - lo) - np.abs(np.mod(phase, period) - (hi - lo))
        c = np.asarray(spec["center"], np.float32)
        off = np.stack([spec["radius"] * np.sin(az), np.full(frames, spec["height"]),
                        spec["radius"] * np.cos(az)], axis=1).astype(np.float32)
        pos = c[None, :] + off
        return pos, _looking_at(pos, c)
    raise ValueError(f"unknown camera kind {kind!r}")


def light_tables(spec: dict, frames: int, gen: np.random.Generator) -> np.ndarray:
    low, high = np.asarray(spec["low"], np.float64), np.asarray(spec["high"], np.float64)
    return np.tile(gen.uniform(low, high).astype(np.float32), (frames, 1))


def make_motion(traffic: dict, seed: int, frames: int, device) -> Motion:
    """``frames`` frames of the traffic's motion under ``seed`` on ``device``."""
    gen = rng(seed, SEED_STREAM)
    cam_pos, cam_rot = camera_tables(traffic["camera"], frames, gen)
    light = traffic["light"]
    light_pos = light_tables(light, frames, gen)
    color = np.asarray(light.get("color", [0.5, 0.5, 0.5]), np.float32)
    return Motion(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (cam_pos, cam_rot, light_pos, color)))
