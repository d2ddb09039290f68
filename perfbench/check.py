"""The check that decides ``correct``: the plain reference against what the
timed path produced, at the timed size.

The reference (``reference/``) builds its own triangle tables, tree and
camera matrices from the same scene arrays and motion rows the program was
given, and compares:

- the first ``len(start_frames)`` frames, rendered from scratch, and the
  history the last of them leaves;
- each sampled window frame, rendered from the program's own history of
  the frame before it, and the history it leaves.

Every frame and every history plane (image, visibility, LUT, matrices,
light, moments, age, consistency planes, frame counter) is compared by the
largest absolute gap. The program's kernels are bit-equal to their plain
versions, so the limits are 0 (``limits/<cell>.json``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

from perfbench.reference import config as ref_config, frame as ref_frame, history as ref_history
from perfbench.reference import scene as ref_scene

def gap(a, b) -> float:
    """The largest absolute gap between two tensors (inf where their shapes
    differ or a gap is not finite)."""
    if tuple(a.shape) != tuple(b.shape):
        return math.inf
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs().max().item()
    return d if math.isfinite(d) else math.inf


def history_gap(prog_hist, ref_hist) -> float:
    """The largest gap over the history's fields; a frame counter or a
    plane present on one side only is an infinite gap."""
    worst = 0.0
    for f in dataclasses.fields(ref_history.History):
        a, b = getattr(prog_hist, f.name), getattr(ref_hist, f.name)
        if f.name == "frame":
            worst = max(worst, 0.0 if int(a) == int(b) else math.inf)
        elif a is None or b is None:
            worst = max(worst, 0.0 if a is None and b is None else math.inf)
        else:
            worst = max(worst, gap(a, b))
    return worst


def as_reference_history(h) -> ref_history.History:
    """The program's history as the reference's dataclass (same fields)."""
    return ref_history.History(**{f.name: getattr(h, f.name)
                                  for f in dataclasses.fields(ref_history.History)})


def frame_inputs(motion, i: int):
    """The reference's camera and light of motion row ``i``."""
    camera = ref_scene.Camera(position=motion.cam_pos[i], rotation=motion.cam_rot[i])
    light = ref_scene.Light(position=motion.light_pos[i], color=motion.light_color)
    return camera, light


def run(vertices, indices, settings: dict, motion, start_frames, start_history, samples,
        device) -> tuple[dict, int]:
    """The compared numbers (frames_max_abs, history_max_abs) and the count
    of compared frames that differ from the reference at all."""
    t0 = time.perf_counter()
    cfg = ref_config.RenderConfig(**settings)
    tables = ref_scene.precompute_triangle_data(ref_scene.Scene.from_arrays(vertices, indices),
                                                device)
    frames_gap, hist_gap, failed = 0.0, 0.0, 0
    h = ref_frame.init_history(tables, cfg, device)
    for i, prog_rgb in enumerate(start_frames):
        rgb, h = ref_frame.render_frame(tables, *frame_inputs(motion, i), h, cfg)
        g = gap(prog_rgb, rgb)
        frames_gap, failed = max(frames_gap, g), failed + (g > 0)
    hist_gap = max(hist_gap, history_gap(start_history, h))
    for i, prev, prog_rgb, prog_hist in samples:
        rgb, h = ref_frame.render_frame(tables, *frame_inputs(motion, i),
                                        as_reference_history(prev), cfg)
        g = gap(prog_rgb, rgb)
        frames_gap, failed = max(frames_gap, g), failed + (g > 0)
        hist_gap = max(hist_gap, history_gap(prog_hist, h))
    print(f"perfbench: reference checked {len(start_frames)} + {len(samples)} frames in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"frames_max_abs": frames_gap, "history_max_abs": hist_gap}, failed
