"""The row-sharded frame: each rank renders a slab of the frame's rows.

The counterpart of the JAX package's parallel/frame_sharded.py over a
:class:`~.sharding.RowGroup`. The G-buffer, the gradient and the path trace
are per pixel with the scene replicated: the slab runs them with no
communication, on the kernels' row-slab modes, whose seeds, rays and
backprojection are those of the global pixels. The a-trous filter at
stride k needs k rows of each neighbour (exchanged, the kernels' halo
mode), and the history gathers go through a small row window of the
neighbours while the motion stays in it, an all-gather beyond it
(sharding.reproject_rows_sharded), decided once a frame on every rank
alike. So the gathered slabs equal the single-device frame.

The slab runs the single-device kernel route itself
(pipeline/frame._render_frame_kernels, with its routing: the LBVH from
ops/intersect.BVH_MIN_TRIANGLES, the segment tracer under
cfg.gbuffer_primary and cfg.indirect_split) over a :class:`SlabRows`, which
makes the halo exchanges of the JAX package's frame in its order, so the
CommLedger counts what the JAX package's does. On the card every pass is a
kernel; on CPU tensors each wrapper runs its plain version. The gathers,
the variance estimate, the box filter and the upsample stay PyTorch, as on
the single device.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import RenderConfig
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build
from real_time_path_tracing_with_spatiotemporal_filtering_torch.parallel.sharding import (
    CommLedger,
    RowGroup,
    all_gather_rows,
    exchange_row_halo,
    reprojection_source,
    window_fits,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame as frame_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.history import History
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    precompute_triangle_data,
    tensors_to,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling

# The History fields that hold image rows (sharded); the others are replicated.
ROW_FIELDS = ("image", "visibility", "moments", "age", "vis_class", "noisy_lum")


def _slab(cfg: RenderConfig, group: RowGroup) -> tuple[int, int]:
    """(row_offset, rows) of this rank's slab."""
    rows = cfg.height // group.world_size
    return group.rank * rows, rows


class SlabRows(frame_mod.FrameRows):
    """This rank's slab of a frame's rows, as pipeline/frame.FrameRows: its
    filters read k exchanged rows of each neighbour (the kernels' halo
    mode), and its history gathers read a window of the neighbours' rows or
    the all-gathered plane, decided once a frame on every rank alike
    (sharding.window_fits). The collectives count into ``ledger``."""

    def __init__(self, cfg: RenderConfig, group: RowGroup, ledger: CommLedger | None):
        self.row_offset, self.rows = _slab(cfg, group)
        self.group, self.ledger = group, ledger
        self.small = None

    def halo(self, k: int) -> int:
        return k

    def pad(self, x: torch.Tensor, k: int) -> torch.Tensor:
        return exchange_row_halo(x, k, self.group, self.ledger)

    def backprojected(self, prev_y: torch.Tensor) -> None:
        self.small = window_fits(prev_y, self.row_offset, self.group)

    def source(self, plane: torch.Tensor) -> tuple:
        return reprojection_source(plane, self.row_offset, self.small, self.group, self.ledger)


def make_sharded_frame(cfg: RenderConfig, group: RowGroup, comm_ledger: CommLedger | None = None):
    """The row-sharded frame for ``group``:
    ``frame(tri_data, camera, light, history_local) -> (rgb_local,
    history_local')``, the image planes of the history and the image this
    rank's rows (:func:`init_sharded_history`), everything else replicated.
    With ``comm_ledger`` it returns ``(rgb_local, history_local', comm)``,
    ``comm = {"halo_bytes", "gather_bytes"}`` of this frame, and the
    ledger's counters are those of the frame (:class:`~.sharding.CommLedger`).
    Raises for the configurations the JAX package's rejects."""
    n = group.world_size
    if cfg.height % n != 0:
        raise ValueError(f"height {cfg.height} must divide evenly over {n} devices")
    rows = cfg.height // n
    if rows < cfg.wavelet_iterations:
        raise ValueError("each shard needs at least wavelet_iterations rows for the "
                         f"widest halo ({rows} < {cfg.wavelet_iterations})")
    if cfg.path_gradient and rows % cfg.gradient_stratum != 0:
        raise ValueError("path_gradient needs shard rows divisible by gradient_stratum "
                         f"({rows} % {cfg.gradient_stratum} != 0) so stratum cells do not "
                         "straddle shards")
    if cfg.indirect_split and rows % cfg.indirect_stride != 0:
        raise ValueError("indirect_split needs shard rows divisible by indirect_stride "
                         f"({rows} % {cfg.indirect_stride} != 0) so every shard starts on a "
                         "coarse-grid row")

    def frame(tri_data, camera, light, history_local):
        if comm_ledger is not None:
            comm_ledger.reset_static()
            comm_ledger.gather_bytes = 0
        rgb, hist = frame_mod._render_frame_kernels(tri_data, camera, light, history_local, cfg,
                                                    SlabRows(cfg, group, comm_ledger))
        if comm_ledger is None:
            return rgb, hist
        comm = {"halo_bytes": comm_ledger.halo_bytes, "gather_bytes": comm_ledger.gather_bytes}
        return rgb, hist, comm

    return frame


def init_sharded_history(tri_data, cfg: RenderConfig, group: RowGroup) -> History:
    """This rank's rows of pipeline/frame.init_history on its device."""
    full = frame_mod.init_history(tri_data, cfg, group.device)
    row_offset, rows = _slab(cfg, group)
    return dataclasses.replace(full, **{
        name: getattr(full, name)[row_offset: row_offset + rows].contiguous()
        for name in ROW_FIELDS if getattr(full, name) is not None
    })


def gather_history(hist: History, group: RowGroup) -> History:
    """The whole frame's history from every rank's slab (every rank gets it)."""
    return dataclasses.replace(hist, **{
        name: all_gather_rows(getattr(hist, name), group)
        for name in ROW_FIELDS if getattr(hist, name) is not None
    })


def render_sequence(group: RowGroup, scene, cfg: RenderConfig, poses, timed_frames: int = 0,
                    reference: bool = False, keep: bool = True):
    """Render ``poses`` ((camera, light) pairs, on any device) with the
    sharded frame from a fresh history: the rank function of
    sharding.spawn for the tests, chip_smoke.py and the benchmarks. Returns
    a dict; on every rank its rank, the ledger's counts of the last frame,
    and per frame its comm dict, kernel launches by name, wall ms and the
    ms spent in the collectives. On rank 0: with ``keep``, the gathered
    frames and histories (CPU tensors, "frames" and "history"); with
    ``reference``, whether each gathered frame and history plane equals,
    bit for bit, the single-device kernel route's (pipeline/frame.py) on
    the same poses ("equal", "max_abs"), with that route's launches and
    wall ms a frame. ``timed_frames``: that many more frames of the last
    pose under ``torch.profiler`` (on the card), for the device ms and
    launches a frame ("device")."""
    dev = group.device
    tri_data = precompute_triangle_data(scene, dev)
    ledger = CommLedger()
    frame = make_sharded_frame(cfg, group, ledger)
    hist = init_sharded_history(tri_data, cfg, group)
    poses = [(tensors_to(c, dev), tensors_to(li, dev)) for c, li in poses]
    out = {"rank": group.rank, "frames": [], "history": [], "comm": [], "launches": [],
           "ms": [], "comm_ms": []}
    gathered = []
    for camera, light in poses:
        _build.LAUNCHES.clear()
        comm_s = group.comm_s
        profiling.sync()
        t0 = time.perf_counter()
        rgb, hist, comm = frame(tri_data, camera, light, hist)
        profiling.sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["comm_ms"].append((group.comm_s - comm_s) * 1e3)
        out["launches"].append(dict(_build.LAUNCHES))
        out["comm"].append(comm)
        full = _planes(all_gather_rows(rgb, group), gather_history(hist, group))
        if group.rank == 0:
            gathered.append(full)
    out["ledger"] = {"halo_bytes": ledger.halo_bytes, "reproj_halo_bytes": ledger.reproj_halo_bytes,
                     "gather_fallback_bytes": ledger.gather_fallback_bytes}
    if timed_frames and dev.type == "cuda":
        state = {"hist": hist}
        camera, light = poses[-1]

        def step():
            state["hist"] = frame(tri_data, camera, light, state["hist"])[1]

        step()
        empty = profiling.empty_windows
        kernels = profiling.profiled_kernels(step, timed_frames)
        out["device"] = dict(profiling.device_time(kernels, timed_frames),
                             profiler_windows=1 + profiling.empty_windows - empty)
    if group.rank == 0:
        if reference:
            out.update(_against_single_device(tri_data, cfg, poses, gathered))
        if keep:
            out["frames"] = [g.pop("rgb").cpu() for g in gathered]
            out["history"] = [{k: v.cpu() for k, v in g.items()} for g in gathered]
    return out


def _planes(rgb, hist: History) -> dict:
    """A frame's image and its history's image planes, by name."""
    return {"rgb": rgb, **{name: getattr(hist, name) for name in ROW_FIELDS
                           if getattr(hist, name) is not None}}


def _against_single_device(tri_data, cfg, poses, gathered) -> dict:
    """The single-device kernel route on the same poses, frame by frame,
    against the gathered planes: equality, max abs difference, launches and
    wall ms a frame."""
    hist = frame_mod.init_history(tri_data, cfg)
    out = {"equal": [], "max_abs": [], "single_launches": [], "single_ms": []}
    for (camera, light), got in zip(poses, gathered):
        _build.LAUNCHES.clear()
        profiling.sync()
        t0 = time.perf_counter()
        rgb, hist = frame_mod._render_frame_kernels(tri_data, camera, light, hist, cfg)
        profiling.sync()
        out["single_ms"].append((time.perf_counter() - t0) * 1e3)
        out["single_launches"].append(dict(_build.LAUNCHES))
        want = _planes(rgb, hist)
        out["equal"].append({k: torch.equal(got[k], want[k]) for k in want})
        out["max_abs"].append(max((got[k].double() - want[k].double()).abs().max().item()
                                  for k in want))
    return out


def render_jobs(group: RowGroup, jobs) -> list:
    """:func:`render_sequence` for each (scene, cfg, poses) of ``jobs`` in
    turn, in one set of ranks."""
    return [render_sequence(group, *job) for job in jobs]


def main(argv=None) -> None:
    """Render frames with the sharded frame under ``torchrun`` (one process
    a rank; rank 0 prints a JSON line a frame and writes the last gathered
    frame), e.g. three ranks sharing one card over gloo:

        torchrun --nproc-per-node 3 -m \\
            real_time_path_tracing_with_spatiotemporal_filtering_torch.parallel.frame_sharded \\
            --backend gloo --frames 8 --out frame.png
    """
    import argparse
    import json

    import numpy as np

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.parallel.sharding import (
        close_group,
        make_group,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
        Camera,
        Light,
        Scene,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.image import write_png

    p = argparse.ArgumentParser(description="the row-sharded frame under torchrun")
    p.add_argument("--backend", required=True, help="gloo (ranks may share a card) or nccl")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--splits", type=int, default=0,
                   help="subdivided Cornell box of 32 s^2 triangles (0: the Cornell box)")
    p.add_argument("--orbit", type=float, default=0.01, help="camera azimuth step a frame")
    p.add_argument("--out", default=None, help="PNG of the last gathered frame")
    args = p.parse_args(argv)
    group = make_group(args.backend, device=args.device)
    try:
        scene = (Scene.cornell_box() if args.splits == 0
                 else Scene.from_arrays(*procedural.subdivided_cornell(args.splits)))
        cfg = RenderConfig(width=args.width, height=args.height)
        poses = [(Camera.orbit([0.0, 1.0, 0.0], 6.0, args.orbit * i, 1.0), Light.default())
                 for i in range(args.frames)]
        out = render_sequence(group, scene, cfg, poses, keep=args.out is not None)
        if group.rank == 0:
            for f, (ms, comm_ms, comm) in enumerate(zip(out["ms"], out["comm_ms"], out["comm"])):
                print(json.dumps({"frame": f, "ranks": group.world_size, "ms": ms,
                                  "exchange_ms": comm_ms, **comm}), flush=True)
            if args.out is not None:
                write_png(args.out, np.asarray(out["frames"][-1]))
    finally:
        close_group()


if __name__ == "__main__":
    main()
