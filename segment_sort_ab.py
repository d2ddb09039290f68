#!/usr/bin/env python3
"""Does a coherence sort of the live rays between segments pay? (one CUDA card)

    python3 segment_sort_ab.py

On paths A and B of ``chip_smoke.py`` (``presets.cornell_stress`` with
32,768 triangles, 8 bounces and Russian roulette from bounce 2, and with
247,808 triangles in the parity config; 1920x1080, the orbit camera at
azimuth 0.03, frame 5), times one sample's segments by CUDA events in
turns: on the live lists as the segment kernel writes them, and with the
live list re-sorted before every segment after the first by the JAX
package's ``oct_cell`` ray key (``_sort_key`` with ``_spread4``,
ops/pallas/wavefront.py there: the direction octant above a 4-bit Morton
code of the origin's cell in the scene's bounds; dead rays last), the sort
(``torch.sort`` of the keys) and the key counted in. Checks that both give
the same ray state bit for bit, and prints the time of the keys and sorts
alone. Prints one JSON line per path and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

REPS = 5


def oct_cell_key(f, alive, lo, inv_size):
    """The JAX package's ``_sort_key(..., mode="oct_cell")`` of the rays in
    the (12, N) planes ``f`` (origin, direction, ...)."""
    import torch

    def cell(o, axis):
        q = ((o - lo[axis]) * inv_size[axis] * 16.0).to(torch.int32)
        return torch.clamp(q, 0, 15)

    def spread4(x):
        return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4) | ((x & 8) << 6)

    m = spread4(cell(f[0], 0)) | (spread4(cell(f[1], 1)) << 1) | (spread4(cell(f[2], 2)) << 2)
    oct3 = ((f[3] > 0.0).to(torch.int32) * 4 + (f[4] > 0.0).to(torch.int32) * 2
            + (f[5] > 0.0).to(torch.int32))
    key = (oct3 << 12) | m
    return torch.where(alive != 0, key, torch.full_like(key, 1 << 30))


def run_path(pt, wf, splits: int, overrides: dict, card: str) -> dict:
    import torch

    from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

    dev = torch.device("cuda")
    cfg = pt.RenderConfig(width=1920, height=1080, **overrides)
    td = pt.precompute_triangle_data(
        pt.Scene.from_arrays(*procedural.subdivided_cornell(splits)), dev)
    cam = pt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.03, 1.0, device=dev)
    light = pt.Light.default(dev)
    verts = td.lut[1:].reshape(-1, 3)
    lo = verts.amin(dim=0)
    inv_size = 1.0 / torch.clamp(verts.amax(dim=0) - lo, min=1e-6)
    n = cfg.width * cfg.height
    lists = wf.LiveLists(n, dev)
    sort_events = []

    def frame(sort: bool):
        rays = wf.RayState.empty(n, dev)
        launch = wf.SegmentLaunches(rays, td, cam.position, cam.rotation, light, 5, cfg,
                                    lists=lists)
        for seg in range(cfg.max_bounces):
            if sort and seg > 0:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                order = torch.sort(oct_cell_key(rays.f, rays.alive, lo, inv_size),
                                   stable=True).indices
                # the list the next launch reads (LiveLists rotates three)
                lists.slots[lists._launch].copy_(order)
                b.record()
                sort_events.append((a, b))
            launch(seg, 0, 0, seg == 0)
        return rays

    plain, sorted_ = frame(False), frame(True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(plain, sorted_))
    times = {False: [], True: []}
    for sort in (False, True, True, False):
        for _ in range(REPS + 1):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            frame(sort)
            b.record()
            times[sort].append((a, b))
    torch.cuda.synchronize()
    sort_events.clear()
    frame(True)
    torch.cuda.synchronize()
    segs = cfg.max_bounces

    def mean_ms(pairs):
        pairs = [p for k, p in enumerate(pairs) if k % (REPS + 1)]  # drop each turn's warm-up
        return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)

    return dict(
        path=f"{td.num_triangles} triangles, {cfg.max_bounces} bounces, rr "
             f"{cfg.rr_start_bounce}, {cfg.width}x{cfg.height}",
        bit_equal=same,
        frame_segments_ms=mean_ms(times[False]),
        frame_segments_sorted_ms=mean_ms(times[True]),
        keys_and_sorts_ms=sum(a.elapsed_time(b) for a, b in sort_events),
        launches=segs, card=card)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("segment_sort_ab: no CUDA device", file=sys.stderr)
        return 1
    import real_time_path_tracing_with_spatiotemporal_filtering_torch as pt
    from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import wavefront

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    ok = True
    for splits, over in ((32, dict(max_bounces=8, rr_start_bounce=2)), (88, {})):
        res = run_path(pt, wavefront, splits, over, card)
        print(json.dumps(res), flush=True)
        ok = ok and res["bit_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
