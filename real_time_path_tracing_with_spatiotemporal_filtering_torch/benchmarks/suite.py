"""Benchmark suite of the PyTorch port: the JAX package's tracked configs.

Run: python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.suite
         [--quick] [--only SUBSTR] [--device-time] [--device cuda|cpu]

The seventeen rows of the JAX package's ``benchmarks/suite.py``, under its
names letter for letter, with its ``--quick`` stand-ins (rows 4, 4b and 4d
on 128 triangles, rows 4c', 4c'', 4d' and 4d'' left out), its frames (20;
10 for the interactive rows; 3 for the 247,808-triangle rows; 5 each with
``--quick``) and its mutators (the orbit camera, ``light_drift``,
``light_cuts``). Each row renders two warm-up frames, then its timed frames
back to back, synchronised once at the end. Prints one JSON line per row
and a table on stderr.

``--device-time`` renders the same number of frames again under
``torch.profiler`` and adds to each row's line the device's busy ms per
frame (the union of its kernel intervals), its kernel launches per frame
and its idle share over that window (``utils/profiling.device_time``).
Device ms and launches do not depend on the host; the idle share is taken
against the profiled window's wall time, which the profiler's own host
cost lengthens, so it is an upper bound. The suite runs on the card;
``--device cpu`` runs the plain versions instead (the JAX suite's
``--cpu``). Each scene's tables, and its LBVH, are built once and shared by
the rows that use it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling


def bench_renderer(make_renderer, frames, mutate=None, device_time=False) -> dict:
    """ms/frame of ``frames`` frames after two warm-up frames; with
    ``device_time``, the device's busy ms, launches and idle share per frame
    over ``frames`` more, profiled, and the profiler windows that took
    (more than 1: a window held no kernel and was taken again)."""
    r = make_renderer()
    profiling.sync(r.step())  # warm
    profiling.sync(r.step())

    def run(first):
        rgb = None
        for i in range(first, first + frames):
            if mutate is not None:
                mutate(r, i)
            rgb = r.step()
        profiling.sync(rgb)

    t0 = time.perf_counter()
    run(0)
    result = dict(ms=(time.perf_counter() - t0) / frames * 1000.0)
    if device_time:
        wall = []

        def profiled():
            t0 = time.perf_counter()
            run(frames)
            wall.append(time.perf_counter() - t0)

        empty = profiling.empty_windows
        kernels = profiling.profiled_kernels(profiled, 1)
        profiled_ms = wall[-1] / frames * 1000.0  # the window the kernels are from
        busy = profiling.device_time(kernels, frames)
        result.update(device_ms=busy["device_ms"], launches=busy["launches"],
                      idle_share=1.0 - busy["device_ms"] / profiled_ms,
                      profiler_windows=1 + profiling.empty_windows - empty)
    return result


def suite_entries(quick: bool, device="cuda", device_time: bool = False):
    """The tracked configs as (name, thunk) pairs; each thunk measures and
    returns what ``bench_renderer`` returns. Lazy so a --only filter skips
    scene prep entirely."""
    dev = dev_mod.resolve(device)
    if device_time and dev.type != "cuda":
        raise ValueError("device time is measured on the card only")
    frames = 5 if quick else 20
    # steady-state rows: 10 timed frames after 2 warm (the JAX suite's choice)
    interactive_frames = frames if quick else 10
    # the 32-bounce parity stress rows: 3 frames
    big_frames = frames if quick else 3
    scene_cache: dict = {}

    def cornell():
        if "cornell" not in scene_cache:
            scene = ptt.Scene.cornell_box()
            scene_cache["cornell"] = (scene, ptt.precompute_triangle_data(scene, dev))
        return scene_cache["cornell"]

    def subdiv(splits):
        key = ("subdiv", splits)
        if key not in scene_cache:
            scene = ptt.Scene.from_arrays(*procedural.subdivided_cornell(splits))
            scene_cache[key] = (scene, ptt.precompute_triangle_data(scene, dev))
        return scene_cache[key]

    def run(scene_fn, cfg, n, mutate=None):
        def make():
            scene, tri_data = scene_fn()
            return ptt.Renderer(scene, cfg, device=dev, tri_data=tri_data)

        return lambda: bench_renderer(make, n, mutate, device_time)

    entries = []

    # 0. the reference's exact configuration (1000x800, main.cpp:52-53)
    cfg0 = ptt.RenderConfig()
    entries.append(("cornell_1000x800_reference_parity", run(cornell, cfg0, frames)))

    # 1. spatial-only 512x512 (temporal alpha 1.0 = no history blend)
    cfg1 = ptt.RenderConfig(width=512, height=512, ema_alpha=1.0)
    entries.append(("cornell_512_spatial_only", run(cornell, cfg1, frames)))

    # 2. full SVGF 512x512: temporal EMA + variance-guided a-trous
    cfg2 = ptt.RenderConfig(width=512, height=512, variance_guided=True)
    entries.append(("cornell_512_full_svgf", run(cornell, cfg2, frames)))

    # 2b. + Russian roulette from bounce 4
    cfg2rr = dataclasses.replace(cfg2, rr_start_bounce=4)
    entries.append(("cornell_512_full_svgf_rr4_nonparity", run(cornell, cfg2rr, frames)))

    # 2c. NEE + variance guidance
    cfg2nee = dataclasses.replace(cfg2, nee=True)
    entries.append(("cornell_512_svgf_nee_nonparity", run(cornell, cfg2nee, frames)))

    # 2d. + the SVGF accumulation ramp
    cfg2ramp = dataclasses.replace(cfg2, accumulation_ramp=True)
    entries.append(("cornell_512_svgf_ramp_nonparity", run(cornell, cfg2ramp, frames)))

    # 2e. + the A-SVGF path-space gradient, the light drifting
    cfg2pg = dataclasses.replace(cfg2, accumulation_ramp=True, path_gradient=True)

    def light_drift(r, i):
        r.move_light(dx=0.05)

    entries.append(("cornell_512_svgf_ramp_pathgrad_nonparity",
                    run(cornell, cfg2pg, frames, light_drift)))

    # 3. orbiting camera, full A-SVGF with adaptive alpha, 1080p
    cfg3 = ptt.RenderConfig(width=1920, height=1080, adaptive_alpha=True)

    def orbit(r, i):
        r.camera = ptt.Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.01 * i, 1.0, device=dev)

    entries.append(("cornell_1080p_asvgf_orbit", run(cornell, cfg3, frames, orbit)))

    # 4. traversal stress: 247,808 triangles (--quick: 128), orbit, 1080p
    splits = 2 if quick else 88
    big = lambda: subdiv(splits)  # noqa: E731
    cfg4 = ptt.RenderConfig(width=1920, height=1080)
    entries.append((f"cornell_subdiv{splits}_{32 * splits * splits}tris_1080p_orbit",
                    run(big, cfg4, big_frames, orbit)))

    # 4b. the same with RR from bounce 4
    cfg4rr = dataclasses.replace(cfg4, rr_start_bounce=4)
    entries.append((f"cornell_subdiv{splits}_rr4_nonparity", run(big, cfg4rr, big_frames, orbit)))

    # 4c. mid-scale interactive: 32,768 triangles (--quick: 128), 8 bounces,
    # RR from 2, adaptive alpha
    mid_splits = 2 if quick else 32
    mid = lambda: subdiv(mid_splits)  # noqa: E731
    cfg4i = ptt.RenderConfig(width=1920, height=1080, max_bounces=8, rr_start_bounce=2,
                             adaptive_alpha=True)
    mid_name = f"cornell_subdiv{mid_splits}_{32 * mid_splits * mid_splits}tris_1080p"
    entries.append((f"{mid_name}_interactive_nonparity",
                    run(mid, cfg4i, interactive_frames, orbit)))

    # 4c'. + multi-res indirect (split 1, stride 4) + G-buffer primaries
    cfg4ig = dataclasses.replace(cfg4i, indirect_split=1, indirect_stride=4,
                                 gbuffer_primary=True)
    if not quick:
        entries.append((f"{mid_name}_interactive_multires_gprimary_nonparity",
                        run(mid, cfg4ig, interactive_frames, orbit)))

    # 4c''. the recommended-quality interactive config: 4c' + variance
    # guidance + the ramp ("normal" reset) + grid-phase jitter
    cfg4iq = dataclasses.replace(cfg4ig, indirect_jitter=True, variance_guided=True,
                                 accumulation_ramp=True, ramp_reset_mode="normal")
    if not quick:
        entries.append((f"{mid_name}_interactive_recommended_nonparity",
                        run(mid, cfg4iq, interactive_frames, orbit)))

    # 4d. the 247,808-triangle scene with 4c's levers
    big_name = f"cornell_subdiv{splits}_{32 * splits * splits}tris_1080p"
    cfg4si = dataclasses.replace(cfg4i)
    entries.append((f"{big_name}_interactive_nonparity",
                    run(big, cfg4si, interactive_frames, orbit)))

    # 4d'. + multi-res indirect + G-buffer primaries
    cfg4sig = dataclasses.replace(cfg4si, indirect_split=1, indirect_stride=4,
                                  gbuffer_primary=True)
    if not quick:
        entries.append((f"{big_name}_interactive_multires_gprimary_nonparity",
                        run(big, cfg4sig, interactive_frames, orbit)))

    # 4d''. the recommended-quality config at 247,808 triangles
    cfg4sq = dataclasses.replace(cfg4sig, indirect_jitter=True, variance_guided=True,
                                 accumulation_ramp=True, ramp_reset_mode="normal")
    if not quick:
        entries.append((f"{big_name}_interactive_recommended_nonparity",
                        run(big, cfg4sq, interactive_frames, orbit)))

    # 5. dynamic light + camera cuts, 4spp, gradient-driven rejection
    cfg5 = ptt.RenderConfig(width=512, height=512, spp=4, adaptive_alpha=True)

    def light_cuts(r, i):
        r.move_light(dx=0.3)
        if i % 7 == 6:
            r.move_camera(dx=0.8 if (i // 7) % 2 == 0 else -0.8)

    entries.append(("cornell_512_4spp_dynamic_light_cuts",
                    run(cornell, cfg5, frames, light_cuts)))
    return entries


def run_suite(quick: bool, only: str | None = None, device="cuda",
              device_time: bool = False) -> list:
    results = []
    for name, thunk in suite_entries(quick, device, device_time):
        if only is not None and only not in name:
            continue
        results.append((name, thunk()))
        # stream partial results: a killed run leaves the finished rows
        print(f"[suite] {name}: {results[-1][1]['ms']:.1f} ms", file=sys.stderr, flush=True)
    return results


def row_line(name: str, result: dict, device_name: str) -> dict:
    line = {"metric": f"ms/frame, {name}, single {device_name}",
            "value": round(result["ms"], 3), "unit": "ms/frame"}
    for key in ("device_ms", "launches", "idle_share"):
        if key in result:
            line[key] = round(result[key], 4)
    if "profiler_windows" in result:
        line["profiler_windows"] = result["profiler_windows"]
    return line


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--only", default=None, metavar="SUBSTR",
                        help="run only config names containing SUBSTR")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--device-time", action="store_true",
                        help="add device busy ms, launches and idle share per frame")
    args = parser.parse_args(argv)
    name = dev_mod.device_name(args.device)
    results = run_suite(args.quick, args.only, args.device, args.device_time)
    for row, result in results:
        print(json.dumps(row_line(row, result, name)), flush=True)
    print("\nconfig                                   ms/frame", file=sys.stderr)
    for row, result in results:
        print(f"{row:42s} {result['ms']:8.2f}", file=sys.stderr)


if __name__ == "__main__":
    main()
