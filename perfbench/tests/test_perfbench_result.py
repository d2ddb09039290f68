"""The result line: its keys, the checks last, and a small cell driven end
to end on the CPU (the harness's look for a card skipped)."""

import json
import math

import torch

from perfbench import harness, registry

BENCH = registry.benchmark()
SMALL = {"display": {"width": 32, "height": 24}}


def small_run(name, trace, program=harness.PortProgram, seed=2**31 + 99, **kw):
    cell = registry.workload(BENCH, name)
    return harness.run_cell(BENCH, cell, seed, 0.3, trace, torch.device("cpu"), 0.0,
                            program=program, warmup=3, config_override=SMALL, **kw)


def test_untraced_line():
    result = small_run("cornell_box.interactive_orbit", False)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert line["metrics"]["frame_ms"]["unit"] == "ms"
    assert line["checks"] == {"frames_max_abs": {"value": 0.0, "limit": 0.0},
                              "history_max_abs": {"value": 0.0, "limit": 0.0}}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_line(monkeypatch):
    monkeypatch.setattr(harness, "PROFILED_FRAMES", 4)
    result = small_run("cornell_box.quality_orbit", True)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in BENCH["per_layer"]}
    assert set(line["metrics"]) <= names and "host_ms_per_frame" in line["metrics"]
    assert "frame_ms" not in line["metrics"]


def test_same_seed_same_inputs():
    from perfbench import motion

    traffic = registry.traffic("quality_orbit")
    a = motion.make_motion(traffic, 2**33 + 5, 50, "cpu")
    b = motion.make_motion(traffic, 2**33 + 5, 50, "cpu")
    c = motion.make_motion(traffic, 2**33 + 6, 50, "cpu")
    for x, y in zip((a.cam_pos, a.cam_rot, a.light_pos), (b.cam_pos, b.cam_rot, b.light_pos)):
        assert torch.equal(x, y)
    assert not torch.equal(a.cam_pos, c.cam_pos)
    step = a.cam_pos[1:] - a.cam_pos[:-1]
    assert torch.all(step.norm(dim=1) < 0.07)   # 0.01 rad a frame at radius 6

