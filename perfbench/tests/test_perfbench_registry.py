"""Every file a cell names is found by name, and a new cell, configuration,
traffic mix, limit and per-layer metric are found by adding files only."""

import json
import os
import shutil

import torch

from perfbench import harness, registry

BENCH = registry.benchmark()


def test_every_named_file_loads():
    for cell in BENCH["workloads"]:
        config = registry.config(cell["config"])
        traffic = registry.traffic(cell["traffic"])
        limits = registry.limits(cell["name"])
        assert config["name"] == cell["config"] and traffic["name"] == cell["traffic"]
        assert set(limits["numbers"]) == {"frames_max_abs", "history_max_abs"}
        settings = harness.render_settings(config, traffic)
        assert settings["width"] == 1920 and settings["height"] == 1080
    for entry in BENCH["configs"]:
        assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
        assert registry.config(entry["name"])["reduced"] == entry["reduced"]
    for metric in BENCH["per_layer"]:
        assert callable(registry.metric_reader(metric["name"]))


def test_bad_names_are_refused():
    for bad in ("../BENCHMARK", "a/b", "", ".hidden"):
        try:
            registry.config(bad)
        except (ValueError, FileNotFoundError):
            continue
        raise AssertionError(f"{bad!r} was accepted")


def test_new_cell_found_by_adding_files(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "PROFILED_FRAMES", 4)
    base = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (base / sub).mkdir(parents=True)
    config = registry.config("cornell_box")
    config.update(name="tiny_box", display={"width": 24, "height": 16})
    (base / "configs" / "tiny_box.json").write_text(json.dumps(config))
    traffic = registry.traffic("interactive_orbit_dense")
    traffic.update(name="still_light", render={"rr_start_bounce": 4})
    (base / "traffic" / "still_light.json").write_text(json.dumps(traffic))
    shutil.copy(os.path.join(registry.HERE, "limits", "cornell_box.interactive_orbit.json"),
                base / "limits" / "tiny_box.still_light.json")
    (base / "metrics" / "frames_profiled.py").write_text(
        "def read(ctx):\n    return float(ctx.frames)\n")
    cell = {"name": "tiny_box.still_light", "config": "tiny_box", "traffic": "still_light",
            "chips": 1, "why": "a test"}
    bench = {**BENCH, "workloads": [cell],
             "per_layer": [{"name": "frames_profiled", "unit": "frames", "better": "lower",
                            "source": "device_trace", "layer": "device", "moves": "frame_ms",
                            "workloads": [cell["name"]]}]}
    result = harness.run_cell(bench, cell, 7, 0.2, True, torch.device("cpu"), 0.0, warmup=2,
                              base=str(base))
    assert result["correct"] is True
    assert result["metrics"] == {"frames_profiled": {"value": 4.0,
                                                     "unit": "frames"}}
