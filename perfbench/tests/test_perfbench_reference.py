"""The frozen reference against the program's plain route on small frames
on the CPU: the same frames and histories, bit for bit, in every render
mode of the cells, under the orbit."""

import dataclasses

import pytest
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt
from perfbench import check, harness, motion, registry
from perfbench.reference import config as ref_config, frame as ref_frame, scene as ref_scene

BENCH = registry.benchmark()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_reference_equals_plain_route(name):
    cell = registry.workload(BENCH, name)
    config = registry.config(cell["config"])
    config["display"] = {"width": 40, "height": 24}
    traffic = registry.traffic(cell["traffic"])
    settings = harness.render_settings(config, traffic)
    v, i = harness.scene_arrays(config)
    m = motion.make_motion(traffic, 2**32 + 17, 5, "cpu")
    r = ptt.Renderer(ptt.Scene.from_arrays(v, i), ptt.RenderConfig(**settings), device="cpu")
    cfg = ref_config.RenderConfig(**settings)
    tables = ref_scene.precompute_triangle_data(ref_scene.Scene.from_arrays(v, i), "cpu")
    h = ref_frame.init_history(tables, cfg, "cpu")
    assert torch.equal(tables.lut, r.tri_data.lut)
    for f in range(len(m)):
        r.camera = ptt.Camera(position=m.cam_pos[f], rotation=m.cam_rot[f])
        r.light = ptt.Light(position=m.light_pos[f], color=m.light_color)
        rgb = r.step()
        ref_rgb, h = ref_frame.render_frame(tables, *check.frame_inputs(m, f), h, cfg)
        assert check.gap(rgb, ref_rgb) == 0.0
        assert check.history_gap(r.history, h) == 0.0
    assert [f.name for f in dataclasses.fields(ptt.History)] == [
        f.name for f in dataclasses.fields(check.ref_history.History)]


def test_gaps_see_every_difference():
    a = torch.zeros(4, 5, 3)
    b = a.clone()
    b[1, 2, 0] = 1e-7
    assert check.gap(a, b) > 0
    assert check.gap(a, a[:3]) == float("inf")
    b[0, 0, 0] = float("nan")
    assert check.gap(a, b) == float("inf")
