"""The port's four benchmark scripts of the JAX package's root benchmarks/
(scaling, traversal_stats, wavefront_breakdown, multires_ab), each run with
--device cpu at a tiny size: they run the plain versions and print what
they print on the card, with the card's counters and device times null."""

import json

import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks import (
    multires_ab,
    scaling,
    traversal_stats,
    wavefront_breakdown,
)

torch.set_num_threads(1)


def _lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _scaling(lines):
    (line,) = lines
    assert line["tris"] == 128 and line["route"] == "lbvh" and line["size"] == [64, 48]
    for part in ("geometry", "trace", "frame"):
        assert line[part]["ms"] > 0 and "device_ms" not in line[part]


def _traversal(lines):
    *segments, total = lines
    assert [s["segment"] for s in segments] == [0, 1, 2] and total["segment"] == "total"
    assert segments[0]["live_rays"] == 32 * 24
    assert all(a["live_rays"] >= b["live_rays"] for a, b in zip(segments, segments[1:]))
    assert total["live_rays"] == sum(s["live_rays"] for s in segments)
    assert all(s["box_tests_per_ray"] is None for s in lines)  # the kernels count


def _breakdown(lines):
    (line,) = lines
    assert line["profiled_frame_bit_identical"] and line["primary"] and line["nee"]
    assert list(line["phases"]) == ["gbuffer_seed", "shadow_segment", "trace_segment[1]",
                                    "trace_segment[2]", "path_radiance"]
    assert all(p["host_ms"] > 0 and p["device_ms"] is None for p in line["phases"].values())


def _multires(lines):
    assert [line["metric"] for line in lines] == [
        "ms/frame, interactive 128tris base", "ms/frame, interactive 128tris s1x4gj"]
    assert all(line["value"] > 0 and line["size"] == [64, 48] for line in lines)


SCRIPTS = {
    "scaling": (scaling, ["--sizes", "128", "--frames", "1", "--width", "64", "--height", "48"],
                _scaling),
    "traversal_stats": (traversal_stats, ["--tris", "128", "--width", "32", "--height", "24",
                                          "--segments", "3"], _traversal),
    "wavefront_breakdown": (wavefront_breakdown, ["--tris", "128", "--width", "32", "--height",
                                                  "24", "--segments", "3", "--frames", "1",
                                                  "--primary"], _breakdown),
    "multires_ab": (multires_ab, ["--splits", "2", "--frames", "1", "--width", "64", "--height",
                                  "48", "--variants", "base,s1x4gj"], _multires),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_on_cpu(name, capsys):
    module, argv, check = SCRIPTS[name]
    module.main(argv + ["--device", "cpu"])
    check(_lines(capsys.readouterr().out))
