"""Find a cell's files by name, so that a cell, a configuration, a traffic
mix, a correctness limit or a per-layer metric is added by adding a file.

    configs/<config>.json     the configuration (scene and display size)
    traffic/<traffic>.json    the traffic mix (render mode and motion)
    limits/<workload>.json    the cell's correctness limits
    metrics/<metric>.py       a per-layer metric's reader: ``read(ctx)``
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _path(kind: str, name: str, ext: str, base: str = HERE) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, base: str = HERE) -> dict:
    return _json(_path("configs", name, ".json", base))


def traffic(name: str, base: str = HERE) -> dict:
    return _json(_path("traffic", name, ".json", base))


def limits(name: str, base: str = HERE) -> dict:
    return _json(_path("limits", name, ".json", base))


def metric_reader(name: str, base: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``: a number, or
    None where the run holds nothing for it to read."""
    path = _path("metrics", name, ".py", base)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell_name: str, section: str) -> list[dict]:
    """The metrics of ``section`` (end_to_end or per_layer) that the cell
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]
