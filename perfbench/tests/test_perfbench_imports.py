"""Nothing the benchmark runs imports JAX, the JAX package, the root
benchmarks/ or bench.py; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from perfbench import registry

run_mod = __import__("perfbench.run", fromlist=["forbidden_modules"])
PORT = "real_time_path_tracing_with_spatiotemporal_filtering_torch"


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(registry.HERE, sub)):
        if os.path.basename(d) != "tests":
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_top_level_names_compared_whole():
    found = run_mod.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "jaxtyping", "flax.linen", "benchmarks.suite",
         "bench", "bench_torch", PORT, PORT + ".benchmarks.suite",
         "real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops"])
    assert found == ["bench", "benchmarks.suite", "flax.linen", "jax", "jax.numpy",
                     "jaxlib.xla_client",
                     "real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops"]


def test_no_source_imports_jax():
    for path in sources():
        for name in imported(path):
            assert not run_mod.forbidden_modules([name]), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in imported(path):
            assert name.split(".")[0] not in (PORT, "perfbench"), (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "from perfbench import harness, registry, run;"
            "b = registry.benchmark();"
            "c = dict(registry.workload(b, 'cornell_box.interactive_orbit'));"
            "harness.run_cell(b, c, 5, 0.1, False, torch.device('cpu'), 0.0, warmup=2,"
            " config_override={'display': {'width': 16, 'height': 16}});"
            "print(run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    import shutil

    shutil.copytree(registry.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "cornell_box.quality_orbit", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
