"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled sub-window, with a breakdown. The last
key of the line, ``checks``, holds each number compared with the reference
beside its limit; the same lines end standard error. Exits non-zero,
printing no result, without a CUDA card, with fewer cards than the cell
asks for, when the measured package is missing, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what nothing this process runs may load, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "real_time_path_tracing_with_spatiotemporal_filtering_tpu",
             "benchmarks", "bench")
CACHE = os.path.join(ROOT, ".perfbench_cache")


def forbidden_modules(names) -> list[str]:
    """The module names whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def writable_roots() -> list[str]:
    """Where a run may write: its checkout and the HOME, XDG_CACHE_HOME and
    TMPDIR it was given."""
    roots = [ROOT] + [os.environ[k] for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR")
                      if os.environ.get(k)]
    return [os.path.realpath(r) for r in roots]


def guard_writes() -> None:
    """Refuse any file this process opens for writing, or directory it
    makes, outside ``writable_roots()`` (a Python audit hook)."""
    roots = writable_roots()
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def inside(path) -> bool:
        if isinstance(path, int):
            return True
        real = os.path.realpath(os.fsdecode(path))
        return real == os.devnull or any(real == r or real.startswith(r + os.sep) for r in roots)

    def hook(event, args):
        writes = ((event == "open" and args[0] is not None
                   and (any(c in str(args[1] or "") for c in "wax+")
                        or (isinstance(args[2], int) and args[2] & write_flags)))
                  or event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir", "shutil.rmtree"))
        if writes and not inside(args[0]):
            raise PermissionError(f"perfbench: {event} of {args[0]!r} outside the checkout, "
                                  "HOME, XDG_CACHE_HOME and TMPDIR")

    sys.addaudithook(hook)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a whole number >= 0")

    # every cache of a run inside the checkout, at fixed paths; Python's
    # bytecode too, since the installed packages may ship none and a run
    # would otherwise compile torch's sources on every import
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    if not os.environ.get("TMPDIR"):
        os.environ["TMPDIR"] = os.path.join(CACHE, "tmp")
        os.makedirs(os.environ["TMPDIR"], exist_ok=True)
    guard_writes()
    sys.path.insert(0, ROOT)

    from perfbench import registry

    bench = registry.benchmark(ROOT)
    cell = registry.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from perfbench import harness

    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_PROCESS)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
