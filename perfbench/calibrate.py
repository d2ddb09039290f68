"""Read the check's numbers for the limits: the program on several seeds and
the control (the reference in the program's place, in TF32) on several
more, at the cell's own size and load, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6
        [--seconds 2]

Prints one JSON line a run: which side, the seed, each number compared.
The benchmark's own runs never run this; ``limits/<cell>.json`` records
the readings it gave.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import control, harness, registry  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    device = torch.device("cuda", 0)
    sides = [("program", harness.PortProgram, int(s), harness.WARMUP_FRAMES)
             for s in args.seeds.split(",") if s]
    # the control renders each frame on the plain route: the two frames the
    # check renders from scratch, then a short window
    sides += [("control", control.ReferenceProgram, int(s), harness.START_FRAMES)
              for s in args.control_seeds.split(",") if s]
    for side, program, seed, warmup in sides:
        t0 = time.perf_counter()
        result = harness.run_cell(bench, cell, seed, args.seconds, False, device, t0,
                                  program=program, warmup=warmup)
        print(json.dumps({"workload": cell["name"], "side": side, "seed": seed,
                          "correct": result["correct"], "frames": result["attempted"],
                          "numbers": {k: v["value"] for k, v in result["checks"].items()},
                          "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
