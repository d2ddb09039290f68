"""Micro-benchmarks of the primitives a per-lane BVH walk is built from, on
the card: the JAX package's Mosaic micro-benchmarks as Hopper kernels.

  scalar    -- one thread's dependent loop: integer arithmetic and a read of
               a 512-entry shared table at a data-dependent index
  dynrow    -- a shared-memory row at a data-dependent index -> accumulate
               (128 threads, one per column)
  assemble  -- 8 such rows at once -> accumulate (1024 threads)
  vec1x128  -- an elementwise chain, one thread per element, on 128,
  vec8x128     1024 and
  vec8x512     4096 elements
  when      -- a guarded store into a shared table in one thread's loop
  reduce    -- a block-wide max (warp shuffles and shared memory) fed back
               into every thread's loop
  dynwin    -- an (8, 128) shared window at a data-dependent offset, scaled
               in place (1024 threads)
  cond      -- an in-loop branch with trivial arms

Each kernel (csrc/micro.cu, wrapped by ops/cuda/micro.py) runs its
primitive ``iters`` times in one launch. The cost of an iteration is the
slope between two iteration counts (the JAX benchmark's ``run_pair``, with
its counts: ``--iters`` divided by each primitive's pair of divisors), from
the mean time of five back-to-back launches at each count (CUDA events),
so launch overhead and the fixed work of a launch drop out. ``--device
cpu`` runs the plain PyTorch twins on the CPU, timed with the host clock.

Usage: python -m real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.mosaic_micro
           [--which all] [--iters 200000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import micro
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import device as dev_mod
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import profiling

REPS = 5


def launch_ms(name: str, x: torch.Tensor, iters: int, reps: int = REPS,
              plain: bool = False) -> tuple:
    """Milliseconds of one run of primitive ``name`` at ``iters``
    iterations, the mean of ``reps`` back-to-back runs after one warm-up
    (``profiling.time_fn``), and the result of the last run. On the card the
    kernel outlasts the wrapper's host work (0.08 ms and more at the JAX
    counts), so the runs queue and the mean is the device's time."""
    fn = micro.run_plain if plain else micro.run
    kept = {}

    def call():
        kept["result"] = fn(name, x, iters)
        return kept["result"]

    return profiling.time_fn(call, iters=reps, warmup=1), kept["result"]


def run_pair(name: str, x: torch.Tensor, iters_hi: int, iters_lo: int, reps: int = REPS,
             plain: bool = False) -> dict:
    """ns per iteration of primitive ``name``: the slope between the times
    at ``iters_hi`` and ``iters_lo`` iterations (``launch_ms``), with the
    result of the last run at each count (``hi_result``, ``lo_result``)."""
    hi, hi_result = launch_ms(name, x, iters_hi, reps, plain)
    lo, lo_result = launch_ms(name, x, iters_lo, reps, plain)
    return dict(ns_per_iter=(hi - lo) / (iters_hi - iters_lo) * 1e6, hi_ms=hi, lo_ms=lo,
                iters_hi=iters_hi, iters_lo=iters_lo, hi_result=hi_result, lo_result=lo_result)


def counts(name: str, iters: int) -> tuple:
    """The JAX benchmark's two iteration counts for ``name``."""
    prim = micro.PRIMITIVES[name]
    return iters // prim.hi_div, iters // prim.lo_div


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--which", default="all")
    parser.add_argument("--iters", type=int, default=200_000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    print(f"# device: {dev_mod.device_name(dev)}"
          + (f" ({dev_mod.card_line()})" if dev.type == "cuda" else ""))
    which = list(micro.PRIMITIVES) if args.which == "all" else args.which.split(",")
    x = micro.make_input(dev)
    for name in which:
        r = run_pair(name, x, *counts(name, args.iters))
        print(f"{name:<10} {r['ns_per_iter']:8.2f} ns/iter   "
              f"(hi {r['hi_ms']:.3f} ms, lo {r['lo_ms']:.3f} ms)", flush=True)


if __name__ == "__main__":
    main()
