"""The port's micro-kernel twins against the JAX package's Mosaic
micro-benchmarks (benchmarks/mosaic_micro.py), bit for bit.

The JAX kernels run unedited, in Pallas's interpret mode: ``pallas_call``
gets ``interpret=True``, the benchmark's ``_timed`` calls each compiled
kernel once on its input, and ``fori_loop`` hands its result and the
scratch refs its body closes over to a ``jax.debug.callback``. So the test
reads every loop carry (which the kernels' outputs multiply by zero) and
the ``when`` and ``dynwin`` tables, at both iteration counts of each
primitive's slope (``--iters 64``), and requires the port's plain twins
(ops/cuda/micro.py; the CUDA wrappers run them on CPU tensors) to give the
same output and carries.
"""

import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import mosaic_micro
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import micro

torch.set_num_threads(1)

ITERS = 64
# The loop result's leaves of each primitive, in order; the refs its body
# closes over are named by their variables.
CARRIES = {"scalar": ("a", "b"), "dynrow": ("a", "acc"), "assemble": ("a", "acc"),
           "vec1x128": ("acc",), "vec8x128": ("acc",), "vec8x512": ("acc",), "when": ("a",),
           "reduce": ("a", "s"), "dynwin": ("a",), "cond": ("a", "b")}
GROUPS = {
    "scalar_like": ("scalar", "when", "cond"),
    "row_like": ("dynrow", "assemble", "dynwin"),
    "vector": ("vec1x128", "vec8x128", "vec8x512", "reduce"),
}


def _jax_runs(monkeypatch, which):
    """Run the JAX benchmark on ``which`` at --iters 64; returns, in the
    benchmark's order, (x, out, {loop upper bound: {name: value}}) for each
    compiled kernel (two per primitive: the high count, then the low)."""
    runs = []
    pallas_call, fori_loop = pl.pallas_call, jax.lax.fori_loop

    def interpreted(*args, **kwargs):
        return pallas_call(*args, **dict(kwargs, interpret=True))

    def fori(lower, upper, body, init):
        result = fori_loop(lower, upper, body, init)
        refs = [(name, cell.cell_contents[...])
                for name, cell in zip(body.__code__.co_freevars, body.__closure__ or ())
                if type(getattr(cell.cell_contents, "aval", None)).__name__ == "AbstractRef"]
        leaves = jax.tree_util.tree_leaves(result)

        def record(*values):
            names = [f"#{i}" for i in range(len(leaves))] + [name for name, _ in refs]
            runs[-1][2][upper] = dict(zip(names, (np.asarray(v) for v in values)))

        jax.debug.callback(record, *leaves, *(value for _, value in refs))
        return result

    def timed(fn, x, reps=8):
        runs.append([np.asarray(x), None, {}])
        runs[-1][1] = np.asarray(fn(x))
        jax.effects_barrier()
        return 1.0

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jax.lax, "fori_loop", fori)
    monkeypatch.setattr(mosaic_micro, "_timed", timed)
    monkeypatch.setattr(sys, "argv", ["mosaic_micro", "--which", ",".join(which),
                                      "--iters", str(ITERS)])
    mosaic_micro.main()
    return runs


def _same_bits(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    assert got.tobytes() == want.tobytes(), (what, got, want)


@pytest.mark.parametrize("group", list(GROUPS))
def test_plain_twins_equal_jax_kernels(monkeypatch, group):
    order = [name for name in micro.PRIMITIVES if name in GROUPS[group]]
    runs = _jax_runs(monkeypatch, order)
    assert len(runs) == 2 * len(order)
    for i, name in enumerate(order):
        prim = micro.PRIMITIVES[name]
        for (x, out, loops), iters in zip(runs[2 * i:2 * i + 2],
                                          (ITERS // prim.hi_div, ITERS // prim.lo_div)):
            x_port = micro.make_input("cpu")
            _same_bits(x_port, x, f"{name} input")
            got = micro.run(name, x_port, iters)
            _same_bits(got["out"], out, f"{name} out at {iters}")
            np.testing.assert_array_equal(out, x)
            want = loops[iters]
            for j, carry in enumerate(CARRIES[name]):
                want[carry] = want.pop(f"#{j}")
            compared = sorted(set(got) - {"out"})
            assert set(compared) <= set(want), (name, compared, sorted(want))
            for carry in compared:
                _same_bits(got[carry], want[carry], f"{name} {carry} at {iters}")
