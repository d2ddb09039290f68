"""Micro-kernels: the JAX package's eight Mosaic micro-benchmarks on Hopper.

``benchmarks/mosaic_micro.py`` of the JAX package times, in ns per loop
iteration, the primitives a per-lane BVH walk is built from: dependent
scalar reads of a small table, dynamically indexed row reads, elementwise
chains, guarded stores, block reductions fed back into the loop and
divergent branches. Its eight ``pallas_call`` sites run ten primitives
(``vec_make`` builds three). Each primitive here has a CUDA kernel
(``csrc/micro.cu``) and a plain PyTorch twin that computes the same
function: the (8, 512) float32 output, which equals the input because each
kernel adds its carry times zero, and every loop carry, returned so that
neither version's loop is dead code.

:func:`run` launches the kernel for a CUDA tensor and runs :func:`run_plain`
for a CPU tensor. Integer carries wrap as int32 does: the kernels compute in
``uint32_t``; the plain twins carry int64 masked to 32 bits (as ops/rng.py
does) and give int32 at the end. XLA on the CPU, where the JAX kernels run
in interpret mode, contracts each product that feeds an add into one fused
multiply-add (one rounding): the elementwise chain's ``acc * 1.0001 + v``
and ``t - (acc * v) * 1e-7`` and the reduction's ``s + m * 1e-20``. The
kernels write those as ``__fmaf_rn`` and the plain twins as :func:`fma32`;
every other product and sum rounds on its own (``--fmad=false``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build

ROWS, COLS = 8, 512  # the input and output of every primitive
_MASK = 0xFFFFFFFF
# The value Pallas's interpret mode gives int32 scratch that was never
# written; the kernels start the `when` table from it, so every entry of
# that table is defined (on the TPU the unwritten entries are undefined).
INT32_MIN = -(2 ** 31)
# float32 constants of the JAX kernels, as exact Python floats
_GROW = float(np.float32(1.0001))
_DAMP = float(np.float32(1e-7))
_FEED = float(np.float32(1e-20))
_SCALE = float(np.float32(1.0000001))
_X_STEP = float(np.float32(1e-6))


class Primitive(NamedTuple):
    kernel: str          # the kernel (one per pallas_call site) that runs it
    hi_div: int          # the two iteration counts of the slope: iters // hi_div
    lo_div: int          # and iters // lo_div, as the JAX benchmark's run_pair
    shape: tuple | None  # vec_make's (rows, cols)


PRIMITIVES = {
    "scalar": Primitive("scalar", 1, 4, None),
    "dynrow": Primitive("dynrow", 4, 16, None),
    "assemble": Primitive("assemble", 8, 32, None),
    "vec1x128": Primitive("vec", 2, 8, (1, 128)),
    "vec8x128": Primitive("vec", 2, 8, (8, 128)),
    "vec8x512": Primitive("vec", 2, 8, (8, 512)),
    "when": Primitive("when", 4, 16, None),
    "reduce": Primitive("reduce", 4, 16, None),
    "dynwin": Primitive("dynwin", 4, 16, None),
    "cond": Primitive("cond", 4, 16, None),
}


def make_input(device) -> torch.Tensor:
    """The benchmark's input: arange(8 * 512) * 1e-6 as (8, 512) float32."""
    return torch.arange(ROWS * COLS, dtype=torch.float32, device=device).reshape(ROWS, COLS) * _X_STEP


def _i32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 word -> int32 of the same bits."""
    return (((u & _MASK) + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, TwoSum gives the float64 sum's exact
    error, and that error breaks the tie where the float64 sum lies halfway
    between two float32 values (elsewhere rounding it to float32 is
    already the correctly rounded result)."""
    p = a.double() * torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    lo = torch.where(r.double() > s, torch.nextafter(r, torch.full_like(r, -np.inf)), r)
    hi = torch.nextafter(lo, torch.full_like(lo, np.inf))
    tie = (s - lo.double()) == (hi.double() - s)
    return torch.where(tie & (err > 0), hi, torch.where(tie & (err < 0), lo, r))


def _scalar(x, iters):
    dev = x.device
    tab = torch.arange(512, dtype=torch.int64, device=dev) * 3 + 1
    a = torch.tensor(1, dtype=torch.int64, device=dev)
    b = torch.tensor(2, dtype=torch.int64, device=dev)
    for _ in range(iters):
        v = tab[a & 511]
        a = (a * 5 + v) & 0x7FFFFFF
        b = b ^ (a >> 3)
    return dict(out=x + _i32(a + b).to(torch.float32) * 0.0, a=_i32(a), b=_i32(b))


def _dynrow(x, iters):
    vbuf = x[:, :128].repeat(16, 1)  # (128, 128): row r is x[r % 8, :128]
    a = torch.tensor(1, dtype=torch.int64, device=x.device)
    acc = torch.zeros((1, 128), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        acc = acc + vbuf.index_select(0, (a & 127).reshape(1))
        a = (a * 5 + 1) & _MASK
    out = x.clone()
    out[0:1, :128] = x[0:1, :128] + acc * 0.0
    return dict(out=out, a=_i32(a), acc=acc)


def _assemble(x, iters):
    vbuf = x[:, :128].repeat(16, 1)
    offsets = torch.arange(8, dtype=torch.int64, device=x.device) * 37
    a = torch.tensor(1, dtype=torch.int64, device=x.device)
    acc = torch.zeros((8, 128), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        acc = acc + vbuf.index_select(0, (a + offsets) & 127)
        a = (a * 5 + 1) & _MASK
    out = x.clone()
    out[:, :128] = x[:, :128] + acc * 0.0
    return dict(out=out, a=_i32(a), acc=acc)


def _vec(x, iters, shape):
    rows, cols = shape
    v = x[:rows, :cols]
    acc = v * 0.0
    for _ in range(iters):
        t = fma32(acc, _GROW, v)
        t = torch.minimum(torch.maximum(t, v * 0.5), v * 2.0 + acc)
        acc = fma32(-(acc * v), _DAMP, t)
    out = x.clone()
    out[:rows, :cols] = v + acc * 0.0
    return dict(out=out, acc=acc)


def _when(x, iters):
    dev = x.device
    tab = torch.full((256,), INT32_MIN, dtype=torch.int64, device=dev)  # signed values
    a = torch.tensor(1, dtype=torch.int64, device=dev)
    for _ in range(iters):
        slot = (a & 255).reshape(1)
        tab.index_copy_(0, slot, torch.where((a & 1) == 0, _i32(a).to(torch.int64),
                                             tab.index_select(0, slot)))
        a = (a * 5 + 1) & _MASK
    carry = _i32(a + tab[0]).to(torch.float32)
    return dict(out=x + carry * 0.0, a=_i32(a), tab=tab.to(torch.int32))


def _reduce(x, iters):
    a = torch.tensor(1, dtype=torch.int64, device=x.device)
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        m = (x + s).max()
        s = fma32(m, _FEED, s)
        a = (a * 5 + 1) & _MASK
    return dict(out=x + s * 0.0 + _i32(a).to(torch.float32) * 0.0, a=_i32(a), s=s)


def _dynwin(x, iters):
    big = x[:, :128].repeat(8, 1)  # (64, 128): row r is x[r % 8, :128]
    rows = torch.arange(8, dtype=torch.int64, device=x.device)
    a = torch.tensor(1, dtype=torch.int64, device=x.device)
    for _ in range(iters):
        window = (a & 7) * 8 + rows
        big.index_copy_(0, window, big.index_select(0, window) * _SCALE)
        a = (a * 5 + 1) & _MASK
    out = x.clone()
    out[0:1, :128] = x[0:1, :128] + big[0:1, :] * 0.0 + _i32(a).to(torch.float32) * 0.0
    return dict(out=out, a=_i32(a), big=big)


def _cond(x, iters):
    a = torch.tensor(1, dtype=torch.int64, device=x.device)
    b = torch.tensor(0, dtype=torch.int64, device=x.device)
    for _ in range(iters):
        b = torch.where((a & 1) == 0, b + 1, b - 1) & _MASK
        a = (a * 5 + 1) & _MASK
    return dict(out=x + _i32(a + b).to(torch.float32) * 0.0, a=_i32(a), b=_i32(b))


_PLAIN = {"scalar": _scalar, "dynrow": _dynrow, "assemble": _assemble, "when": _when,
          "reduce": _reduce, "dynwin": _dynwin, "cond": _cond}


def run_plain(name: str, x: torch.Tensor, iters: int) -> dict:
    """The plain PyTorch twin of primitive ``name`` on the (8, 512) float32
    ``x`` for ``iters`` iterations: {"out": (8, 512), and each carry}."""
    prim = PRIMITIVES[name]
    if prim.kernel == "vec":
        return _vec(x, iters, prim.shape)
    return _PLAIN[name](x, iters)


# For each kernel: the int32 carries it writes (the `when` table after `a`)
# and the float32 carry's shape, or None.
_INTS = {"scalar": ("a", "b"), "dynrow": ("a",), "assemble": ("a",), "vec": (),
         "when": ("a",), "reduce": ("a",), "dynwin": ("a",), "cond": ("a", "b")}
_FLOATS = {"dynrow": ("acc", (1, 128)), "assemble": ("acc", (8, 128)), "reduce": ("s", ()),
           "dynwin": ("big", (64, 128))}


def run(name: str, x: torch.Tensor, iters: int) -> dict:
    """Primitive ``name`` for ``iters`` iterations: the CUDA kernel for a
    CUDA ``x`` (counted in LAUNCHES as ``micro_<kernel>``), the plain twin
    for a CPU ``x``. Returns what :func:`run_plain` returns."""
    if x.device.type == "cpu":
        return run_plain(name, x, iters)
    prim = PRIMITIVES[name]
    _build.check_cuda("x", x, torch.float32, (ROWS, COLS))
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    names = _INTS[prim.kernel]
    ints = torch.empty(len(names) + (256 if name == "when" else 0), dtype=torch.int32,
                       device=x.device)
    if prim.kernel == "vec":
        fname, fshape = "acc", prim.shape
    else:
        fname, fshape = _FLOATS.get(prim.kernel, (None, (0,)))
    floats = torch.empty(fshape, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    rows, cols = prim.shape or (0, 0)
    _build.launch(f"ptsf_micro_{prim.kernel}", x.data_ptr(), out.data_ptr(),
                  ints.data_ptr(), floats.data_ptr() if floats.numel() else None,
                  int(iters), rows, cols, label=f"micro_{prim.kernel}")
    result = dict(out=out, **{n: ints[i] for i, n in enumerate(names)})
    if name == "when":
        result["tab"] = ints[1:]
    if fname is not None:
        result[fname] = floats
    return result
