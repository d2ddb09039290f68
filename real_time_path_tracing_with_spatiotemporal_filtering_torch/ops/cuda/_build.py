"""Build and load the CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all at once, and
linked into one shared library with a plain C interface, loaded with ctypes. The build happens at first
use, into ``_build/`` beside the package (listed in ``.gitignore``), under a
name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Flags: ``sm_90a`` (Hopper). No ``--use_fast_math`` and no flush-to-zero:
the Box-Muller clamp ``max(1e-38, u1)`` is subnormal in float32 and would
flush to 0 (``log(0)`` = inf radiance). ``--fmad=false`` keeps ``a*b + c``
as two roundings, the way the plain PyTorch version computes it, so kernel
and plain version agree bit for bit where their operations agree.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler", "-fPIC",
    "--fmad=false",
    "-Xptxas", "-v",
]

# Launches of each kernel, counted by its wrapper right after a launch it
# made succeeded (never for the plain version). ``LAUNCHES.clear()`` resets.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None
build_log = ""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libptsf_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if their library is missing; returns its path.
    One nvcc per source, all started together, then one link."""
    global build_log
    out = _library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    procs = [
        subprocess.Popen([_nvcc(), *compile_flags, "-c", "-I", CSRC, "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources(), objs)
    ]
    build_log = "".join(proc.communicate()[0] for proc in procs)
    try:
        failed = [proc.returncode for proc in procs if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)
    return out


def signatures() -> dict:
    """The argument types of each C entry point of the library, by name."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return {
        # table, num_tris, params, width, height, slope, t_max, eps,
        # vis, depth, normal, lam, prev_y, prev_x, world, albedo,
        # out_albedo (null: no albedo planes), vis_only, counts (null: not
        # counted), stream
        "ptsf_geometry": [p, i, p, i, i, f, f, f, p, p, p, p, p, p, p, p, p, i, p, p],
        # table, num_tris, params, width, height, frame, max_bounces, spp,
        # batches, slope, aa_sigma, ray_eps, t_max, eps, light_r, light_r2,
        # first_dim, light_through_walls, nee, rr_start, rr_min, rr_max,
        # truncate, fetch, out, tests_out, path_len, lanes (all three null:
        # not counted), stream
        "ptsf_trace": [p, i, p, i, i, i, i, i, i, f, f, f, f, f, f, f, f, i, i, i, f, f, i,
                       p, p, p, p, p, p],
        # color_in, normal, depth, color_out, width, height, k, sigma_n,
        # sigma_z, sigma_l, stream
        "ptsf_atrous_iter": [p, p, p, p, i, i, i, f, f, f, p],
        # color_in, var_in, normal, depth, color_out, var_out, width, height,
        # k, sigma_n, sigma_z, sigma_l, variance_eps, stream
        "ptsf_atrous_iter_var": [p, p, p, p, p, p, i, i, i, f, f, f, f, p],
        # filtered, prev_image, prev_y, prev_x, lam, out, width, height,
        # alpha, adaptive, frame, stream
        "ptsf_temporal_blend": [p, p, p, p, p, p, i, i, f, i, i, p],
        # filtered, prev_image, prev_y, prev_x, lam, prev_age, prev_cons,
        # cur_cons, out, age_out, width, height, alpha_min, reset_lam,
        # age_cap, adaptive, frame, stream
        "ptsf_temporal_blend_ramp": [p, p, p, p, p, p, p, p, p, p, i, i, f, f, f, i, i, p],
        # nodes, tris, v0, e1, e2, lut_normals, lut, lut_prev, params, width,
        # height, slope, t_max, eps, vis, depth, normal, lam, prev_y, prev_x,
        # world, albedo, out_albedo (null: none), vis_only, counts,
        # seen_node, seen_tri (all three null: not counted), lanes (null:
        # not counted), stream
        "ptsf_geometry_bvh": [p] * 9 + [i, i, f, f, f] + [p] * 9 + [i] + [p] * 4 + [p],
        # nodes, tris, v0, e1, e2, normals, albedo, params, n, width, height,
        # frame, batch, sample, seg, slope, aa_sigma, ray_eps, t_max, eps,
        # light_r, light_r2, first_dim, light_through_walls, nee, rr_start,
        # rr_min, rr_max, px, py (both null: ray i is pixel i of the frame),
        # live_in (null: every slot), live_in_ctr, live_out, live_out_ctr,
        # live_zero_ctr, rays, state, alive, counts, seen_node,
        # seen_tri (all three null: not counted), lanes (null: not counted),
        # stream
        "ptsf_trace_segment": [p] * 8 + [i] * 7 + [f] * 8 + [i] * 3 + [f, f] + [p] * 14 + [p],
        # nodes, tris, origins, dirs, cap, mask, n, width (0: the rays are
        # in no frame order), t_max, eps, occluded, counts, seen_node,
        # seen_tri (all three null: not counted), lanes (null: not
        # counted), stream
        "ptsf_shadow_segment": [p] * 6 + [i, i, f, f] + [p] * 5 + [p],
        # rest_lut, model, num_tris, num_rows, lut, v0, e1, e2, n, d0, n1, d1,
        # n2, d2, normals, albedo, lut_normals, tests, workspace, stream
        "ptsf_transform_tables": [p, p, i, i] + [p] * 15 + [p],
        # rest_nodes, leaf_slot, row_slot, lut, workspace, num_tris, nodes,
        # stream
        "ptsf_bvh_refit": [p] * 5 + [i, p, p],
        # the micro-kernels (ops/cuda/micro.py): x, out, ints, floats (null
        # where the kernel has none), iters, rows, cols (vec only), stream
        **{f"ptsf_micro_{k}": [p, p, p, p, i, i, i, p]
           for k in ("scalar", "dynrow", "assemble", "vec", "when", "reduce", "dynwin", "cond")},
    }


def _declare(lib) -> None:
    for name, argtypes in signatures().items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
    return _lib


def launch(name: str, *args, label: str | None = None) -> None:
    """Call C entry point ``name`` on the current stream; raise on a CUDA
    error from the launch, and count the launch under ``label`` (default:
    the entry point's name without its prefix)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[label or name.removeprefix("ptsf_")] += 1


def check_cuda(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
