"""Device introspection: what the card is, and what the kernels can hold.

The port's counterpart of the JAX package's ``utils/device.py``
(``device_info``, ``log_device_info``). Besides the card's name, count and
memory it reports the card's power limit (``nvidia-smi``: a card set below
its maximum runs slower under load, so every timing names it) and the
largest scenes the dense kernels' shared-memory tables hold.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Any

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    geometry as cuda_geometry,
    pathtrace as cuda_pathtrace,
)


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when it is asked for a card and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the card; pass device='cpu' "
                           "(--device cpu) to run the plain versions on the CPU")
    return dev


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_name(device=None) -> str:
    """The card's name, or ``cpu``."""
    dev = resolve(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_info(device=None) -> dict[str, Any]:
    """Capabilities of ``device`` (default: the card)."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    info: dict[str, Any] = {
        "backend": dev.type,
        "platform": "gpu" if on_card else "cpu",
        "num_devices": torch.cuda.device_count() if on_card else 1,
        "device_kind": device_name(dev),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        # triangles the dense kernels' shared-memory tables hold; larger
        # scenes walk the LBVH (ops/intersect.BVH_MIN_TRIANGLES)
        "geometry_table_cap": cuda_geometry.MAX_TRIANGLES,
        "trace_table_cap": cuda_pathtrace.MAX_TRIANGLES,
    }
    if on_card:
        props = torch.cuda.get_device_properties(dev)
        info["bytes_limit"] = props.total_memory
        info["bytes_in_use"] = torch.cuda.memory_allocated(dev)
        info["multiprocessors"] = props.multi_processor_count
        if shutil.which("nvidia-smi"):
            info["power_limit"] = card_line().rsplit(",", 1)[-1].strip()
    return info


def log_device_info(device=None) -> str:
    info = device_info(device)
    line = (f"[tpu-pathtracer torch] {info['num_devices']}x {info['device_kind']} "
            f"({info['platform']}, torch {info['torch_version']}, CUDA {info['cuda_version']}"
            + (f", {info['power_limit']}" if "power_limit" in info else "") + ")")
    print(line)
    return line
