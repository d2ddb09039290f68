"""Counter-based per-pixel PRNG, bit-exact with the reference.

The reference seeds one PCG-style hash stream per pixel from
(pixel, frameNumber, sample_batch) and steps it sequentially along the path
(raytrace.comp.glsl:71-92, 297). The state is a tensor of any shape; every
step advances all lanes at once.

All arithmetic wraps mod 2**32 exactly as in GLSL. PyTorch's CPU kernels do
not implement ``+`` or ``>>`` on uint32, and int32 ``>>`` is an arithmetic
shift, so states are carried as int64 holding the uint32 value: every
product and sum is masked back to 32 bits (int64 wrap-around keeps the low
32 bits right), which also keeps the right shifts logical. The CUDA kernels
use native ``uint32_t`` and give the same words.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF

# GLSL float(word) / 4294967295.0f (raytrace.comp.glsl:77): a multiply by
# the float32 reciprocal, not a divide. Python floats holding exact float32
# values, so a float32 tensor op uses them unchanged.
_INV_U32_MAX = float(np.float32(1.0 / 4294967295.0))
TWO_PI = float(np.float32(2.0 * 3.14159265))  # k_pi (raytrace.comp.glsl:80)
# max(1e-38, u1) in random_gaussian: subnormal in float32, so a flush-to-zero
# build would turn it into log(0)
_U1_FLOOR = float(np.float32(1e-38))


def _u32(x) -> torch.Tensor:
    """An integer tensor or Python int as int64 holding its uint32 value."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def seed_per_pixel(px, py, frame, batch) -> torch.Tensor:
    """Per-pixel stream seed (raytrace.comp.glsl:297).

    ``px``/``py`` integer pixel coordinate tensors (any broadcastable
    shape); ``frame``/``batch`` integer scalars. Returns int64 states in
    [0, 2**32).
    """
    px = _u32(px)
    py = _u32(py)
    s = (px * 3266489917 + py * 668265263) & _MASK
    f = (int(frame) * 374761393) & _MASK
    b = (int(batch) * 2654435761) & _MASK
    return s ^ f ^ b


def pcg_step(state):
    """One pcg_output_rxs_m_xs_32_32 step (raytrace.comp.glsl:71-78).

    Returns (new_state, uniform float32 in [0, 1]).
    """
    state = (state * 747796405 + 1) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) * _INV_U32_MAX


def random_gaussian(state):
    """Box-Muller 2D standard normal (raytrace.comp.glsl:84-92).

    Returns (new_state, gx, gy). Draw order (u1 then u2) matches the
    reference so sequences stay aligned.
    """
    state, u1 = pcg_step(state)
    state, u2 = pcg_step(state)
    u1 = torch.clamp_min(u1, _U1_FLOOR)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI * u2
    return state, r * torch.cos(theta), r * torch.sin(theta)


def random_unit_sphere(state):
    """Uniform point on the unit sphere via (theta, u) (raytrace:256-259).

    Draw order (theta first, then u) matches the reference bounce sampler.
    Returns (new_state, (..., 3) vector).
    """
    state, a = pcg_step(state)
    state, b = pcg_step(state)
    theta = TWO_PI * a
    u = 2.0 * b - 1.0
    r = torch.sqrt(torch.clamp_min(1.0 - u * u, 0.0))
    vec = torch.stack([r * torch.cos(theta), r * torch.sin(theta), u], dim=-1)
    return state, vec


def sample_jitter(px, py, frame, batch, sample):
    """The AA jitter of sample ``sample`` of batch ``batch``: the pixel's
    seed advanced past the earlier samples' jitter draws (two each: the
    path of a sample runs on a copy, raytrace.comp.glsl:200), then
    :func:`random_gaussian`. Returns (state, gx, gy) as the tracer's sample
    loop has them."""
    state = seed_per_pixel(px, py, frame, batch)
    for _ in range(2 * sample):
        state = (state * 747796405 + 1) & _MASK
    return random_gaussian(state)


def to_int32_bits(state: torch.Tensor) -> torch.Tensor:
    """int64 states in [0, 2**32) as int32 tensors of the same bits (the
    CUDA kernels' uint32 words)."""
    return (state - ((state >> 31) << 32)).to(torch.int32)


def from_int32_bits(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_int32_bits`."""
    return bits.to(torch.int64) & _MASK
