"""The port's a-trous iteration and temporal blend against the JAX package's
XLA ops (the CUDA wrappers run their plain versions on CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    atrous as jatrous,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import RenderConfig
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    atrous as tatrous,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    atrous as cuda_atrous,
)

torch.set_num_threads(1)

CFG = RenderConfig(width=48, height=32, wavelet_iterations=3)
H, W = CFG.height, CFG.width


def _inputs(seed: int, h: int = H, w: int = W):
    """Seeded HDR color, piecewise-constant unit normals (so the normal
    weight is neither 0 nor 1 everywhere), depth, history and lambda."""
    r = np.random.default_rng(seed)
    color = r.exponential(0.5, (h, w, 3)).astype(np.float32)
    blocks = r.normal(size=(4, 4, 3))
    blocks /= np.linalg.norm(blocks, axis=-1, keepdims=True)
    normal = np.repeat(np.repeat(blocks, -(-h // 4), 0), -(-w // 4), 1)[:h, :w]
    normal = (normal + 0.05 * r.normal(size=(h, w, 3))).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = r.uniform(0.9, 1.0, (h, w)).astype(np.float32)
    prev = r.exponential(0.5, (h, w, 3)).astype(np.float32)
    lam = r.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    py = r.integers(0, h, (h, w)).astype(np.int32)
    px = r.integers(0, w, (h, w)).astype(np.int32)
    return color, normal, depth, prev, lam, py, px


@pytest.mark.parametrize("k", range(1, 10))
def test_atrous_iteration_matches_xla(k):
    color, normal, depth, *_ = _inputs(k)
    want = jatrous.atrous_iteration(jnp.asarray(color), jnp.asarray(normal),
                                    jnp.asarray(depth), k, CFG)
    got = tatrous.atrous_iteration(torch.from_numpy(color), torch.from_numpy(normal),
                                   torch.from_numpy(depth), k, CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_atrous_filter_matches_xla():
    color, normal, depth, *_ = _inputs(0)
    want = jatrous.atrous_filter(jnp.asarray(color), jnp.asarray(normal), jnp.asarray(depth), CFG)
    got = cuda_atrous.atrous_filter(torch.from_numpy(color), torch.from_numpy(normal),
                                    torch.from_numpy(depth), CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frame_idx", [0, 4])
@pytest.mark.parametrize("adaptive", [False, True])
def test_temporal_blend_matches_xla(frame_idx, adaptive):
    cfg = RenderConfig(width=W, height=H, adaptive_alpha=adaptive)
    color, _, _, prev, lam, py, px = _inputs(100 + frame_idx)
    want = jatrous.temporal_accumulate_at(
        jnp.asarray(color), jnp.asarray(prev), jnp.asarray(py), jnp.asarray(px),
        jnp.int32(frame_idx), jnp.asarray(lam), cfg,
    )
    got = cuda_atrous.temporal_blend(
        torch.from_numpy(color), torch.from_numpy(prev), torch.from_numpy(py),
        torch.from_numpy(px), frame_idx, torch.from_numpy(lam), cfg,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_luminance_matches_xla():
    color = _inputs(9)[0]
    np.testing.assert_allclose(
        tatrous.luminance(torch.from_numpy(color)).numpy(),
        np.asarray(jatrous.luminance(jnp.asarray(color))), rtol=1e-6, atol=1e-6)
