"""The port's estimators (next-event estimation, Russian roulette,
truncate_radiance, several samples per pixel) and the variance-guided frame
against the JAX package's golden snapshots and its XLA tracer."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import (
    pathtrace as jpathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    Camera as JaxCamera,
    Light as JaxLight,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    Light,
    Renderer,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    pathtrace as tpathtrace,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_CFG = RenderConfig(width=48, height=32, max_bounces=6, wavelet_iterations=3,
                          backend="xla")
TOL = dict(rtol=1e-5, atol=1e-6)


def assert_nee_matches(got, want):
    """Criterion for NEE images, the golden criterion of chip_smoke.py: at
    least 99.5% of the elements inside rtol 1e-5 / atol 1e-6, mean abs
    error <= 1e-4, and every element inside rtol 1e-4. XLA on the CPU
    contracts a*b + c into one FMA, PyTorch rounds twice; NEE's solid angle
    2 pi (1 - cos theta_max) turns that ulp of cos theta_max into ~1e-5
    relative error (measured: 1 element of the 48x32x3 golden, 2.0e-5)."""
    got, want = np.asarray(got), np.asarray(want)
    inside = np.isclose(got, want, **TOL).mean()
    assert inside >= 0.995, inside
    assert np.abs(got - want).mean() <= 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _trace(cfg, frame_idx):
    td = precompute_triangle_data(Scene.cornell_box())
    cam, light = Camera.default(), Light.default()
    return tpathtrace.path_trace_pass(td, cam.position, light, frame_idx, cfg,
                                      rotation=cam.rotation).numpy()


def test_nee_trace_matches_golden():
    """tests/test_nee.py's snapshot (48x32, nee, frame 7)."""
    golden = np.load(os.path.join(GOLDEN, "pathtrace_48x32_f7_nee.npy"))
    assert_nee_matches(_trace(dataclasses.replace(GOLDEN_CFG, nee=True), 7), golden)


def test_rr_trace_matches_golden():
    """tests/test_rr.py's snapshot (48x32, rr_start_bounce=2, frame 7), at
    its tolerance (measured: every element inside it)."""
    golden = np.load(os.path.join(GOLDEN, "pathtrace_48x32_f7_rr2.npy"))
    np.testing.assert_allclose(
        _trace(dataclasses.replace(GOLDEN_CFG, rr_start_bounce=2), 7), golden, **TOL)


def test_variance_guided_frame_matches_golden():
    """tests/test_golden.py's variance-guided 3-frame snapshot (measured:
    every element inside its tolerance)."""
    r = Renderer(Scene.cornell_box(), dataclasses.replace(GOLDEN_CFG, variance_guided=True),
                 device="cpu")
    golden = np.load(os.path.join(GOLDEN, "frame3_48x32_var.npy"))
    np.testing.assert_allclose(r.render(3).numpy(), golden, **TOL)


@pytest.mark.parametrize(
    "overrides",
    [dict(truncate_radiance=True),
     dict(nee=True, spp=2, sample_batches=2),
     dict(nee=True, rr_start_bounce=2, light_through_walls=False)],
    ids=["truncate_radiance", "nee_spp2_batches2", "nee_rr"],
)
def test_trace_matches_xla(cornell_tri_data, overrides):
    cfg = dataclasses.replace(RenderConfig(width=48, height=32, max_bounces=6), **overrides)
    want = np.asarray(jpathtrace.path_trace_pass(
        cornell_tri_data, JaxCamera.default().position, JaxLight.default(), jnp.int32(3), cfg))
    got = _trace(cfg, 3)
    if cfg.nee:
        assert_nee_matches(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)
