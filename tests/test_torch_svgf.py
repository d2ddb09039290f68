"""The port's SVGF helpers (variance-guided a-trous, moments, the
accumulation ramp, albedo demodulation) against the JAX package's XLA ops,
on seeded inputs. The CUDA wrappers run their plain versions on CPU
tensors."""

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

CFG = RenderConfig(width=48, height=32, wavelet_iterations=3, variance_guided=True,
                   accumulation_ramp=True)
H, W = CFG.height, CFG.width
# The golden tolerance of tests/test_golden.py (measured: every element of
# these inputs stays inside it).
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed: int, h: int = H, w: int = W) -> dict:
    """Seeded HDR color, variance, piecewise-constant unit normals (so the
    normal weight is neither 0 nor 1 everywhere), depth, history planes,
    lambda and a random backprojection."""
    r = np.random.default_rng(seed)
    blocks = r.normal(size=(4, 4, 3))
    blocks /= np.linalg.norm(blocks, axis=-1, keepdims=True)
    normal = np.repeat(np.repeat(blocks, -(-h // 4), 0), -(-w // 4), 1)[:h, :w]
    normal = normal + 0.05 * r.normal(size=(h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    vis = r.integers(0, 5, (h, w)).astype(np.float32)
    return dict(
        color=r.exponential(0.5, (h, w, 3)).astype(np.float32),
        var=(0.1 * r.random((h, w))).astype(np.float32),
        normal=normal.astype(np.float32),
        depth=r.uniform(0.9, 1.0, (h, w)).astype(np.float32),
        prev=r.exponential(0.5, (h, w, 3)).astype(np.float32),
        moments=r.exponential(0.5, (h, w, 2)).astype(np.float32),
        age=r.integers(0, 40, (h, w)).astype(np.float32),
        vis=vis,
        prev_vis=np.where(r.random((h, w)) < 0.8, vis, vis + 1).astype(np.float32),
        lam=(r.uniform(0.0, 1.0, (h, w)) ** 3).astype(np.float32),
        py=r.integers(0, h, (h, w)).astype(np.int32),
        px=r.integers(0, w, (h, w)).astype(np.int32),
        albedo=r.choice([0.0, 0.7, 1.0], (h, w, 3)).astype(np.float32),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_atrous_iteration_var_matches_xla(k):
    x = _inputs(k)
    want_c, want_v = jatrous.atrous_iteration_var(
        _j(x["color"]), _j(x["var"]), _j(x["normal"]), _j(x["depth"]), k, CFG)
    got_c, got_v = cuda_atrous.atrous_iteration_var(
        _t(x["color"]), _t(x["var"]), _t(x["normal"]), _t(x["depth"]), k, CFG)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)


def test_atrous_filter_var_matches_xla():
    x = _inputs(4)
    want_c, want_v = jatrous.atrous_filter_var(
        _j(x["color"]), _j(x["var"]), _j(x["normal"]), _j(x["depth"]), CFG)
    got_c, got_v = cuda_atrous.atrous_filter_var(
        _t(x["color"]), _t(x["var"]), _t(x["normal"]), _t(x["depth"]), CFG)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)


def test_atrous_filter_var_matches_pallas():
    """The plain filter against the TPU kernel in interpret mode, at the
    size (128x32) and the tolerance of tests/test_variance.py: the kernel
    multiplies by reciprocals where the port divides. Three iterations, as
    the other tests here run (each stride is one more interpret-mode
    compile, ~2 s)."""
    from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops.pallas import (
        atrous as atrous_pl,
    )

    cfg = RenderConfig(width=128, height=32, variance_guided=True, wavelet_iterations=3)
    assert atrous_pl.supported(cfg.height, cfg.width, cfg)
    x = _inputs(11, cfg.height, cfg.width)
    want_c, want_v = atrous_pl.atrous_filter_var_pallas(
        _j(x["color"]), _j(x["var"]), _j(x["normal"]), _j(x["depth"]), cfg, interpret=True)
    got_c, got_v = tatrous.atrous_filter_var(
        _t(x["color"]), _t(x["var"]), _t(x["normal"]), _t(x["depth"]), cfg)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("frame_idx", [0, 2, 5])
def test_accumulate_moments_matches_xla(frame_idx):
    """Frames 0 and 2 take the 5x5 spatial variance, frame 5 the temporal
    one (variance_boost_frames = 4)."""
    x = _inputs(20 + frame_idx)
    lum = x["color"][..., 1]
    want_m, want_v = jatrous.accumulate_moments(
        _j(lum), _j(x["moments"]), _j(x["py"]), _j(x["px"]), jnp.int32(frame_idx), CFG)
    got_m, got_v = tatrous.accumulate_moments(
        _t(lum), _t(x["moments"]), _t(x["py"]), _t(x["px"]), frame_idx, CFG)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)


def test_normal_class_matches_xla():
    x = _inputs(30)
    want = jatrous.normal_class(_j(x["normal"]), _j(x["vis"]))
    got = tatrous.normal_class(_t(x["normal"]), _t(x["vis"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["id", "normal"])
def test_accumulate_age_matches_xla(mode):
    x = _inputs(40)
    if mode == "normal":
        prev = np.asarray(jatrous.normal_class(_j(x["normal"][::-1].copy()), _j(x["prev_vis"])))
        cur = np.asarray(jatrous.normal_class(_j(x["normal"]), _j(x["vis"])))
    else:
        prev, cur = x["prev_vis"], x["vis"]
    for frame_idx in (0, 3):
        want = jatrous.accumulate_age(
            _j(x["age"]), _j(x["py"]), _j(x["px"]), _j(x["lam"]), jnp.int32(frame_idx), CFG,
            prev_vis=_j(prev), cur_vis=_j(cur))
        got = tatrous.accumulate_age(
            _t(x["age"]), _t(x["py"]), _t(x["px"]), _t(x["lam"]), frame_idx, CFG,
            _t(prev), _t(cur))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("adaptive", [False, True])
def test_ramp_alpha_matches_xla(adaptive):
    cfg = RenderConfig(width=W, height=H, accumulation_ramp=True, adaptive_alpha=adaptive)
    x = _inputs(50)
    age = x["age"] + 1.0
    want = jatrous.ramp_alpha(_j(age), _j(x["lam"]), cfg)
    got = tatrous.ramp_alpha(_t(age), _t(x["lam"]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_demodulation_matches_xla():
    """albedo_image, demod_scale, demodulate and modulate."""
    from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
        Scene as JaxScene,
        precompute_triangle_data as jax_tables,
    )
    from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
        Scene,
        precompute_triangle_data,
    )

    x = _inputs(60)
    vis = np.random.default_rng(60).integers(0, 33, (H, W)).astype(np.float32)
    want_alb = jatrous.albedo_image(jax_tables(JaxScene.cornell_box()), _j(vis))
    got_alb = tatrous.albedo_image(precompute_triangle_data(Scene.cornell_box()), _t(vis))
    np.testing.assert_array_equal(got_alb.numpy(), np.asarray(want_alb))
    want_s = jatrous.demod_scale(_j(x["albedo"]), CFG)
    got_s = tatrous.demod_scale(_t(x["albedo"]), CFG)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    want_d = jatrous.demodulate(_j(x["color"]), want_s)
    got_d = tatrous.demodulate(_t(x["color"]), got_s)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    np.testing.assert_allclose(tatrous.modulate(got_d, got_s).numpy(),
                               np.asarray(jatrous.modulate(want_d, want_s)), **TOL)


@pytest.mark.parametrize("mode", ["id", "normal"])
def test_ramp_blend_matches_xla(mode):
    """temporal_accumulate_at(age=) after accumulate_age, which the ramp
    blend kernel fuses (its CPU path is the plain version)."""
    cfg = RenderConfig(width=W, height=H, accumulation_ramp=True, adaptive_alpha=True,
                       ramp_reset_mode=mode)
    x = _inputs(70)
    for frame_idx in (0, 3):
        age = jatrous.accumulate_age(
            _j(x["age"]), _j(x["py"]), _j(x["px"]), _j(x["lam"]), jnp.int32(frame_idx), cfg,
            prev_vis=_j(x["prev_vis"]), cur_vis=_j(x["vis"]))
        want = jatrous.temporal_accumulate_at(
            _j(x["color"]), _j(x["prev"]), _j(x["py"]), _j(x["px"]), jnp.int32(frame_idx),
            _j(x["lam"]), cfg, age=age)
        got, got_age = cuda_atrous.temporal_blend_ramp(
            _t(x["color"]), _t(x["prev"]), _t(x["py"]), _t(x["px"]), frame_idx,
            _t(x["lam"]), _t(x["age"]), _t(x["prev_vis"]), _t(x["vis"]), cfg)
        np.testing.assert_array_equal(got_age.numpy(), np.asarray(age))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
