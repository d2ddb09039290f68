"""The port's PCG generator against ops/rng.py: bit-equal states and words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.ops import rng as jrng
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import rng as trng

torch.set_num_threads(1)

N = 10_000


@pytest.fixture(scope="module")
def states():
    return np.random.default_rng(7).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)


def _t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.astype(np.int64))


def test_seed_per_pixel_bit_equal():
    r = np.random.default_rng(11)
    px = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    py = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    for frame, batch in ((0, 0), (7, 0), (123456, 3), (2**31 - 1, 65535)):
        want = np.asarray(jrng.seed_per_pixel(jnp.asarray(px), jnp.asarray(py), frame, batch))
        got = trng.seed_per_pixel(_t(px), _t(py), frame, batch).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_pcg_step_bit_equal(states):
    js, jt = jnp.asarray(states), _t(states)
    for _ in range(4):  # a few steps along each stream
        js, ju = jrng.pcg_step(js)
        jt, tu = trng.pcg_step(jt)
        np.testing.assert_array_equal(jt.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_random_gaussian_and_sphere(states):
    js, ggx, ggy = jrng.random_gaussian(jnp.asarray(states))
    ts, tgx, tgy = trng.random_gaussian(_t(states))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(ggx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(ggy), rtol=1e-6, atol=1e-6)

    js, jv = jrng.random_unit_sphere(jnp.asarray(states))
    ts, tv = trng.random_unit_sphere(_t(states))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
