"""What the a-trous kernels' edge-weight sharing relies on, checked on the CPU.

csrc/atrous.cu computes each edge's weight once: a pixel p keeps the
weights of its four forward taps (k,0), (0,k), (k,k), (k,-k), and its
backward tap -d reads the forward weight of p - d. That rests on two facts:

- the weight is symmetric bit for bit: the whole kHBox*((w_n*w_z)*w_l) of
  ops/atrous.atrous_iteration, and the prefix (kHBox*w_n)*w_z of
  atrous_iteration_var (whose w_l divides by p's own stddev);
- the backward tap is p - d's forward tap only where p - d lies in the
  image: elsewhere the tap is clamped and its weight is computed directly.

A model of that rule over whole planes must give the plain versions' bits
on a 13x37 image, where most taps clamp; the same model without the range
check must not.
"""

import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch import RenderConfig
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import camera as cam_ops

torch.set_num_threads(1)

CFG = RenderConfig()
H, W = 13, 37
FORWARD = ((1, 0), (0, 1), (1, 1), (1, -1))  # (x, y) offsets in units of k


def _inputs(seed):
    """Seeded color, variance, normals in patches of near-equal directions
    (some facing away) and depth with repeated values."""
    r = np.random.default_rng(seed)
    patch = ((np.arange(W)[None, :] // 5 + np.arange(H)[:, None] // 4) % 3)
    base = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.6, 0.0, -0.8]])[patch]
    normal = base + 0.02 * r.uniform(-1, 1, (H, W, 3))
    depth = np.where(r.random((H, W)) < 0.1, 2.0, 2.0 + 0.5 * r.uniform(-1, 1, (H, W)))
    arrays = (r.exponential(0.5, (H, W, 3)), 0.1 * r.random((H, W)), normal, depth)
    return tuple(torch.tensor(a.astype(np.float32)) for a in arrays)


def _pair(cp, np_, dp, cq, nq, dq):
    """The whole weight kHBox*((w_n*w_z)*w_l) and the variance-guided
    prefix (kHBox*w_n)*w_z of the pairs (p, q), as the plain versions
    compute them."""
    w_n = torch.pow(torch.clamp_min(cam_ops.dot3(np_, nq), 0.0), CFG.sigma_n)
    w_z = torch.exp(-torch.abs(dp - dq) / CFG.sigma_z)
    w_l = torch.exp(-cam_ops.norm3(cp - cq) / CFG.sigma_l)
    return atrous.H_BOX * (w_n * w_z * w_l), atrous.H_BOX * w_n * w_z


def _weights(color, normal, depth, k, check_range, var_prefix):
    """Tap (i, j) -> its weight plane under the sharing rule: the whole
    weight, or the variance-guided prefix."""

    def direct(i, j):
        q = (atrous.shift_clamped(t, j * k, i * k) for t in (color, normal, depth))
        return _pair(color, normal, depth, *q)[var_prefix]

    fwd = {d: direct(*d) for d in FORWARD}
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    taps = {}
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            if (i, j) in fwd:
                taps[i, j] = fwd[i, j]
            elif (i, j) == (0, 0):
                taps[i, j] = direct(0, 0)
            else:  # backward: the forward weight of p - d, read at p + (i, j) k
                qy, qx = ys + j * k, xs + i * k
                reused = fwd[-i, -j][qy.clamp(0, H - 1), qx.clamp(0, W - 1)]
                inside = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
                taps[i, j] = torch.where(inside, reused, direct(i, j)) if check_range else reused
    return taps


def _model_iteration(color, normal, depth, k, check_range=True):
    taps = _weights(color, normal, depth, k, check_range, var_prefix=False)
    num, den = torch.zeros_like(color), torch.zeros_like(depth)
    for (i, j), hw in taps.items():  # x offset outer, y offset inner
        num = num + hw[..., None] * atrous.shift_clamped(color, j * k, i * k)
        den = den + hw
    return num / den[..., None]


def _model_iteration_var(color, var, normal, depth, k, check_range=True):
    taps = _weights(color, normal, depth, k, check_range, var_prefix=True)
    lp = atrous.luminance(color)
    denom_l = atrous._f32(CFG.sigma_l) * torch.sqrt(atrous._gauss3(var)) + atrous._f32(
        CFG.variance_eps)
    num, vnum, den = torch.zeros_like(color), torch.zeros_like(var), torch.zeros_like(depth)
    for (i, j), pre in taps.items():
        cq = atrous.shift_clamped(color, j * k, i * k)
        hw = pre * torch.exp(-torch.abs(lp - atrous.luminance(cq)) / denom_l)
        num = num + hw[..., None] * cq
        vnum = vnum + hw * hw * atrous.shift_clamped(var, j * k, i * k)
        den = den + hw
    return num / den[..., None], vnum / (den * den)


def test_edge_weights_are_symmetric():
    p, q = _inputs(1), _inputs(2)
    pq = _pair(p[0], p[2], p[3], q[0], q[2], q[3])
    qp = _pair(q[0], q[2], q[3], p[0], p[2], p[3])
    assert torch.equal(pq[0], qp[0]) and torch.equal(pq[1], qp[1])


@pytest.mark.parametrize("k", [1, 4, 9])
def test_reuse_rule_matches_the_plain_iterations(k):
    color, var, normal, depth = _inputs(10 + k)
    assert torch.equal(_model_iteration(color, normal, depth, k),
                       atrous.atrous_iteration(color, normal, depth, k, CFG))
    got = _model_iteration_var(color, var, normal, depth, k)
    want = atrous.atrous_iteration_var(color, var, normal, depth, k, CFG)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # reusing p - d's weight where the tap clamps gives other bits
    assert not torch.equal(_model_iteration(color, normal, depth, k, check_range=False),
                           atrous.atrous_iteration(color, normal, depth, k, CFG))
    assert not torch.equal(_model_iteration_var(color, var, normal, depth, k,
                                                check_range=False)[0], want[0])
