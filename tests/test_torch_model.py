"""The per-frame model matrix in the port (scene/scene.transform_triangle_data,
the refit of the LBVH, Renderer.set_model) against the JAX package's
transform_triangle_data and its jitted frame with ``model=``.

The scene rotates about the vertical axis through (0, 1, 0), 0.08 rad a
frame, as in tests/test_model.py, at 64x48 with 4 bounces. At 128
triangles (subdivided_cornell(2)) the port walks the rest pose's tree with
its boxes refitted, and the JAX package's moved tables route dense: its
dense frame is the oracle.
"""

import jax.numpy as jnp
import numpy as np
import torch

import real_time_path_tracing_with_spatiotemporal_filtering_tpu as jx
from chip_smoke import MODEL_STEP as STEP, model_rotation as rotation
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    transform_triangle_data as jax_transform,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.utils import image as jimage
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Renderer,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import intersect
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame as tframe
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import lbvh, procedural
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    transform_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils import image
from test_torch_estimators import assert_nee_matches

torch.set_num_threads(1)

CFG = dict(width=64, height=48, max_bounces=4)


def _tables(td) -> dict:
    """Every table of a TriangleData, the node table as its bits (its child
    ids are NaN as floats)."""
    out = {f: getattr(td.planes, f) for f in td.planes._fields}
    out.update(normals=td.normals, albedo=td.albedo, lut=td.lut, lut_normals=td.lut_normals,
               bvh_tris=td.bvh.tris, bvh_nodes=td.bvh.nodes.view(torch.int32))
    return out


def _frames_against_jax(verts, idx, frames):
    """``frames`` frames of the rotating scene through Renderer.set_model on
    the plain route, each held to the jitted JAX frame with ``model=`` by
    the golden criterion; returns the port's renderer."""
    r = Renderer(Scene.from_arrays(verts, idx), RenderConfig(**CFG), device="cpu")
    jtd = jx.precompute_triangle_data(jx.Scene.from_arrays(verts, idx))
    jcfg = jx.RenderConfig(**CFG)
    hist = jframe.init_history(jtd, jcfg)
    for f in range(frames):
        m = rotation(STEP * (f + 1))
        want, hist = jframe.render_frame(jtd, jx.Camera.default(), jx.Light.default(), hist,
                                         jcfg, jnp.asarray(m))
        r.set_model(m)
        got = r.step().numpy()
        assert_nee_matches(got, np.asarray(want))
        assert image.rmse(got, np.asarray(want)) < 1e-5
    return r


def test_identity_model_bit_identical():
    """model = identity gives the rest pose's tables (LBVH included) and 3
    frames bit-identical to no model."""
    td = precompute_triangle_data(Scene.cornell_box(), "cpu")
    moved = _tables(transform_triangle_data(td, np.eye(4, dtype=np.float32)))
    for name, rest in _tables(td).items():
        assert torch.equal(moved[name], rest), name
    plain = Renderer(Scene.cornell_box(), RenderConfig(**CFG), device="cpu")
    still = Renderer(Scene.cornell_box(), RenderConfig(**CFG), device="cpu")
    still.set_model(torch.eye(4))
    for _ in range(3):
        assert torch.equal(still.step(), plain.step())


def test_moved_tables_match_jax():
    """The moved tables against the JAX package's transform_triangle_data:
    within rtol 1e-5 / atol 1e-6 (a few ulps: XLA on the CPU contracts the
    einsum's and the cross products' a*b + c into FMAs, the port rounds
    twice), the re-keyed albedo exactly; and utils/image equals the JAX
    package's."""
    jtd = jx.precompute_triangle_data(jx.Scene.cornell_box())
    td = precompute_triangle_data(Scene.cornell_box(), "cpu")
    m = rotation(np.pi / 2)
    want, got = jax_transform(jtd, jnp.asarray(m)), transform_triangle_data(td, m)
    for f in got.planes._fields:
        np.testing.assert_allclose(getattr(got.planes, f).numpy(),
                                   np.asarray(getattr(want.planes, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    for f in ("normals", "lut", "lut_normals"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.albedo.numpy(), np.asarray(want.albedo))
    red = td.albedo[:, 0] > 0.99  # former +x walls face -z after a quarter turn
    assert red.any() and not (got.albedo[red, 0] > 0.99).any()

    rng = np.random.default_rng(7)
    a = rng.exponential(0.5, (6, 5, 3)).astype(np.float32)
    b = rng.exponential(0.5, (6, 5, 3)).astype(np.float32)
    assert image.rmse(torch.from_numpy(a), b) == jimage.rmse(a, b)
    np.testing.assert_array_equal(image.tonemap(torch.from_numpy(a)), jimage.tonemap(a))


def test_rotating_box_matches_jax(monkeypatch):
    """3 frames of the rotating Cornell box (dense, 32 triangles) against
    the jitted JAX frame with model=: the history carries the moved LUT.
    On the kernel route's wiring (each wrapper's plain version on the CPU)
    the shadow walk of gbuffer_primary + nee reads the LBVH at any size, so
    the moved box's tree is refitted there and the frame equals the plain
    route's."""
    verts, idx = procedural.cornell_box()
    r = _frames_against_jax(verts, idx, 3)
    assert torch.equal(r.history.lut, transform_triangle_data(r.tri_data, rotation(3 * STEP)).lut)

    cfg = RenderConfig(width=32, height=24, max_bounces=3, gbuffer_primary=True, nee=True)
    r = Renderer(Scene.cornell_box(), cfg, device="cpu")
    args = (r.tri_data, r.camera, r.light, r.history, cfg)
    want, _ = tframe.render_frame_impl(*args, model=rotation(0.9))
    monkeypatch.setattr(tframe, "use_kernels", lambda cfg, device: True)
    got, _ = tframe.render_frame_impl(*args, model=rotation(0.9))
    assert torch.equal(got, want)


def test_refitted_lbvh_frames_match_jax():
    """At 128 triangles the moved scene walks the refitted tree: its node
    table equals the host's pack of the rest tree over the moved triangles
    bit for bit, the walk on it equals the dense test, and 2 frames match
    the JAX package's dense frame."""
    verts, idx = procedural.subdivided_cornell(2)
    td = precompute_triangle_data(Scene.from_arrays(verts, idx), "cpu")
    assert intersect.uses_bvh(td)
    moved = transform_triangle_data(td, rotation(2 * STEP))
    tris = moved.lut[1:].numpy()
    want = lbvh.pack_bvh_nodes(lbvh.refit_lbvh(lbvh.build_lbvh(verts[idx]), tris), tris)
    np.testing.assert_array_equal(moved.bvh.nodes.numpy().view(np.int32), want.view(np.int32))
    assert not torch.equal(moved.bvh.nodes.view(torch.int32), td.bvh.nodes.view(torch.int32))

    rng = np.random.default_rng(5)
    o = torch.tensor(rng.uniform(-1.5, 1.5, (2000, 3)).astype(np.float32) + np.float32([0, 1, 2]))
    d = torch.tensor(tris.mean(axis=1)[rng.integers(0, len(tris), 2000)]) - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dense = intersect.nearest_hit(moved.planes, o, d)
    walk = intersect.traverse(moved.bvh, o, d)
    assert dense.hit.double().mean() > 0.5
    for field in intersect.HitRecord._fields:
        assert torch.equal(getattr(walk, field), getattr(dense, field)), field
    _frames_against_jax(verts, idx, 2)
