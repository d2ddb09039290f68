"""The port's row-sharded frame (parallel/) on four gloo ranks on the CPU,
held to the JAX package: its halo exchange and reprojection against a
global edge pad and gather, its frames against the goldens and the port's
single-device frame and the JAX package's sharded frame, its byte ledger
against the JAX CommLedger of the same config on a four-device mesh, and
its config checks against the JAX package's."""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.config import (
    RenderConfig as JaxConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.parallel import (
    frame_sharded as jframe_sharded,
    sharding as jsharding,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.procedural import (
    subdivided_cornell as jsubdivided_cornell,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    Camera as JaxCamera,
    Light as JaxLight,
    Scene as JaxScene,
    precompute_triangle_data as jprecompute,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import RenderConfig, Scene
from real_time_path_tracing_with_spatiotemporal_filtering_torch.parallel import (
    frame_sharded,
    sharding,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame as tframe
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.procedural import (
    subdivided_cornell,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
    precompute_triangle_data,
)

torch.set_num_threads(1)

RANKS = 4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FRAME_CFG = RenderConfig(width=48, height=32, max_bounces=6, wavelet_iterations=3, backend="xla")
# tests/test_sharding.py's CFG
CFG = RenderConfig(width=64, height=48, max_bounces=5, wavelet_iterations=3)
ORBIT = (0.0, 0.02, 0.04, 1.5)  # orbit steps, then a cut


def _spawn(fn, *args, tmp_path):
    return sharding.spawn(fn, RANKS, *args, backend="gloo", device="cpu", workdir=str(tmp_path))


def _orbit(angles, light_dx=0.0):
    light = Light.default()
    poses = []
    for i, a in enumerate(angles):
        moved = dataclasses.replace(light, position=light.position + torch.tensor(
            [light_dx * i, 0.0, 0.0]))
        poses.append((Camera.orbit([0.0, 1.0, 0.0], 6.0, a, 1.0), moved))
    return poses


def _single_device(scene, cfg, poses):
    """The port's single-device kernel-route frame (plain versions on the
    CPU): each frame and the last history."""
    td = precompute_triangle_data(scene, "cpu")
    hist = tframe.init_history(td, cfg)
    frames = []
    for cam, light in poses:
        rgb, hist = tframe._render_frame_kernels(td, cam, light, hist, cfg)
        frames.append(rgb)
    return frames, hist


def _jax_config(cfg) -> JaxConfig:
    return JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)})


def _jax_ledger(cfg, cornell_tri_data):
    """The JAX package's CommLedger of ``cfg`` on a RANKS-device mesh, by
    tracing its sharded frame (tests/test_sharding.py's eval_shape)."""
    jcfg = _jax_config(cfg)
    ledger = jsharding.CommLedger()
    step = jframe_sharded.make_sharded_frame(jcfg, jsharding.make_mesh(RANKS),
                                             comm_ledger=ledger)
    hist = jax.eval_shape(lambda: jframe.init_history(cornell_tri_data, jcfg))
    cam = JaxCamera.orbit([0.0, 1.0, 0.0], 6.0, 0.02, height=1.0)
    jax.eval_shape(step, cornell_tri_data, cam, JaxLight.default(), hist)
    return _ledger_counts(ledger)


def _ledger_counts(ledger) -> dict:
    return {"halo_bytes": ledger.halo_bytes, "reproj_halo_bytes": ledger.reproj_halo_bytes,
            "gather_fallback_bytes": ledger.gather_fallback_bytes}


def _jax_sharded(tri_data, cfg, angles, light_dx):
    """The JAX package's sharded frame (make_sharded_frame on a RANKS-device
    mesh) over the orbit of :func:`_orbit`: each frame, its ledger's static
    counts and the all-gather bytes of each frame."""
    jcfg = _jax_config(cfg)
    ledger = jsharding.CommLedger()
    mesh = jsharding.make_mesh(RANKS)
    step = jframe_sharded.make_sharded_frame(jcfg, mesh, comm_ledger=ledger)
    hist = jframe_sharded.init_sharded_history(tri_data, jcfg, mesh)
    light = JaxLight.default()
    frames, gathered = [], []
    for i, a in enumerate(angles):
        shift = jnp.array([light_dx * i, 0.0, 0.0])
        moved = dataclasses.replace(light, position=light.position + shift)
        rgb, hist, comm = step(tri_data, JaxCamera.orbit([0.0, 1.0, 0.0], 6.0, a, height=1.0),
                               moved, hist)
        frames.append(np.asarray(rgb))
        gathered.append(int(comm["gather_bytes"]))
    return frames, _ledger_counts(ledger), gathered


def test_halo_exchange_and_reprojection(tmp_path):
    """exchange_row_halo at halo 1-4 equals a global edge pad and slice;
    reproject_rows_sharded equals a global gather in its window branch, its
    all-gather branch and a still frame (the identity)."""
    rng = np.random.default_rng(1234)
    h, w = 48, 16
    plane = torch.tensor(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    own_y = torch.arange(h)[:, None].expand(h, w)
    own_x = torch.arange(w)[None, :].expand(h, w)
    cases = {
        "window": ((own_y + torch.tensor(rng.integers(-4, 5, (h, w)))).clamp(0, h - 1),
                   (own_x + torch.tensor(rng.integers(-3, 4, (h, w)))).clamp(0, w - 1)),
        "gather": (torch.tensor(rng.integers(0, h, (h, w))),
                   torch.tensor(rng.integers(0, w, (h, w)))),
        "still": (own_y.clone(), own_x.clone()),
    }
    halos = (1, 2, 3, 4)
    got = _spawn(sharding.exchange_probe, plane, halos, list(cases.values()), tmp_path=tmp_path)
    local = h // RANKS
    for rank, out in enumerate(got):
        lo = rank * local
        for halo, padded in zip(halos, out["halo"]):
            rows = np.clip(np.arange(lo - halo, lo + local + halo), 0, h - 1)
            assert torch.equal(padded, plane[rows]), (rank, halo)
        assert out["window"] == [True, False, True]
        for (py, px), reproj in zip(cases.values(), out["reprojected"]):
            assert torch.equal(reproj, plane[py, px][lo: lo + local])


def test_sharded_frames_match_goldens(tmp_path):
    """The 4-rank frame after 3 frames equals frame3_48x32.npy and, variance
    guided, frame3_48x32_var.npy (the golden tolerance), and the port's
    single-device frame bit for bit."""
    scene = Scene.cornell_box()
    still = [(Camera.default(), Light.default())] * 3
    var_cfg = dataclasses.replace(FRAME_CFG, variance_guided=True)
    got = _spawn(frame_sharded.render_jobs, [(scene, FRAME_CFG, still), (scene, var_cfg, still)],
                 tmp_path=tmp_path)[0]
    for out, cfg, golden in zip(got, (FRAME_CFG, var_cfg), ("frame3_48x32", "frame3_48x32_var")):
        want = np.load(os.path.join(GOLDEN, f"{golden}.npy"))
        np.testing.assert_allclose(out["frames"][-1].numpy(), want, rtol=1e-5, atol=1e-6)
        frames, _ = _single_device(scene, cfg, still)
        assert all(torch.equal(a, b) for a, b in zip(out["frames"], frames))


EXTENSIONS = {
    "motion_then_cut": dict(adaptive_alpha=True, variance_guided=True),
    "ramp_normal": dict(variance_guided=True, accumulation_ramp=True, ramp_reset_mode="normal"),
    "demodulated": dict(demodulate_albedo=True, variance_guided=True),
    "path_gradient": dict(variance_guided=True, adaptive_alpha=True, accumulation_ramp=True,
                          path_gradient=True),
    "multires_gbuffer_jitter": dict(indirect_split=1, indirect_stride=4, gbuffer_primary=True,
                                    indirect_jitter=True),
    "nee_rr": dict(nee=True, rr_start_bounce=2, variance_guided=True),
}


def test_extensions_and_ledger(tmp_path, cornell_tri_data):
    """tests/test_sharding.py's CFG over 4 ranks under an orbit and a cut:
    each extension, and a 128-triangle scene on the LBVH route, equals the
    port's single-device frame bit for bit (frames and history) and the JAX
    package's sharded frame on a 4-device mesh at the golden tolerance
    (every frame); the ledger's static counts and each frame's all-gather
    bytes equal the JAX CommLedger's; steady frames gather nothing and the
    cut moves exactly the fallback. The ranks run while the JAX frames
    compile, four at a time."""
    cornell = Scene.cornell_box()
    jobs = [(cornell, dataclasses.replace(CFG, **flags), _orbit(ORBIT, 0.05))
            for flags in EXTENSIONS.values()]
    jobs.append((Scene.from_arrays(*subdivided_cornell(2)), CFG, _orbit(ORBIT[:2])))
    labels = list(EXTENSIONS) + ["lbvh_128"]
    jax_jobs = [(cornell_tri_data, cfg, ORBIT, 0.05) for _, cfg, _ in jobs[:-1]]
    jax_jobs.append((jprecompute(JaxScene.from_arrays(*jsubdivided_cornell(2))), CFG, ORBIT[:2],
                     0.0))
    with ThreadPoolExecutor(6) as pool:
        ranks = pool.submit(_spawn, frame_sharded.render_jobs, jobs, tmp_path=tmp_path)
        by_jax = pool.map(lambda job: _jax_sharded(*job), jax_jobs)
        single = list(pool.map(lambda job: _single_device(*job), jobs))
        by_jax = list(by_jax)
        got = ranks.result()
    for i, label in enumerate(labels):
        frames, hist = single[i]
        out = got[0][i]
        for a, b in zip(out["frames"], frames):
            assert torch.equal(a, b), label
        for name, plane in out["history"][-1].items():
            assert torch.equal(plane, getattr(hist, name)), (label, name)
        jax_frames, jax_ledger, jax_gathered = by_jax[i]
        for f, (a, want) in enumerate(zip(out["frames"], jax_frames)):
            np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{label} frame {f}")
        ledgers = {tuple(sorted(r[i]["ledger"].items())) for r in got}
        assert len(ledgers) == 1, label  # every rank counts the same
        comm = out["comm"]
        assert {c["halo_bytes"] for c in comm} == {out["ledger"]["halo_bytes"]}, label
        if len(out["comm"]) == len(ORBIT):
            assert [c["gather_bytes"] for c in comm[1:3]] == [0, 0], label
            assert comm[3]["gather_bytes"] == out["ledger"]["gather_fallback_bytes"], label
        assert out["ledger"] == jax_ledger, label
        assert [c["gather_bytes"] for c in comm] == jax_gathered, label
    # the JAX package's own counts at 48x32, variance guided with adaptive alpha
    assert _jax_ledger(dataclasses.replace(FRAME_CFG, adaptive_alpha=True, variance_guided=True),
                       cornell_tri_data) == {"halo_bytes": 26880, "reproj_halo_bytes": 7680,
                                             "gather_fallback_bytes": 23040}


def test_validation():
    """make_sharded_frame's four checks reject what the JAX package's
    reject, with its messages, and pass what it passes (no process group:
    only the group's size is read)."""
    cases = [
        (dict(height=10), 4, "divide evenly"),
        (dict(height=8), 4, "wavelet_iterations"),
        (dict(height=40, adaptive_alpha=True, path_gradient=True), 8, "gradient_stratum"),
        (dict(indirect_split=1, indirect_stride=5), 4, "indirect_stride"),
        (dict(indirect_split=1, indirect_stride=4, path_gradient=True, adaptive_alpha=True), 4,
         None),
    ]
    for flags, ranks, match in cases:
        cfg = dataclasses.replace(CFG, **flags)
        group = sharding.RowGroup(0, ranks, torch.device("cpu"), "gloo")
        jcfg = _jax_config(cfg)
        mesh = jsharding.make_mesh(ranks)
        if match is None:
            frame_sharded.make_sharded_frame(cfg, group)
            jframe_sharded.make_sharded_frame(jcfg, mesh)
            continue
        with pytest.raises(ValueError, match=match):
            frame_sharded.make_sharded_frame(cfg, group)
        with pytest.raises(ValueError, match=match):
            jframe_sharded.make_sharded_frame(jcfg, mesh)
