"""What the redesigned trace kernels rely on, checked on the CPU.

The dense trace kernel reads its triangles from the table that
ops/cuda/pathtrace.pack_table packs, at the offsets csrc/bounce.cuh
(DenseTable) reads: the table must hold exactly the planes, normals and
albedo the plain tracer uses. The segment kernel runs only the live ray
slots, in the order a live list gives them: running the plain segment on
the live slots alone, gathered in a shuffled order and scattered back, must
give the bits of the plain segment over all slots, and leave the dead slots
untouched.
"""

import numpy as np
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Camera,
    Light,
    RenderConfig,
    Scene,
    precompute_triangle_data,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import intersect
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    pathtrace as cuda_pathtrace,
    wavefront as cuda_wavefront,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import procedural

torch.set_num_threads(1)

# the column offsets csrc/bounce.cuh DenseTable reads
ROW = {"n": 0, "d0": 3, "n1": 4, "d1": 7, "n2": 8, "d2": 11, "v0": 12, "e1": 15, "e2": 18,
       "normals": 21, "albedo": 24}


def test_dense_table_unpacks_to_the_plain_tracers_tables():
    td = precompute_triangle_data(Scene.cornell_box())
    table = cuda_pathtrace.pack_table(td)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert tuple(table.shape) == (td.num_triangles, cuda_pathtrace.ROW_FLOATS) == (32, 27)
    for name, at in ROW.items():
        want = getattr(td, name) if name in ("normals", "albedo") else getattr(td.planes, name)
        want = want.reshape(td.num_triangles, -1)
        assert torch.equal(table[:, at:at + want.shape[1]], want), name
    # 128-byte shared-memory rows, and room for every scene the dense
    # kernels take (the LBVH takes over at BVH_MIN_TRIANGLES)
    assert cuda_pathtrace.SHARED_ROW_FLOATS * 4 == 128
    assert cuda_pathtrace.MAX_TRIANGLES >= intersect.BVH_MIN_TRIANGLES - 1
    assert 18 * 4 + 128 * cuda_pathtrace.MAX_TRIANGLES <= 48 * 1024


def test_segment_on_live_slots_equals_segment_on_all_slots():
    cfg = RenderConfig(width=24, height=16, max_bounces=6, nee=True, rr_start_bounce=1)
    td = precompute_triangle_data(Scene.from_arrays(*procedural.subdivided_cornell(2)))
    assert intersect.uses_bvh(td)
    cam, light = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.03, 1.0), Light.default()
    n = cfg.width * cfg.height
    rays = cuda_wavefront.RayState.empty(n, "cpu")
    rng = np.random.default_rng(20261017)
    for seg in range(4):
        if seg >= 1:
            live = torch.nonzero(rays.alive != 0).squeeze(1)
            assert 0 < live.numel() < n
            before = cuda_wavefront.RayState(*(t.clone() for t in rays))
            full = cuda_wavefront.RayState(*(t.clone() for t in rays))
            cuda_wavefront.trace_segment_plain(full, seg, 0, 1, td, cam.position, cam.rotation,
                                               light, 3, cfg)
            slots = live[torch.from_numpy(rng.permutation(live.numel()))]
            sub = cuda_wavefront.RayState(rays.f[:, slots].contiguous(), rays.state[slots].clone(),
                                          rays.alive[slots].clone())
            cuda_wavefront.trace_segment_plain(sub, seg, 0, 1, td, cam.position, cam.rotation,
                                               light, 3, cfg)
            gathered = cuda_wavefront.RayState(*(t.clone() for t in rays))
            gathered.f[:, slots] = sub.f
            gathered.state[slots] = sub.state
            gathered.alive[slots] = sub.alive
            for a, b, name in zip(gathered, full, cuda_wavefront.RayState._fields):
                assert torch.equal(a, b), (seg, name)
            dead = rays.alive == 0
            for a, b, name in zip(full, before, cuda_wavefront.RayState._fields):
                assert torch.equal(a[..., dead], b[..., dead]), (seg, name)
        cuda_wavefront.trace_segment_plain(rays, seg, 0, 1, td, cam.position, cam.rotation,
                                           light, 3, cfg)
