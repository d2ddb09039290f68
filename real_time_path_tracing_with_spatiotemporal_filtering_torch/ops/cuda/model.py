"""The per-frame model matrix on the card: the moved scene's tables and the
refit of its LBVH.

:func:`transform_triangle_data` moves a scene's rest-pose tables by a model
matrix in up to two launches of ``csrc/model.cu``: :func:`transform_tables`
(every table and the LBVH's test rows, one thread a triangle) and
:func:`bvh_refit` (the rest pose's tree with its boxes recomputed, one
thread a leaf, bottom-up; left out when the frame walks no tree). The move
reads nothing back to the host. On CPU tensors each wrapper runs its plain
version.
"""

from __future__ import annotations

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.camera import mat_apply
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import lbvh, scene

# the tables transform_tables writes, in the order of its entry point
TABLES = ("lut", "v0", "e1", "e2", "n", "d0", "n1", "d1", "n2", "d2", "normals", "albedo",
          "lut_normals", "tests")
bvh_refit_plain = lbvh.refit_nodes_plain


def transform_tables_plain(tri_data, model) -> tuple[dict, torch.Tensor]:
    """The plain version of :func:`transform_tables`: the moved tables
    (scene/scene.triangle_tables) and the largest |coordinate| of the moved
    vertices."""
    model = scene.model_matrix(model, tri_data.lut.device)
    tris = mat_apply(model[:3], tri_data.lut[1:])
    return scene.triangle_tables(tris), tris.abs().amax()


def transform_tables(tri_data, model) -> tuple[dict, torch.Tensor]:
    """The tables of the scene moved by ``model`` ((4, 4) or (3, 4), on the
    tables' device), keyed as scene/scene.triangle_tables keys them, in one
    launch; and the (1 + rows,) int32 workspace of :func:`bvh_refit`: the
    bits of the moved vertices' largest |coordinate|, then the node rows'
    arrival counters, zeroed. Plain version for CPU tensors."""
    model = scene.model_matrix(model, tri_data.lut.device)
    t = tri_data.num_triangles
    rows = tri_data.bvh.nodes.shape[0]
    if tri_data.lut.device.type == "cpu":
        tables, coord_max = transform_tables_plain(tri_data, model)
        return tables, torch.cat([coord_max.reshape(1).view(torch.int32),
                                  torch.zeros(rows, dtype=torch.int32)])
    _build.check_cuda("lut", tri_data.lut, torch.float32, (t + 1, 3, 3))
    _build.check_cuda("model", model, torch.float32, model.shape)
    dev = tri_data.lut.device
    shapes = dict(lut=(t + 1, 3, 3), d0=(t,), d1=(t,), d2=(t,), lut_normals=(t + 1, 3),
                  tests=(t, lbvh.TRI_WORDS))
    out = {k: torch.empty(shapes.get(k, (t, 3)), dtype=torch.float32, device=dev)
           for k in TABLES}
    workspace = torch.empty(1 + rows, dtype=torch.int32, device=dev)
    _build.launch("ptsf_transform_tables", tri_data.lut.data_ptr(), model.data_ptr(), t, rows,
                  *(out[k].data_ptr() for k in TABLES), workspace.data_ptr(),
                  label="transform_tables")
    return out, workspace


def bvh_refit(bvh: lbvh.PackedBVH, lut: torch.Tensor, workspace: torch.Tensor) -> torch.Tensor:
    """The node table of ``bvh``'s tree over the moved ``lut``, in one
    launch; ``workspace`` is :func:`transform_tables`' of that move. Plain
    version for CPU tensors."""
    if lut.device.type == "cpu":
        return bvh_refit_plain(bvh, lut[1:])
    t = bvh.tris.shape[0]
    rows = bvh.nodes.shape[0]
    _build.check_cuda("bvh.nodes", bvh.nodes, torch.float32, (rows, lbvh.NODE_WORDS))
    _build.check_cuda("leaf_slot", bvh.plan.leaf_slot, torch.int32, (t,))
    _build.check_cuda("row_slot", bvh.plan.row_slot, torch.int32, (rows,))
    _build.check_cuda("lut", lut, torch.float32, (t + 1, 3, 3))
    _build.check_cuda("workspace", workspace, torch.int32, (1 + rows,))
    nodes = torch.empty_like(bvh.nodes)
    _build.launch("ptsf_bvh_refit", bvh.nodes.data_ptr(), bvh.plan.leaf_slot.data_ptr(),
                  bvh.plan.row_slot.data_ptr(), lut.data_ptr(), workspace.data_ptr(), t,
                  nodes.data_ptr(), label="bvh_refit")
    return nodes


def transform_triangle_data(tri_data, model, refit: bool = True):
    """scene/scene.transform_triangle_data by :func:`transform_tables` and,
    with ``refit``, :func:`bvh_refit`."""
    tables, workspace = transform_tables(tri_data, model)
    nodes = bvh_refit(tri_data.bvh, tables["lut"], workspace) if refit else tri_data.bvh.nodes
    return scene.from_tables(tables, tri_data.bvh._replace(nodes=nodes, tris=tables["tests"]))
