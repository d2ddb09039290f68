"""The frame function: the whole reference frame over a History.

The reference runs four GPU passes per frame (main.cpp:1090-1113):

    visibility G-buffer -> temporal gradient -> path trace -> a-trous+EMA

:func:`render_frame_impl` runs them one of two ways. The plain route calls
the PyTorch versions in ops/ on any device; it is the reference the kernels
are held against. The kernel route runs four hand-written CUDA kernels
(ops/cuda/): the fused geometry pass (G-buffer, gradient and backprojected
pixel coordinates), the path tracer, nine a-trous iterations and the
temporal blend, which gathers the history at the geometry kernel's
coordinates.
"""

from __future__ import annotations

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    atrous,
    camera as cam_ops,
    gbuffer,
    gradient,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    atrous as cuda_atrous,
    geometry as cuda_geometry,
    pathtrace as cuda_pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.history import (
    History,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
    TriangleData,
)

# Extensions of the JAX package this package does not run yet, each with the
# ROADMAP item that ports it: (field, value that leaves it off, item).
_UNPORTED = (
    ("nee", False, "Queue 1 item 6"),
    ("rr_start_bounce", 0, "Queue 1 item 6"),
    ("truncate_radiance", False, "Queue 1 item 6"),
    ("demodulate_albedo", False, "Queue 1 item 6"),
    ("variance_guided", False, "Queue 1 item 6"),
    ("accumulation_ramp", False, "Queue 1 item 6"),
    ("firefly_clamp", 0.0, "Queue 1 item 6"),
    ("gbuffer_primary", False, "Queue 1 item 7"),
    ("path_gradient", False, "Queue 1 item 8"),
    ("indirect_split", 0, "Queue 1 item 8"),
)


def check_supported(cfg: RenderConfig, model=None) -> None:
    """Raise NotImplementedError naming the first enabled extension that
    this package does not run yet, and its ROADMAP item."""
    for field, off, item in _UNPORTED:
        if getattr(cfg, field) != off:
            raise NotImplementedError(
                f"RenderConfig.{field} is not ported to the PyTorch package "
                f"yet (ROADMAP {item})"
            )
    if model is not None:
        raise NotImplementedError(
            "the per-frame model matrix is not ported to the PyTorch package "
            "yet (ROADMAP Queue 1 item 9)"
        )


def use_kernels(cfg: RenderConfig, device: torch.device) -> bool:
    """Whether the frame takes the CUDA kernel route (cfg.backend)."""
    if cfg.backend == "xla":
        return False
    on_cuda = device.type == "cuda"
    if cfg.backend == "pallas" and not on_cuda:
        raise ValueError(
            "backend='pallas' runs the CUDA kernels and needs tensors on a "
            f"CUDA device, got {device}"
        )
    return on_cuda


def camera_matrices(camera, cfg: RenderConfig):
    """The reference's per-frame UBO matrices (main.cpp:1463-1475): the view
    (translate-only in the reference; general camera->world basis here) and
    glm::perspective(2*FOV) with the Vulkan y flip. Accepts a Camera or a
    bare (3,) position (the reference's lookAt)."""
    if isinstance(camera, Camera):
        view = cam_ops.camera_view(camera.position, camera.rotation)
    else:
        view = cam_ops.reference_view(camera)
    proj = cam_ops.vulkan_perspective(
        cfg.fov * 2.0, cfg.width / cfg.height, cfg.near, cfg.far,
        device=view.device,
    )
    return view, proj


def render_frame_impl(
    tri_data: TriangleData,
    camera: Camera,
    light: Light,
    history: History,
    cfg: RenderConfig,
    model=None,
):
    """One frame: (triangle tables, camera, light, history) -> (rgb, history').

    Pass order matches drawScene (main.cpp:1104-1110). Returns the final
    denoised (H, W, 3) image and the next frame's history.
    """
    check_supported(cfg, model)
    if use_kernels(cfg, tri_data.lut.device):
        return _render_frame_kernels(tri_data, camera, light, history, cfg)
    frame_idx = history.frame
    view, proj = camera_matrices(camera, cfg)

    # -- pass 1: visibility G-buffer (replaces visibility.{vert,geom,frag}) --
    gbuf = gbuffer.visibility_pass(
        tri_data, camera.position, view, proj, cfg, rotation=camera.rotation
    )
    # -- pass 2: temporal gradient (temporalGradient.comp.glsl) --
    lam = gradient.temporal_gradient_pass(
        gbuf, tri_data.lut, history.lut, camera.position, light.position,
        history.light_pos, light.color, history.light_color,
    )
    # -- pass 3: path trace (raytrace.comp.glsl) --
    normal_img = tri_data.lut_normals[gbuf.visibility.to(torch.int64)]
    noisy = pathtrace.path_trace_pass(
        tri_data, camera.position, light, frame_idx, cfg, rotation=camera.rotation
    )
    # -- pass 4: a-trous filter + temporal EMA (temporalFiltering.comp.glsl) --
    filtered = atrous.atrous_filter(noisy, normal_img, gbuf.depth, cfg)
    rgb = atrous.temporal_accumulate(
        filtered, history.image, gbuf, history.lut, history.view,
        history.proj, frame_idx, lam, cfg,
    )
    return rgb, _next_history(rgb, gbuf.visibility, tri_data, view, proj, light, frame_idx)


def _render_frame_kernels(tri_data, camera, light, history, cfg: RenderConfig):
    """The kernel route: fused geometry kernel, path-trace kernel, nine
    a-trous launches, blend kernel. On CPU tensors each wrapper runs its
    plain version, which the tests use to check this wiring."""
    frame_idx = history.frame
    view, proj = camera_matrices(camera, cfg)
    geo = cuda_geometry.geometry_pass(
        tri_data, history.lut, camera.position, camera.rotation,
        light.position, history.light_pos, light.color, history.light_color,
        view, proj, history.view, history.proj, cfg,
    )
    noisy = cuda_pathtrace.path_trace_pass(
        tri_data, camera.position, light, frame_idx, cfg, camera.rotation
    )
    filtered = cuda_atrous.atrous_filter(noisy, geo.normal, geo.depth, cfg)
    rgb = cuda_atrous.temporal_blend(
        filtered, history.image, geo.prev_y, geo.prev_x, frame_idx, geo.lam, cfg
    )
    return rgb, _next_history(rgb, geo.visibility, tri_data, view, proj, light, frame_idx)


def _next_history(rgb, visibility, tri_data, view, proj, light, frame_idx) -> History:
    """The reference's end-of-frame blits (main.cpp:1361-1372)."""
    return History(
        image=rgb,
        visibility=visibility,
        lut=tri_data.lut,
        view=view,
        proj=proj,
        light_pos=light.position,
        light_color=light.color,
        frame=frame_idx + 1,
    )


render_frame = render_frame_impl


def init_history(tri_data: TriangleData, cfg: RenderConfig, device=None) -> History:
    """Frame-0 history on ``device`` (default: the tables' device).

    Previous matrices start equal to the current ones (main.cpp:486-489);
    the image/visibility planes start at zero (frame 0 skips blending,
    temporalFiltering.comp.glsl:251-259, so their values never leak). The
    previous LUT starts as the current LUT -- the reference leaves that
    buffer uninitialized on frame 0 and nothing consumes it before frame 1.
    """
    check_supported(cfg)
    device = tri_data.lut.device if device is None else torch.device(device)
    camera = Camera.default(device)
    light = Light.default(device)
    view, proj = camera_matrices(camera.position, cfg)
    return History(
        image=torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=device),
        visibility=torch.zeros((cfg.height, cfg.width), dtype=torch.float32, device=device),
        lut=tri_data.lut.to(device),
        view=view,
        proj=proj,
        light_pos=light.position,
        light_color=light.color,
        frame=0,
    )
