"""The frame function: the whole reference frame over a History.

The reference runs four GPU passes per frame (main.cpp:1090-1113):

    visibility G-buffer -> temporal gradient -> path trace -> a-trous+EMA

:func:`render_frame_impl` runs them one of two ways. The plain route calls
the PyTorch versions in ops/ on any device; it is the reference the kernels
are held against. The kernel route runs hand-written CUDA kernels
(ops/cuda/): the fused geometry pass (G-buffer, gradient, backprojected
pixel coordinates and optional albedo planes), the path tracer, nine
a-trous iterations (variance-guided under cfg.variance_guided) and the
temporal blend (with the accumulation ramp under cfg.accumulation_ramp),
which gathers the history at the geometry kernel's coordinates. The path
gradient's re-trace and the multi-res split's traces run on the segment
tracer's explicit-pixel mode; their gathers, box filter and upsample stay
plain PyTorch on the card, as the JAX package leaves them to XLA. A
per-frame model matrix moves the scene's tables first, on the kernel route
by the two kernels of ops/cuda/model.py.
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
    intersect,
    multires,
    pathgrad,
    pathtrace,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import (
    atrous as cuda_atrous,
    geometry as cuda_geometry,
    model as cuda_model,
    pathtrace as cuda_pathtrace,
    wavefront as cuda_wavefront,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.history import (
    History,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
    TriangleData,
    transform_triangle_data,
)


def walks_tree(tri_data: TriangleData, cfg: RenderConfig, kernels: bool) -> bool:
    """Whether the frame reads the scene's LBVH: from BVH_MIN_TRIANGLES on
    (ops/intersect.uses_bvh), and on the kernel route at any size wherever
    the segment tracer runs, whose kernels always walk it (gbuffer_primary,
    indirect_split, path_gradient)."""
    return intersect.uses_bvh(tri_data) or (
        kernels and (cfg.gbuffer_primary or bool(cfg.indirect_split) or cfg.path_gradient))


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


def trace_noisy(tri_data: TriangleData, camera: Camera, light: Light, frame_idx,
                cfg: RenderConfig, kernels: bool, primary=None, **slab) -> torch.Tensor:
    """The frame's full-resolution noisy radiance (H, W, 3) outside
    cfg.indirect_split: on the plain route (``kernels`` false) the plain
    tracer; on the kernel route the segment tracer on scenes that walk the
    LBVH and wherever a G-buffer ``primary`` seeds bounce 0, else the trace
    kernel. benchmarks/quality traces its truth and its raw frame through
    it, unseeded. ``slab``: row_offset and rows of a row slab (the sharded
    frame, parallel/)."""
    if not kernels:
        return pathtrace.path_trace_pass(tri_data, camera.position, light, frame_idx, cfg,
                                         rotation=camera.rotation, primary=primary, **slab)
    if primary is not None or intersect.uses_bvh(tri_data):
        return cuda_wavefront.path_trace_wavefront(tri_data, camera.position, light, frame_idx,
                                                   cfg, camera.rotation, primary=primary, **slab)
    return cuda_pathtrace.path_trace_pass(tri_data, camera.position, light, frame_idx, cfg,
                                          camera.rotation, **slab)


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
    denoised (H, W, 3) image and the next frame's history. The plain route
    mirrors the JAX package's XLA frame (pipeline/frame.py there), including
    its SVGF and estimator extensions.

    ``model``: optional (4, 4) or (3, 4) per-frame model matrix (the
    reference's UBO model slot, visibility.vert.glsl:22-24), applied to the
    rest pose's tables before anything else (scene.transform_triangle_data;
    on the kernel route the two kernels of ops/cuda/model.py). The history
    then carries the moved LUT, so reprojection and the temporal gradient
    follow the motion, as the reference's modelPrev would
    (main.cpp:1465-1469). Scenes keep their route: a frame that walks the
    LBVH (:func:`walks_tree`) walks the rest pose's tree, refitted.
    """
    kernels = use_kernels(cfg, tri_data.lut.device)
    if model is not None:
        move = cuda_model.transform_triangle_data if kernels else transform_triangle_data
        tri_data = move(tri_data, model, refit=walks_tree(tri_data, cfg, kernels))
    if kernels:
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
    py = px = None
    if cfg.variance_guided or cfg.accumulation_ramp or cfg.path_gradient:
        py, px = atrous.backproject_pixels(gbuf, history.lut, history.view,
                                           history.proj, cfg)
    if cfg.path_gradient:
        # A-SVGF: re-trace last frame's samples under the current light;
        # max() with the Phong proxy (their blind spots are disjoint)
        lam = torch.maximum(lam, pathgrad.path_gradient_pass(
            tri_data, light, frame_idx, cfg, history.noisy_lum, history.cam_pos,
            history.cam_rot, py, px, gbuf.visibility, history.visibility,
        ))
    # -- pass 3: path trace (raytrace.comp.glsl) --
    normal_img = tri_data.lut_normals[gbuf.visibility.to(torch.int64)]
    primary = None
    if cfg.gbuffer_primary:
        # bounce 0 replayed off the G-buffer; the trace starts at segment 1
        primary = (gbuf.visibility, gbuf.world_pos, normal_img,
                   atrous.albedo_image(tri_data, gbuf.visibility))
    if cfg.indirect_split:
        # full-res truncated trace + coarse full-length trace, upsampled
        noisy = multires.multires_noisy(
            tri_data, camera.position, light, frame_idx, cfg, normal_img, gbuf.depth,
            rotation=camera.rotation, primary=primary,
        )
    else:
        noisy = trace_noisy(tri_data, camera, light, frame_idx, cfg, False, primary)
    # before the clamp: the re-trace next frame is unclamped
    noisy_lum = atrous.luminance(noisy) if cfg.path_gradient else None
    if cfg.firefly_clamp:
        noisy = torch.clamp_max(noisy, cfg.firefly_clamp)
    # -- pass 4: a-trous filter + temporal EMA (temporalFiltering.comp.glsl) --
    demod_s = None
    if cfg.demodulate_albedo:
        # filter irradiance, not radiance: the history is carried
        # demodulated, only the returned image is re-modulated
        demod_s = atrous.demod_scale(atrous.albedo_image(tri_data, gbuf.visibility), cfg)
        noisy = atrous.demodulate(noisy, demod_s)
    age = cls_cur = None
    if cfg.accumulation_ramp:
        prev_cons, cur_cons, cls_cur = _consistency_planes(history, normal_img,
                                                           gbuf.visibility, cfg)
        age = atrous.accumulate_age(history.age, py, px, lam, frame_idx, cfg,
                                    prev_cons, cur_cons)
    moments = None
    if cfg.variance_guided:
        moments, var = atrous.accumulate_moments(
            atrous.luminance(noisy), history.moments, py, px, frame_idx, cfg
        )
        filtered, _ = atrous.atrous_filter_var(noisy, var, normal_img, gbuf.depth, cfg)
    else:
        filtered = atrous.atrous_filter(noisy, normal_img, gbuf.depth, cfg)
    if py is not None:
        rgb = atrous.temporal_accumulate_at(
            filtered, history.image, py, px, frame_idx, lam, cfg, age=age
        )
    else:
        rgb = atrous.temporal_accumulate(
            filtered, history.image, gbuf, history.lut, history.view,
            history.proj, frame_idx, lam, cfg,
        )
    new_history = _next_history(rgb, gbuf.visibility, tri_data, view, proj, light, camera,
                                frame_idx, cfg, moments, age, cls_cur, noisy_lum)
    if demod_s is not None:
        return atrous.modulate(rgb, demod_s), new_history
    return rgb, new_history


class FrameRows:
    """The rows a kernel-route frame renders (:func:`_render_frame_kernels`)
    and how it reads the rows around them. This one is the whole frame: its
    filters clamp at the frame's edges themselves (halo 0), and its history
    gathers read the previous frame's planes where they are.
    parallel/frame_sharded.SlabRows is one rank's row slab instead, which
    exchanges the neighbour rows it reads."""

    row_offset = 0
    rows = None  # the frame's

    def halo(self, k: int) -> int:
        """The neighbour rows a side a stride-k filter reads from :meth:`pad`
        (ops/cuda/atrous.atrous_filter, the variance estimate): none here,
        the kernels clamp at the frame's edge."""
        return 0

    def pad(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """``x`` with ``k`` neighbour rows on each side, the edge row
        repeated at the frame's top and bottom."""
        if k == 0:
            return x
        edge = (k, *x.shape[1:])
        return torch.cat([x[:1].expand(edge), x, x[-1:].expand(edge)])

    def backprojected(self, prev_y: torch.Tensor) -> None:
        """Told the frame's backprojection before the first history gather."""

    def source(self, plane: torch.Tensor) -> tuple:
        """(source, row0): the history ``plane`` as the frame gathers it, the
        source holding the frame's rows from global row row0 on."""
        return plane, 0


WHOLE_FRAME = FrameRows()


def _render_frame_kernels(tri_data, camera, light, history, cfg: RenderConfig,
                          slab: FrameRows = WHOLE_FRAME):
    """The kernel route, in the order of the JAX package's Pallas frame:
    fused geometry kernel (dense or LBVH; with albedo planes under
    demodulate_albedo or gbuffer_primary), path-trace kernel (one launch,
    or the segment tracer on large scenes, under gbuffer_primary and under
    indirect_split), firefly clamp, demodulation, the path gradient's
    re-trace (segment tracer, explicit pixels), moments at the geometry
    kernel's backprojection, nine a-trous launches (variance-guided or
    not), blend kernel (ramp or not), re-modulation. On CPU tensors each
    wrapper runs its plain version, which the tests use to check this
    wiring.

    ``slab``: the rows it renders (:class:`FrameRows`), by default the
    whole frame; the history's image planes and the result are those rows.
    The sharded frame (parallel/frame_sharded.py) renders a rank's slab
    through it, with the halo exchanges of the JAX package's sharded frame
    in its order."""
    frame_idx = history.frame
    view, proj = camera_matrices(camera, cfg)
    rows = dict(row_offset=slab.row_offset, rows=slab.rows)
    large = intersect.uses_bvh(tri_data)
    geometry_pass = cuda_geometry.geometry_pass_bvh if large else cuda_geometry.geometry_pass
    geo = geometry_pass(
        tri_data, history.lut, camera.position, camera.rotation,
        light.position, history.light_pos, light.color, history.light_color,
        view, proj, history.view, history.proj, cfg,
        emit_albedo=cfg.demodulate_albedo or cfg.gbuffer_primary, **rows,
    )
    primary = None
    if cfg.gbuffer_primary:
        primary = (geo.visibility, geo.world_pos, geo.normal, geo.albedo)
    if cfg.indirect_split:
        # the segment tracer at any scene size: with the G-buffer seed and
        # indirect_split = 1 the full-res trace launches no segment; a slab
        # starts on a coarse row, and the upsample's next coarse row comes
        # through a one-coarse-row halo
        noisy = multires.multires_noisy(
            tri_data, camera.position, light, frame_idx, cfg, geo.normal, geo.depth,
            rotation=camera.rotation, primary=primary,
            trace_pass=cuda_wavefront.path_trace_wavefront,
            trace_fn=cuda_wavefront.trace_pixels_wavefront,
            row_pad=lambda c: slab.pad(c, 1), **rows,
        )
    else:
        noisy = trace_noisy(tri_data, camera, light, frame_idx, cfg, True, primary, **rows)
    noisy_lum = atrous.luminance(noisy) if cfg.path_gradient else None
    if cfg.firefly_clamp:
        noisy = torch.clamp_max(noisy, cfg.firefly_clamp)
    demod_s = None
    if cfg.demodulate_albedo:
        demod_s = atrous.demod_scale(geo.albedo, cfg)
        noisy = atrous.demodulate(noisy, demod_s)

    py, px = geo.prev_y, geo.prev_x
    slab.backprojected(py)
    vis_src = None
    if cfg.path_gradient or (cfg.accumulation_ramp and cfg.ramp_reset_mode != "normal"):
        vis_src = slab.source(history.visibility)
    lam = geo.lam
    if cfg.path_gradient:
        # the stratum re-trace on the segment tracer at any scene size
        lum_src = slab.source(history.noisy_lum)
        lam = torch.maximum(lam, pathgrad.path_gradient_pass(
            tri_data, light, frame_idx, cfg, lum_src[0], history.cam_pos, history.cam_rot,
            py, px, geo.visibility, vis_src[0], trace_fn=cuda_wavefront.trace_pixels_wavefront,
            row_offset=slab.row_offset, src_row0=lum_src[1], row_pad=lambda x: slab.pad(x, 1),
        ))
    age_src = cons_src = cls_cur = cur_cons = None
    if cfg.accumulation_ramp:
        age_src = slab.source(history.age)
        if cfg.ramp_reset_mode == "normal":
            cls_cur = cur_cons = atrous.normal_class(geo.normal, geo.visibility)
            cons_src = slab.source(history.vis_class)
        else:
            cons_src, cur_cons = vis_src, geo.visibility
    moments = None
    if cfg.variance_guided:
        mom_src = slab.source(history.moments)
        lum = atrous.luminance(noisy)
        # the young history's 5x5 estimate reads two rows a side
        lum_pad = slab.pad(lum, slab.halo(2))
        var_spatial = None
        if frame_idx < cfg.variance_boost_frames:
            var_spatial = atrous.spatial_variance(lum_pad, halo=slab.halo(2))
        reproj = atrous.gather_window(mom_src[0], py, px, mom_src[1]) if frame_idx > 0 else None
        moments, var = atrous.accumulate_moments(lum, None, py, px, frame_idx, cfg,
                                                 var_spatial=var_spatial, reproj=reproj)
        filtered, _ = cuda_atrous.atrous_filter_var(noisy, var, geo.normal, geo.depth, cfg, slab)
    else:
        filtered = cuda_atrous.atrous_filter(noisy, geo.normal, geo.depth, cfg, slab)
    image_src, row0 = slab.source(history.image)
    age = None
    if cfg.accumulation_ramp:
        rgb, age = cuda_atrous.temporal_blend_ramp(
            filtered, image_src, py, px, frame_idx, lam, age_src[0], cons_src[0], cur_cons, cfg,
            src_row0=row0,
        )
    else:
        rgb = cuda_atrous.temporal_blend(filtered, image_src, py, px, frame_idx, lam, cfg,
                                         src_row0=row0)
    new_history = _next_history(rgb, geo.visibility, tri_data, view, proj, light, camera,
                                frame_idx, cfg, moments, age, cls_cur, noisy_lum)
    if demod_s is not None:
        return atrous.modulate(rgb, demod_s), new_history
    return rgb, new_history


def _consistency_planes(history, normal, visibility, cfg):
    """The accumulation ramp's surface-consistency planes (previous,
    current) per cfg.ramp_reset_mode: visibility ids, or quantized-normal
    classes, which the history then carries (the third value; None for
    ids). The ramp only tests them for equality."""
    if cfg.ramp_reset_mode == "normal":
        cls_cur = atrous.normal_class(normal, visibility)
        return history.vis_class, cls_cur, cls_cur
    return history.visibility, visibility, None


def _next_history(rgb, visibility, tri_data, view, proj, light, camera, frame_idx, cfg,
                  moments=None, age=None, vis_class=None, noisy_lum=None) -> History:
    """The reference's end-of-frame blits (main.cpp:1361-1372), plus the
    extension planes."""
    return History(
        image=rgb,
        visibility=visibility,
        lut=tri_data.lut,
        view=view,
        proj=proj,
        light_pos=light.position,
        light_color=light.color,
        frame=frame_idx + 1,
        moments=moments,
        age=age,
        vis_class=vis_class,
        noisy_lum=noisy_lum,
        cam_pos=camera.position if cfg.path_gradient else None,
        cam_rot=camera.rotation if cfg.path_gradient else None,
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
    device = tri_data.lut.device if device is None else torch.device(device)
    camera = Camera.default(device)
    light = Light.default(device)
    view, proj = camera_matrices(camera.position, cfg)

    def zeros(*channels):
        return torch.zeros((cfg.height, cfg.width, *channels), dtype=torch.float32,
                           device=device)

    ramp = cfg.accumulation_ramp
    return History(
        image=zeros(3),
        visibility=zeros(),
        lut=tri_data.lut.to(device),
        view=view,
        proj=proj,
        light_pos=light.position,
        light_color=light.color,
        frame=0,
        moments=zeros(2) if cfg.variance_guided else None,
        age=zeros() if ramp else None,
        vis_class=zeros() if ramp and cfg.ramp_reset_mode == "normal" else None,
        noisy_lum=zeros() if cfg.path_gradient else None,
        cam_pos=camera.position if cfg.path_gradient else None,
        cam_rot=camera.rotation if cfg.path_gradient else None,
    )
