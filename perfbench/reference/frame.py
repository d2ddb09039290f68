"""The reference frame: (triangle tables, camera, light, history) -> (rgb, history').

The plain PyTorch frame of the measured package's plain route, frozen here
(its four passes: visibility G-buffer, temporal gradient, path trace, nine
a-trous iterations with the temporal blend, and the SVGF, estimator,
multi-res and path-gradient extensions), so that the benchmark judges the
program by code that the program cannot change. Nothing here imports the
measured package.
"""

from __future__ import annotations

import torch

from . import atrous, gbuffer, gradient, intersect, multires, pathgrad, pathtrace
from . import camera as cam_ops
from .config import RenderConfig
from .history import History
from .scene import Camera, Light, TriangleData, transform_triangle_data


def camera_matrices(camera, cfg: RenderConfig):
    """The per-frame view matrix and glm::perspective(2*FOV) with the Vulkan
    y flip. Accepts a Camera or a bare (3,) position."""
    if isinstance(camera, Camera):
        view = cam_ops.camera_view(camera.position, camera.rotation)
    else:
        view = cam_ops.reference_view(camera)
    proj = cam_ops.vulkan_perspective(
        cfg.fov * 2.0, cfg.width / cfg.height, cfg.near, cfg.far, device=view.device,
    )
    return view, proj


def render_frame(tri_data: TriangleData, camera: Camera, light: Light, history: History,
                 cfg: RenderConfig, model=None):
    """One frame; returns the displayed (H, W, 3) image and the next history."""
    if model is not None:
        tri_data = transform_triangle_data(tri_data, model, refit=intersect.uses_bvh(tri_data))
    frame_idx = history.frame
    view, proj = camera_matrices(camera, cfg)

    gbuf = gbuffer.visibility_pass(
        tri_data, camera.position, view, proj, cfg, rotation=camera.rotation
    )
    lam = gradient.temporal_gradient_pass(
        gbuf, tri_data.lut, history.lut, camera.position, light.position,
        history.light_pos, light.color, history.light_color,
    )
    py = px = None
    if cfg.variance_guided or cfg.accumulation_ramp or cfg.path_gradient:
        py, px = atrous.backproject_pixels(gbuf, history.lut, history.view, history.proj, cfg)
    if cfg.path_gradient:
        lam = torch.maximum(lam, pathgrad.path_gradient_pass(
            tri_data, light, frame_idx, cfg, history.noisy_lum, history.cam_pos,
            history.cam_rot, py, px, gbuf.visibility, history.visibility,
        ))
    normal_img = tri_data.lut_normals[gbuf.visibility.to(torch.int64)]
    primary = None
    if cfg.gbuffer_primary:
        primary = (gbuf.visibility, gbuf.world_pos, normal_img,
                   atrous.albedo_image(tri_data, gbuf.visibility))
    if cfg.indirect_split:
        noisy = multires.multires_noisy(
            tri_data, camera.position, light, frame_idx, cfg, normal_img, gbuf.depth,
            rotation=camera.rotation, primary=primary,
        )
    else:
        noisy = pathtrace.path_trace_pass(tri_data, camera.position, light, frame_idx, cfg,
                                          rotation=camera.rotation, primary=primary)
    noisy_lum = atrous.luminance(noisy) if cfg.path_gradient else None
    if cfg.firefly_clamp:
        noisy = torch.clamp_max(noisy, cfg.firefly_clamp)
    demod_s = None
    if cfg.demodulate_albedo:
        demod_s = atrous.demod_scale(atrous.albedo_image(tri_data, gbuf.visibility), cfg)
        noisy = atrous.demodulate(noisy, demod_s)
    age = cls_cur = None
    if cfg.accumulation_ramp:
        if cfg.ramp_reset_mode == "normal":
            cls_cur = atrous.normal_class(normal_img, gbuf.visibility)
            prev_cons, cur_cons = history.vis_class, cls_cur
        else:
            prev_cons, cur_cons = history.visibility, gbuf.visibility
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
    new_history = History(
        image=rgb, visibility=gbuf.visibility, lut=tri_data.lut, view=view, proj=proj,
        light_pos=light.position, light_color=light.color, frame=frame_idx + 1,
        moments=moments, age=age, vis_class=cls_cur, noisy_lum=noisy_lum,
        cam_pos=camera.position if cfg.path_gradient else None,
        cam_rot=camera.rotation if cfg.path_gradient else None,
    )
    if demod_s is not None:
        return atrous.modulate(rgb, demod_s), new_history
    return rgb, new_history


def init_history(tri_data: TriangleData, cfg: RenderConfig, device=None) -> History:
    """Frame-0 history: the previous matrices equal the default camera's,
    the image planes zero, the previous LUT the current one."""
    device = tri_data.lut.device if device is None else torch.device(device)
    camera = Camera.default(device)
    light = Light.default(device)
    view, proj = camera_matrices(camera.position, cfg)

    def zeros(*channels):
        return torch.zeros((cfg.height, cfg.width, *channels), dtype=torch.float32,
                           device=device)

    ramp = cfg.accumulation_ramp
    return History(
        image=zeros(3), visibility=zeros(), lut=tri_data.lut.to(device), view=view, proj=proj,
        light_pos=light.position, light_color=light.color, frame=0,
        moments=zeros(2) if cfg.variance_guided else None,
        age=zeros() if ramp else None,
        vis_class=zeros() if ramp and cfg.ramp_reset_mode == "normal" else None,
        noisy_lum=zeros() if cfg.path_gradient else None,
        cam_pos=camera.position if cfg.path_gradient else None,
        cam_rot=camera.rotation if cfg.path_gradient else None,
    )
