"""1-spp diffuse path tracer, plain PyTorch version.

Behavioral re-derivation of the reference's megakernel
(raytrace.comp.glsl:200-344) as a vectorized bounce loop: every pixel's ray
advances in lockstep through ``max_bounces`` segments with an alive mask,
and each bounce's ray/scene query is the dense nearest-hit test
(ops/intersect.py). The CUDA tracer (csrc/pathtrace.cu) runs the same
arithmetic with one thread per pixel.

Reference quirks reproduced deliberately (cfg-gated where noted):
  * the sphere light is tested against the raw ray, ignoring occluders, so
    it shines through walls (raytrace.comp.glsl:226-235; cfg.light_through_walls)
  * a first-segment light hit is dimmed by 5 ("eye safety", raytrace:229)
  * rays that survive all 32 segments return their albedo product with no
    emission (loop fall-through, raytrace:270)
  * albedo is keyed on the UNflipped geometric normal (raytrace:155-163)
  * RNG draw order: 2 Gaussians for AA jitter, then (theta, u) per diffuse
    bounce (raytrace:314, 256-257) -- bit-exact PCG streams (ops/rng.py)

This parity version has no next-event estimation and no Russian roulette;
the frame rejects those flags (pipeline.frame.check_supported).
"""

from __future__ import annotations

import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    camera as cam_ops,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import (
    intersect,
    rng as rng_ops,
    shading,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.gbuffer import (
    pixel_grid,
)


def bounce_step(segment, o, d, accum, result, alive, state,
                rec_hit, rec_t, hit_pos, n_geo, albedo,
                light_pos, light_color_hdr, cfg):
    """One bounce's light/shading/termination given the nearest-hit record.
    Returns the next (o, d, accum, result, alive, state) carry."""
    light_hit, light_t = intersect.ray_sphere(o, d, light_pos, cfg.light_radius)
    if not cfg.light_through_walls:
        # the light only terminates the path if it is closer than the
        # committed triangle hit
        light_hit = light_hit & (~rec_hit | (light_t < rec_t))

    # --- light termination (checked first, raytrace.comp.glsl:226-235)
    dim = 1.0 / cfg.first_hit_light_dim if segment == 0 else 1.0
    light_term = (alive & light_hit)[..., None]
    result = torch.where(light_term, accum * light_color_hdr * dim, result)

    # --- triangle bounce (raytrace.comp.glsl:238-262)
    tri_hit = alive & ~light_hit & rec_hit
    bounced = tri_hit[..., None]
    accum = torch.where(bounced, accum * albedo, accum)
    n_ff = shading.faceforward(n_geo, d)
    new_o = hit_pos + cfg.ray_offset_eps * n_ff
    new_state, sphere_vec = rng_ops.random_unit_sphere(state)
    new_d = n_ff + sphere_vec
    new_d = new_d / cam_ops.norm3(new_d, keepdim=True)
    o = torch.where(bounced, new_o, o)
    d = torch.where(bounced, new_d, d)
    # Only lanes that actually bounced consumed randoms (raytrace:256-257).
    state = torch.where(tri_hit, new_state, state)

    # --- sky termination (raytrace.comp.glsl:263-268); ``d`` is the
    # bounced direction where tri_hit, but sky lanes did not bounce
    sky_term = (alive & ~light_hit & ~rec_hit)[..., None]
    result = torch.where(sky_term, accum * shading.sky_color(d), result)
    return o, d, accum, result, tri_hit, state


def trace_paths(tri_data, light_pos, light_color_hdr, origins, dirs, rng_state, cfg):
    """Trace one path per lane to termination.

    ``origins``/``dirs``: (..., 3); ``rng_state``: (...,) int64 PCG states
    (already advanced past the AA jitter draws). ``light_color_hdr`` is the
    HDR light color (base * cfg.light_intensity, raytrace.comp.glsl:281).
    Returns the per-lane radiance (..., 3).
    """
    o, d, state = origins, dirs, rng_state
    accum = torch.ones_like(origins)
    result = torch.zeros_like(origins)
    alive = torch.ones(origins.shape[:-1], dtype=torch.bool, device=origins.device)
    for segment in range(cfg.max_bounces):
        rec = intersect.nearest_hit(
            tri_data.planes, o, d, t_max=cfg.t_max, eps=cfg.intersect_eps
        )
        n_geo = tri_data.normals[rec.prim]              # unflipped (T,3) gather
        albedo = tri_data.albedo[rec.prim]
        hit_pos = intersect.hit_position(tri_data.planes, rec)
        o, d, accum, result, alive, state = bounce_step(
            segment, o, d, accum, result, alive, state,
            rec.hit, rec.t, hit_pos, n_geo, albedo,
            light_pos, light_color_hdr, cfg,
        )
    # Loop fall-through: surviving paths return the bare albedo product
    # (raytrace.comp.glsl:270).
    return torch.where(alive[..., None], accum, result)


def trace_pixels(tri_data, camera_pos, light, frame_idx, px, py, cfg, rotation=None):
    """Per-pixel seeds, AA jitter, spp loop, average
    (raytrace.comp.glsl:273-344) for explicit pixel-coordinate tensors.

    ``px``/``py``: integer global pixel coordinates of any (matching)
    shape; the output radiance has shape ``px.shape + (3,)``. Seeds and
    rays are pure functions of the coordinates, so tracing any subset of
    pixels gives the same values as those pixels of a full-frame trace.
    """
    light_color_hdr = light.color * cfg.light_intensity
    shape = tuple(px.shape)
    origins = camera_pos.expand(*shape, 3)
    total = torch.zeros(shape + (3,), dtype=torch.float32, device=px.device)
    for batch_idx in range(cfg.sample_batches):
        state = rng_ops.seed_per_pixel(px, py, frame_idx, batch_idx)
        summed = torch.zeros_like(total)
        for _ in range(cfg.spp):
            state, gx, gy = rng_ops.random_gaussian(state)
            dirs = cam_ops.pixel_rays(
                px, py, cfg.width, cfg.height, cfg.fov,
                jitter_x=cfg.aa_sigma * gx, jitter_y=cfg.aa_sigma * gy,
                rotation=rotation,
            )
            # GLSL passes rngState by value into the path loop
            # (raytrace.comp.glsl:200): the next sample continues from the
            # post-jitter state, not the post-bounce one.
            summed = summed + trace_paths(
                tri_data, light.position, light_color_hdr, origins, dirs,
                state, cfg,
            )
        total = total + summed / float(cfg.spp)
    return total / float(cfg.sample_batches)


def path_trace_pass(tri_data, camera_pos, light, frame_idx, cfg, rotation=None):
    """Full path-trace pass over the pixel grid: :func:`trace_pixels` at
    every pixel. Returns the noisy radiance (H, W, 3)."""
    py, px = pixel_grid(cfg.height, cfg.width, camera_pos.device)
    return trace_pixels(
        tri_data, camera_pos, light, frame_idx, px, py, cfg, rotation=rotation
    )
