"""1-spp diffuse path tracer, plain PyTorch version.

Behavioral re-derivation of the reference's megakernel
(raytrace.comp.glsl:200-344) as a vectorized bounce loop: every pixel's ray
advances in lockstep through ``max_bounces`` segments with an alive mask,
and each bounce's ray/scene query is ops/intersect.scene_nearest_hit (the
dense test, or the LBVH walk on large scenes). The CUDA tracers
(csrc/pathtrace.cu, one launch; csrc/wavefront.cu, one launch per segment)
run the same arithmetic with one thread per pixel or ray.

Reference quirks reproduced deliberately (cfg-gated where noted):
  * the sphere light is tested against the raw ray, ignoring occluders, so
    it shines through walls (raytrace.comp.glsl:226-235; cfg.light_through_walls)
  * a first-segment light hit is dimmed by 5 ("eye safety", raytrace:229)
  * rays that survive all 32 segments return their albedo product with no
    emission (loop fall-through, raytrace:270)
  * albedo is keyed on the UNflipped geometric normal (raytrace:155-163)
  * RNG draw order: 2 Gaussians for AA jitter, then (theta, u) per diffuse
    bounce (raytrace:314, 256-257) -- bit-exact PCG streams (ops/rng.py)

Non-parity estimators, each behind its flag: next-event estimation
(cfg.nee: one solid-angle sample of the sphere light per bounce, with a
shadow ray), Russian roulette (cfg.rr_start_bounce) and truncate_radiance
(no loop fall-through). They follow the JAX package's XLA tracer
(ops/pathtrace.py there), draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from . import (
    camera as cam_ops,
)
from . import (
    intersect,
    rng as rng_ops,
    shading,
)
from .gbuffer import (
    pixel_grid,
)


_INV_PI = float(np.float32(1.0 / 3.14159265))


def _nee_sample(o, n_ff, accum, state, tri_hit, tri_data, light_pos,
                light_color_hdr, cfg, defer=False):
    """Next-event estimation at the bounce vertex ``o`` (the offset hit
    point): sample the sphere light's solid-angle cone, shadow-test the
    sample against the scene, and return (banked radiance (..., 3), state).
    The estimator is accum * L_e * cos_x * Omega / pi (f = albedo/pi is
    folded into accum, pdf = 1/Omega). The two cone draws follow the bounce
    draws, so the path itself is the parity one.

    ``defer``: skip the shadow test and return (w_l, s_t, bank, mask) in
    place of the banked radiance -- the sample direction, the sphere-entry
    distance, the contribution if unoccluded and the lanes that sampled --
    for a separate shadow walk (ops/cuda/wavefront.shadow_segment)."""
    to_l = light_pos - o
    dist = cam_ops.norm3(to_l)
    safe_dist = torch.clamp_min(dist, 1e-20)
    wc = to_l / safe_dist[..., None]
    # a true division (a Python scalar over a tensor would multiply by
    # the rounded reciprocal)
    sin_max = torch.clamp(torch.full_like(dist, cfg.light_radius) / safe_dist, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin_max * sin_max, 0.0))
    nee_state, u1 = rng_ops.pcg_step(state)
    nee_state, u2 = rng_ops.pcg_step(nee_state)
    state = torch.where(tri_hit, nee_state, state)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = rng_ops.TWO_PI * u2
    # branchless orthonormal basis around wc
    pick = (torch.abs(wc[..., 0]) > 0.9)[..., None]
    y_axis = wc.new_tensor([0.0, 1.0, 0.0])
    x_axis = wc.new_tensor([1.0, 0.0, 0.0])
    tang = cam_ops.cross3(torch.where(pick, y_axis, x_axis), wc)
    tang = tang / torch.clamp_min(cam_ops.norm3(tang, keepdim=True), 1e-20)
    bitang = cam_ops.cross3(wc, tang)
    w_l = (
        cos_t[..., None] * wc
        + (sin_t * torch.cos(phi))[..., None] * tang
        + (sin_t * torch.sin(phi))[..., None] * bitang
    )
    cos_x = cam_ops.dot3(n_ff, w_l)
    s_hit, s_t = intersect.ray_sphere(o, w_l, light_pos, cfg.light_radius)
    omega = rng_ops.TWO_PI * (1.0 - cos_max)
    gain = cos_x * omega * _INV_PI
    mask = tri_hit & (cos_x > 0.0) & s_hit
    if defer:
        bank = torch.where(mask[..., None], accum * light_color_hdr * gain[..., None],
                           torch.zeros_like(accum))
        return (w_l, s_t, bank, mask), state
    occluded = intersect.scene_occluded(
        tri_data, o, w_l, s_t, t_max=cfg.t_max, eps=cfg.intersect_eps, mask=mask
    )
    lit = mask & ~occluded
    bank = torch.where(
        lit[..., None], accum * light_color_hdr * gain[..., None],
        torch.zeros_like(accum),
    )
    return bank, state


def bounce_step(segment, o, d, accum, result, alive, state,
                rec_hit, rec_t, hit_pos, n_geo, albedo,
                light_pos, light_color_hdr, cfg, tri_data=None,
                defer_nee_shadow=False):
    """One bounce's light/shading/termination given the nearest-hit record.
    ``tri_data`` is needed only for cfg.nee (the shadow ray). Returns the
    next (o, d, accum, result, alive, state) carry; with cfg.nee and
    ``defer_nee_shadow`` the NEE sample is not shadow-tested, and a 7th
    element (w_l, s_t, bank, mask) carries it to a separate shadow walk."""
    light_hit, light_t = intersect.ray_sphere(o, d, light_pos, cfg.light_radius)
    if not cfg.light_through_walls or cfg.nee:
        # the light only terminates the path if it is closer than the
        # committed triangle hit (NEE's shadow rays respect walls, so its
        # termination must too)
        light_hit = light_hit & (~rec_hit | (light_t < rec_t))

    # --- light termination (checked first, raytrace.comp.glsl:226-235)
    dim = 1.0 / cfg.first_hit_light_dim if segment == 0 else 1.0
    light_term = alive & light_hit
    if cfg.nee and segment > 0:
        # the sphere still blocks and terminates, but only the camera
        # segment adds its emission: deeper crossings were counted by the
        # previous vertex's shadow ray
        light_term = torch.zeros_like(light_term)
    result = torch.where(light_term[..., None], accum * light_color_hdr * dim, result)

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

    nee_info = None
    if cfg.nee:
        bank, state = _nee_sample(new_o, n_ff, accum, state, tri_hit, tri_data,
                                  light_pos, light_color_hdr, cfg, defer=defer_nee_shadow)
        if defer_nee_shadow:
            nee_info = bank
        else:
            result = result + bank

    # --- sky termination (raytrace.comp.glsl:263-268); ``d`` is the
    # bounced direction where tri_hit, but sky lanes did not bounce
    sky_term = (alive & ~light_hit & ~rec_hit)[..., None]
    sky = accum * shading.sky_color(d)
    if cfg.nee:
        # result may hold banked NEE sums: add, do not replace
        result = result + torch.where(sky_term, sky, torch.zeros_like(sky))
    else:
        result = torch.where(sky_term, sky, result)

    if cfg.rr_start_bounce and segment >= cfg.rr_start_bounce:
        # --- Russian roulette: one extra uniform per bounced lane; the
        # survivors' throughput is divided by p (unbiased). Killed lanes
        # keep their result and take no fall-through.
        rr_state, u = rng_ops.pcg_step(state)
        p = torch.clamp(torch.amax(accum, dim=-1), cfg.rr_min_prob, cfg.rr_max_prob)
        state = torch.where(tri_hit, rr_state, state)
        survive = u < p
        accum = torch.where((tri_hit & survive)[..., None], accum / p[..., None], accum)
        tri_hit = tri_hit & survive
    if nee_info is not None:
        return o, d, accum, result, tri_hit, state, nee_info
    return o, d, accum, result, tri_hit, state


def trace_paths(tri_data, light_pos, light_color_hdr, origins, dirs, rng_state, cfg,
                emit_throughput=False, start_segment=0, initial_carry=None):
    """Trace one path per lane to termination.

    ``origins``/``dirs``: (..., 3); ``rng_state``: (...,) int64 PCG states
    (already advanced past the AA jitter draws). ``light_color_hdr`` is the
    HDR light color (base * cfg.light_intensity, raytrace.comp.glsl:281).
    Returns the per-lane radiance (..., 3); with ``emit_throughput`` also
    the path throughput at the truncation point (accum where the lane is
    still alive after max_bounces, 0 where it ended), which the multi-res
    split divides its residual by (ops/multires.py).

    ``start_segment``/``initial_carry``: resume the bounce loop from a
    carry (cfg.gbuffer_primary: :func:`primary_carry` replays bounce 0
    off the G-buffer and the loop starts at segment 1).
    """
    if initial_carry is None:
        o, d, state = origins, dirs, rng_state
        accum = torch.ones_like(origins)
        result = torch.zeros_like(origins)
        alive = torch.ones(origins.shape[:-1], dtype=torch.bool, device=origins.device)
    else:
        o, d, accum, result, alive, state = initial_carry
    for segment in range(start_segment, cfg.max_bounces):
        rec = intersect.scene_nearest_hit(
            tri_data, o, d, t_max=cfg.t_max, eps=cfg.intersect_eps, mask=alive
        )
        n_geo = tri_data.normals[rec.prim]              # unflipped (T,3) gather
        albedo = tri_data.albedo[rec.prim]
        hit_pos = intersect.hit_position(tri_data.planes, rec)
        o, d, accum, result, alive, state = bounce_step(
            segment, o, d, accum, result, alive, state,
            rec.hit, rec.t, hit_pos, n_geo, albedo,
            light_pos, light_color_hdr, cfg, tri_data=tri_data,
        )
    # Loop fall-through: surviving paths return the bare albedo product
    # (raytrace.comp.glsl:270). NEE accumulates along the path instead, and
    # truncate_radiance returns only what was banked: both drop the quirk.
    if cfg.nee or cfg.truncate_radiance:
        out = result
    else:
        out = torch.where(alive[..., None], accum, result)
    if emit_throughput:
        return out, torch.where(alive[..., None], accum, torch.zeros_like(accum))
    return out


def primary_carry(origins, dirs, state, vis, world_pos, n_geo, albedo,
                  light_pos, light_color_hdr, cfg, tri_data=None,
                  defer_nee_shadow=False):
    """Bounce-0 carry from G-buffer attributes (cfg.gbuffer_primary).

    The visibility pass already traced the primary rays with the tracer's
    own camera, so bounce 0's nearest hit is a lookup: ``vis`` (primID + 1,
    0 = background), ``world_pos`` the hit position, ``n_geo`` the
    unflipped triangle normal, ``albedo`` the hit albedo. ``state`` is past
    the AA jitter draws and ``dirs`` are the CENTER rays (this mode has no
    primary jitter; the result equals a full trace with cfg.aa_sigma = 0).
    rec.t is rebuilt as dot(world_pos - o, d); it only feeds the light
    ordering test of non-parity modes. Returns the carry after bounce 0 for
    :func:`trace_paths` at start_segment=1; under cfg.nee, ``tri_data``
    serves the shadow test, or ``defer_nee_shadow`` returns the shadow ray
    as a 7th element (see :func:`bounce_step`)."""
    rec_hit = vis > 0
    rec_t = cam_ops.dot3(world_pos - origins, dirs)
    return bounce_step(
        0, origins, dirs, torch.ones_like(origins), torch.zeros_like(origins),
        torch.ones(origins.shape[:-1], dtype=torch.bool, device=origins.device),
        state, rec_hit, rec_t, world_pos, n_geo, albedo,
        light_pos, light_color_hdr, cfg, tri_data=tri_data,
        defer_nee_shadow=defer_nee_shadow,
    )


def trace_pixels(tri_data, camera_pos, light, frame_idx, px, py, cfg, rotation=None,
                 emit_throughput=False, primary=None):
    """Per-pixel seeds, AA jitter, spp loop, average
    (raytrace.comp.glsl:273-344) for explicit pixel-coordinate tensors.

    ``px``/``py``: integer global pixel coordinates of any (matching)
    shape; the output radiance has shape ``px.shape + (3,)``. Seeds and
    rays are pure functions of the coordinates, so tracing any subset of
    pixels gives the same values as those pixels of a full-frame trace.

    ``emit_throughput``: also return the truncation-point throughput
    (:func:`trace_paths`), averaged over samples and batches as the
    radiance is.

    ``primary``: (vis, world_pos, n_geo, albedo) G-buffer planes aligned
    with ``px``/``py`` (cfg.gbuffer_primary): bounce 0 is replayed off them
    (:func:`primary_carry`) and the jitter is multiplied by zero (its draws
    still advance the stream).
    """
    light_color_hdr = light.color * cfg.light_intensity
    sigma = cfg.aa_sigma if primary is None else 0.0
    shape = tuple(px.shape)
    origins = camera_pos.expand(*shape, 3)
    total = torch.zeros(shape + (3,), dtype=torch.float32, device=px.device)
    thru_total = torch.zeros_like(total)
    for batch_idx in range(cfg.sample_batches):
        state = rng_ops.seed_per_pixel(px, py, frame_idx, batch_idx)
        summed = torch.zeros_like(total)
        thru_sum = torch.zeros_like(total)
        for _ in range(cfg.spp):
            state, gx, gy = rng_ops.random_gaussian(state)
            dirs = cam_ops.pixel_rays(
                px, py, cfg.width, cfg.height, cfg.fov,
                jitter_x=sigma * gx, jitter_y=sigma * gy, rotation=rotation,
            )
            carry = None
            if primary is not None:
                carry = primary_carry(origins, dirs, state, *primary, light.position,
                                      light_color_hdr, cfg, tri_data=tri_data)
            # GLSL passes rngState by value into the path loop
            # (raytrace.comp.glsl:200): the next sample continues from the
            # post-jitter state, not the post-bounce one.
            traced = trace_paths(
                tri_data, light.position, light_color_hdr, origins, dirs,
                state, cfg, emit_throughput=emit_throughput,
                start_segment=0 if carry is None else 1, initial_carry=carry,
            )
            if emit_throughput:
                traced, thru = traced
                thru_sum = thru_sum + thru
            summed = summed + traced
        total = total + cam_ops.true_div(summed, float(cfg.spp))
        thru_total = thru_total + cam_ops.true_div(thru_sum, float(cfg.spp))
    out = cam_ops.true_div(total, float(cfg.sample_batches))
    if emit_throughput:
        return out, cam_ops.true_div(thru_total, float(cfg.sample_batches))
    return out


def path_trace_pass(tri_data, camera_pos, light, frame_idx, cfg, rotation=None,
                    emit_throughput=False, primary=None, row_offset: int = 0,
                    rows: int | None = None):
    """Full path-trace pass over the pixel grid: :func:`trace_pixels` at
    every pixel. Returns the noisy radiance (H, W, 3) (and the (H, W, 3)
    truncation-point throughput with ``emit_throughput``).
    ``row_offset``/``rows``: trace ``rows`` rows from global row
    ``row_offset`` on (a slab of the sharded frame; seeds and rays are
    those of the global pixels)."""
    py, px = pixel_grid(cfg.height if rows is None else rows, cfg.width, camera_pos.device)
    return trace_pixels(
        tri_data, camera_pos, light, frame_idx, px, py + row_offset, cfg, rotation=rotation,
        emit_throughput=emit_throughput, primary=primary,
    )
