"""Render configuration.

The reference has no runtime config system: every tunable is a compile-time
constant scattered across common.h, main.cpp and the GLSL shaders (see
reference common.h:14-24, main.cpp:52-72, raytrace.comp.glsl:204,280-282,306,
temporalFiltering.comp.glsl:203-205,243). ``RenderConfig`` captures that exact
list as one frozen (hashable) dataclass. Fields, defaults and validation are
the JAX package's, so one config describes the same frame in both packages,
and this package runs every one of them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All compile-time constants of the reference, as one static config.

    Defaults reproduce the reference exactly. The config is frozen and
    hashable, like the reference's #define's it replaces.
    """

    # --- image (reference main.cpp:52-53) ---
    width: int = 1000
    height: int = 800

    # --- camera (reference common.h:14, raytrace.comp.glsl:300) ---
    fov: float = 0.20          # radians; ray slope = tan(fov)
    near: float = 0.1          # raster proj near (main.cpp:483)
    far: float = 10.0          # raster proj far (main.cpp:483)

    # --- path tracing (raytrace.comp.glsl) ---
    spp: int = 1                     # NUM_SAMPLES (raytrace.comp.glsl:306)
    # NUM_SAMPLE_BATCHES (main.cpp:1223). Note: with >1 batch the reference
    # OVERWRITES the image per batch (its accumulation code is commented
    # out, raytrace.comp.glsl:348-356); we average batches instead, which
    # is identical at the default of 1 and the sane extension beyond.
    sample_batches: int = 1
    max_bounces: int = 32            # loop bound (raytrace.comp.glsl:204)
    aa_sigma: float = 0.375          # Gaussian AA jitter (raytrace:314)
    ray_offset_eps: float = 1e-4     # bounce origin offset (raytrace:250)
    t_max: float = 10000.0           # ray query max t (raytrace:216)

    # --- next-event estimation (non-parity extension) ---
    # The reference finds the light only when a cosine-sampled bounce ray
    # happens to cross the sphere (raytrace.comp.glsl:226-235) -- at 1 spp
    # most pixels carry no direct-light information at all and the filter
    # must conjure it from neighbors. nee=True samples the light's solid
    # angle explicitly at every diffuse hit with a shadow ray (standard
    # next-event estimation): direct light becomes low-variance, the sphere
    # stops terminating paths beyond the camera segment (its hits are
    # already accounted), the loop fall-through quirk is dropped, and --
    # since shadow rays respect occluders -- the light no longer shines
    # through walls. Unbiased for the same scene transport; changes which
    # estimator computes it, so off for reference parity.
    nee: bool = False

    # --- Russian-roulette termination (non-parity extension) ---
    # 0 = off (reference parity: every path traces all max_bounces segments,
    # raytrace.comp.glsl:204). k >= 1: from bounce segment k on, a path that
    # diffuse-bounces survives with probability
    # p = clamp(max(throughput), rr_min_prob, rr_max_prob) and the survivor's
    # throughput is divided by p -- standard unbiased Russian roulette.
    # Expected live segments drop from max_bounces to O(1/(1-albedo)) on
    # closed scenes (the worst case for the wavefront tracer, where no path
    # ever escapes) at slightly higher variance per sample. RR-killed paths
    # do NOT take the reference's loop fall-through (raytrace:270): that
    # quirk is for paths still alive after max_bounces.
    rr_start_bounce: int = 0
    rr_min_prob: float = 0.05        # survival-probability clamp (floor)
    rr_max_prob: float = 0.95        # ceiling < 1 so white paths terminate

    # --- light (main.cpp:70-72, raytrace.comp.glsl:279-282) ---
    light_radius: float = 0.20
    light_intensity: float = 30.0        # "to hdr" scale (raytrace:281)
    first_hit_light_dim: float = 5.0     # first-segment dimming (raytrace:229)
    # Reference quirk: the sphere-light test ignores occluders entirely
    # (raytrace.comp.glsl:226-235 checks the light before the committed
    # triangle hit). True reproduces the reference; False makes the light
    # respect the nearest surface hit.
    light_through_walls: bool = True

    # --- a-trous filter (temporalFiltering.comp.glsl:203-205; main.cpp:55) ---
    wavelet_iterations: int = 9      # "must be an odd number" (main.cpp:55)
    sigma_n: float = 128.0
    sigma_z: float = 1.0
    sigma_l: float = 4.0

    # --- temporal accumulation (temporalFiltering.comp.glsl:243-248) ---
    ema_alpha: float = 0.3           # weight of the CURRENT frame
    # The reference wrote gradient-driven adaptive alpha but left it
    # commented out (temporalFiltering.comp.glsl:246-248). Off by default
    # for reference parity; on = alpha' = (1 - lambda)*alpha + lambda.
    adaptive_alpha: bool = False

    # --- variance-guided filtering (full-SVGF extension) ---
    # The reference's color weight is un-normalized (exp(-||cp-cq||/sigma_l),
    # temporalFiltering.comp.glsl:72-74). With variance_guided=True the
    # framework estimates per-pixel luminance variance (temporally
    # accumulated first/second moments, SVGF Schied et al. 2017 section 4)
    # and normalizes the luminance weight by the locally filtered stddev:
    # w_l = exp(-|l_p - l_q| / (sigma_l * sqrt(gauss3x3(var)) + eps)).
    # Off by default for reference parity (bit-identical when False).
    variance_guided: bool = False
    # Filter demodulated irradiance instead of radiance (SVGF Schied et al.
    # 2017 section 3: "we demodulate surface albedo ... before filtering"):
    # the noisy color is divided by the primary-hit albedo's LUMINANCE
    # before the a-trous/temporal chain (history is stored in irradiance
    # space) and re-modulated for display, so albedo brightness edges stay
    # crisp instead of bleeding through the filter. Scalar (not
    # per-channel) division because the parity albedos carry exact-zero
    # channels and the sphere-light glow is unmodulated radiance -- see
    # ops.atrous.demod_scale. The reference filters raw radiance -- off by
    # default for parity (bit-identical when False).
    demodulate_albedo: bool = False
    demod_eps: float = 1e-3          # albedo-luminance division guard
    # SVGF accumulation ramp (Schied et al. 2017 section 4: "we accumulate
    # at most 32 frames ... alpha = max(1/N, 0.2)"): carry a per-pixel
    # consecutive-history length N in History.age and blend with
    # alpha = max(ramp_alpha_min, 1/N) instead of the fixed reference
    # alpha. N resets to 1 where history is rejected: the A-SVGF temporal
    # gradient flags a shading change (lam > ramp_reset_lam), or the
    # backprojected history pixel saw a different primitive (visibility-id
    # mismatch -- SVGF's G-buffer consistency test, covering camera
    # cuts/disocclusions the gradient is blind to). Deep accumulation
    # therefore stays responsive -- the reference's fixed alpha=0.3 caps
    # the effective history at ~3 frames everywhere.
    # Composes with adaptive_alpha (alpha' = (1-lam)*alpha + lam). Off by
    # default for reference parity (bit-identical when False).
    accumulation_ramp: bool = False
    ramp_alpha_min: float = 0.1      # alpha floor (SVGF uses 0.2 over RT)
    ramp_reset_lam: float = 0.5      # gradient level that resets history
    ramp_age_cap: float = 1024.0     # guards 1/N float behavior, not quality
    # What counts as "the backprojected pixel saw a different surface":
    #   "id"     -- exact primitive-id equality (previous visibility buffer;
    #               the strictest test). On finely tessellated geometry a
    #               moving camera lands almost every reprojection on a
    #               DIFFERENT sub-triangle of the same flat surface, so
    #               history resets every frame and accumulation dies
    #               (measured: the 32k-subdivided interactive scene keeps
    #               per-frame noise under orbit).
    #   "normal" -- quantized-surface-normal equality (SVGF's actual
    #               G-buffer consistency notion: surface attributes, not
    #               ids; ops/atrous.normal_class). Flat tessellated
    #               surfaces keep their history; orientation changes
    #               (disocclusion by a differently-facing surface) still
    #               reset; same-normal disocclusions fall to the temporal
    #               gradient, like the reference's own (absent) test.
    # "id" stays the default (bit-compatible with rounds 3-4); "normal" is
    # the recommended mode for tessellated scenes and is part of the
    # recommended interactive config (STATUS.md).
    ramp_reset_mode: str = "id"
    # A-SVGF path-space gradient (Schied et al. 2018; ops/pathgrad.py).
    # The reference's temporal gradient Phong-shades the same world point
    # under both lights (temporalGradient.comp.glsl:104-171) -- dense but
    # direct-light-only, blind to shadows and indirect changes. With
    # path_gradient=True one previous-frame sample per
    # gradient_stratum^2-pixel stratum is RE-TRACED (same pixel, same
    # camera, same PCG seed -> bit-identical path) under the current
    # light; the relative luminance change is a true path-space gradient
    # (exactly zero when nothing changed). It is box-filtered at stratum
    # resolution, upsampled, and combined as lam = max(phong, path) --
    # the signals have disjoint blind spots (see ops/pathgrad.py).
    # Costs ~1/stratum^2 extra trace work. Off by default for parity.
    path_gradient: bool = False
    gradient_stratum: int = 3        # stratum edge (paper uses 3)
    gradient_filter_iters: int = 2   # 3x3 box passes over the sparse grid
    moments_alpha: float = 0.2       # EMA weight of the current moments
    # For the first few frames the temporal variance estimate has too little
    # history; use a 5x5 spatial moment estimate instead (paper section 4.2).
    variance_boost_frames: int = 4
    variance_eps: float = 1e-8       # stddev-denominator guard

    # --- multi-resolution indirect illumination (non-parity extension) ---
    # The reference traces every bounce segment at full resolution
    # (raytrace.comp.glsl:204: one thread loops all 32 segments). On large
    # scenes the per-segment wavefront cost scales with the ray count, and
    # indirect lighting is low-frequency -- the classic real-time split is
    # full-resolution direct + subsampled indirect. indirect_split = k >= 1
    # traces bounce segments [0, k) for EVERY pixel (with
    # truncate_radiance semantics, see below) and the remaining segments
    # [k, max_bounces) only on a 1/indirect_stride^2 coarse pixel grid.
    # The coarse tail residual (exact at coarse pixels by PCG-prefix
    # identity: the first k segments of the coarse full-length trace are
    # bit-identical to the full-res truncated trace at the same pixels) is
    # demodulated by the truncation-point path throughput, upsampled with
    # joint-bilateral G-buffer guidance (normal + depth edge stops), and
    # re-modulated. Biased (indirect is low-pass filtered at the stride
    # scale) but consistent with the SVGF filter downstream; measured
    # quality impact in benchmarks/quality.py. 0 = off (reference parity).
    indirect_split: int = 0
    # --- G-buffer-seeded primary rays (non-parity extension) ---
    # The visibility pass already ray-traces primary visibility with the
    # tracer's own camera model (ops/gbuffer.py replaces the reference's
    # raster pass, SURVEY.md section 7), yet the path tracer re-traces
    # bounce 0 from the camera (raytrace.comp.glsl:300 does the same).
    # gbuffer_primary replays bounce 0 off the G-buffer's committed hit
    # (visibility id, world position, normal, albedo) and starts the trace
    # at segment 1 -- on HBM-streamed scenes this deletes the full-res
    # bounce-0 traversal segment entirely (and with indirect_split=1 the
    # full-resolution trace becomes traversal-free). Primary AA jitter is
    # disabled (raster-G-buffer semantics, the standard SVGF-era split);
    # the jitter draws still advance the PCG stream, so the output is
    # bit-identical to a full trace with aa_sigma=0. Composes with nee:
    # the bounce-0 NEE shadow rays run as a dedicated occlusion-only
    # wavefront segment (origins = primary hits, directions into the
    # light cone -- maximally coherent; ops/pallas/wavefront.py
    # _shadow_kernel), so the best-quality and best-perf levers combine.
    gbuffer_primary: bool = False
    indirect_stride: int = 2         # coarse grid stride (2 -> 1/4 rays)
    indirect_sigma_z: float = 0.02   # depth edge stop of the upsampler
    indirect_normal_pow: int = 8     # normal edge stop exponent (2^n squarings)
    # Rotate the coarse grid's (oy, ox) phase every frame (a deterministic
    # PCG hash of the frame index, ops/multires.grid_phase): the fixed-grid
    # split low-passes indirect light at the stride scale PERMANENTLY;
    # with jitter each pixel becomes an exact-residual coarse sample every
    # ~stride^2 frames and the temporal EMA integrates over phases, so the
    # static bias turns into zero-mean temporal variation the filter
    # absorbs (interleaved sampling, Keller & Heidrich 2001). Costs
    # nothing per frame; requires width/height divisible by the stride.
    # Off by default (measured bars for the fixed grid stay pinned).
    indirect_jitter: bool = False
    # Alive-at-max_bounces paths return their banked radiance instead of
    # the reference's loop fall-through (bare albedo product,
    # raytrace.comp.glsl:270). Required by the multi-res truncated trace
    # (the fall-through would smear the full-res albedo product into the
    # low-res residual); also usable standalone. No-op when nee=True
    # (NEE already accumulates and drops the quirk).
    truncate_radiance: bool = False

    # --- firefly clamp (non-parity extension) ---
    # Clamp each channel of the NOISY per-frame estimate before filtering
    # and temporal accumulation. At 1 spp a path that crosses the HDR
    # sphere light carries radiance ~30 (cfg.light_intensity); one such
    # sample dominates its pixel for many frames (at ramp alpha 0.1 a
    # 30x outlier stays >1 for ~12 frames), and the variance-normalized
    # luminance weight -- unlike the parity fixed-sigma weight -- opens
    # up around bright blobs, so the a-trous filter keeps instead of
    # rejects them (worst with the multi-res upsampler, which smears one
    # coarse firefly over stride^2 pixels). Standard SVGF-era practice is
    # to clamp the HDR input; biased (loses energy above the clamp --
    # the displayed image is clamped to [0,1] anyway) but it removes the
    # speckle field entirely. 0 = off (reference parity: the reference
    # feeds unclamped HDR radiance to its filter). Recommended: 1-4.
    firefly_clamp: float = 0.0

    # --- interaction (main.cpp:68, 1119-1168) ---
    move_speed: float = 0.1
    light_x_wrap_lo: float = -20.0
    light_x_wrap_hi: float = 2.0

    # --- execution backend ---
    # "auto": the hand-written CUDA kernels for tensors on a CUDA device,
    #         the plain PyTorch version for tensors on the CPU.
    # "xla": force the plain PyTorch version on any device (the reference
    #        numerics; the name is kept from the JAX package).
    # "pallas": force the CUDA kernels; raises for tensors on the CPU.
    backend: str = "auto"
    # Kept for config parity with the JAX package, whose TPU bounce loop
    # packs surviving rays; the CUDA tracer exits a finished path's loop
    # per thread, so the field changes nothing here.
    bounce_compaction: bool = True

    # --- numerics ---
    dtype: str = "float32"  # compute dtype for the radiance path
    # Epsilon guarding degenerate ray/plane parallelism in the intersector
    # (the HW ray query handles this in silicon; we must pick a cutoff).
    intersect_eps: float = 1e-9

    def __post_init__(self) -> None:
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.wavelet_iterations % 2 != 1:
            # main.cpp:55 "must be an odd number" (so the ping-pong ends in
            # the displayable buffer); functionally we only need >= 1 but we
            # keep the reference's contract.
            raise ValueError("wavelet_iterations must be odd (main.cpp:55)")
        if self.spp < 1 or self.max_bounces < 1:
            raise ValueError("spp and max_bounces must be >= 1")
        if self.rr_start_bounce < 0:
            raise ValueError("rr_start_bounce must be >= 0 (0 = off)")
        if not (0.0 < self.rr_min_prob <= self.rr_max_prob <= 1.0):
            raise ValueError("need 0 < rr_min_prob <= rr_max_prob <= 1")
        if self.demodulate_albedo and not self.variance_guided:
            # The parity w_l uses a FIXED sigma_l; demodulation rescales
            # irradiance per surface (1/albedo luminance), so un-normalized
            # weights stop smoothing dark-albedo surfaces (verified
            # visually: heavy residual speckle). The variance-normalized
            # w_l is scale-invariant, which is the combination SVGF
            # actually describes.
            raise ValueError(
                "demodulate_albedo requires variance_guided=True (the "
                "fixed-sigma parity luminance weight is not invariant to "
                "the demodulation rescale)"
            )
        if self.accumulation_ramp and not (0.0 < self.ramp_alpha_min <= 1.0):
            raise ValueError("ramp_alpha_min must be in (0, 1]")
        if self.ramp_reset_mode not in ("id", "normal"):
            raise ValueError("ramp_reset_mode must be 'id' or 'normal'")
        if self.firefly_clamp < 0.0:
            raise ValueError("firefly_clamp must be >= 0 (0 = off)")
        if self.path_gradient and not (
            self.adaptive_alpha or self.accumulation_ramp
        ):
            # lam only feeds adaptive alpha and the ramp reset; computing
            # the re-trace without a consumer is pure waste.
            raise ValueError(
                "path_gradient requires adaptive_alpha or accumulation_ramp "
                "(nothing else consumes the gradient)"
            )
        if self.gradient_stratum < 1:
            raise ValueError("gradient_stratum must be >= 1")
        if self.indirect_split:
            if not (1 <= self.indirect_split < self.max_bounces):
                raise ValueError(
                    "indirect_split must be in [1, max_bounces) -- the "
                    "coarse tail must have at least one segment"
                )
            if self.indirect_stride < 1:
                raise ValueError("indirect_stride must be >= 1")
            if self.indirect_sigma_z <= 0.0:
                raise ValueError("indirect_sigma_z must be > 0")
            if self.indirect_normal_pow < 0:
                raise ValueError("indirect_normal_pow must be >= 0")
            if self.indirect_jitter and (
                self.width % self.indirect_stride
                or self.height % self.indirect_stride
            ):
                raise ValueError(
                    "indirect_jitter needs width and height divisible by "
                    "indirect_stride (the phased coarse grid must have a "
                    "static shape at every phase)"
                )
        elif self.indirect_jitter:
            raise ValueError("indirect_jitter requires indirect_split >= 1")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError("backend must be auto, xla or pallas")

    @property
    def resolution(self) -> tuple[int, int]:
        """(width, height), matching the reference's pixel convention."""
        return (self.width, self.height)


# Reference-default config, shared by tests/benchmarks.
REFERENCE_CONFIG = RenderConfig()
