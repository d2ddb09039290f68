// One path segment's shading, shared by the one-launch tracer
// (pathtrace.cu trace_kernel) and the segment tracer (wavefront.cu
// trace_segment), so that the two cannot drift: ops/pathtrace.bounce_step
// with its nearest-hit query, the sphere light, first-hit dimming, the
// normal-keyed albedo, the unit-sphere diffuse bounce, next-event
// estimation and Russian roulette, draw for draw.
//
// The scene is a template parameter: ``DenseTable`` tests every triangle
// of a shared-memory table in index order, ``BvhTable`` walks the LBVH
// (bvh.cuh). Both give the same hit, so the two tracers give the same bits.
#pragma once

#include "bvh.cuh"

namespace ptsf {

constexpr float kInvPi = (float)(1.0 / 3.14159265);

struct TraceArgs {
  int width, height, frame, max_bounces, spp, batches;
  float slope, aa_sigma, ray_eps, t_max, eps, light_r, light_r2, first_dim;
  int light_through_walls, rr_start, truncate;
  float rr_min, rr_max;
};

// A dense table row (ops/cuda/pathtrace.pack_table): n, d0 | n1, d1 |
// n2, d2 (the 12 test constants, floats 0-11) | v0 e1 e2 (12-20) | unit
// normal (21-23) | albedo (24-26). In shared memory a row takes 32 floats
// (128 bytes, the last 5 unused), so a test reads its constants as three
// 16-byte loads.
constexpr int kRowFloats = 27;
constexpr int kRowVec = 8;

// Copy the (rows, 27) table into 128-byte shared-memory rows, all threads
// of a 1-D block.
__device__ __forceinline__ void stage_rows(float4* dst, const float* __restrict__ src, int rows) {
  float* d = reinterpret_cast<float*>(dst);
  for (int i = threadIdx.x; i < rows * kRowFloats; i += blockDim.x) {
    int r = i / kRowFloats;
    d[r * 4 * kRowVec + (i - r * kRowFloats)] = __ldg(src + i);
  }
}

// The dense scene: a shared-memory table, every triangle tested in index
// order.
struct DenseTable {
  const float4* tab;
  int num_tris;

  __device__ __forceinline__ bool test(int i, V3 o, V3 d, float t_max, float eps, float& t,
                                       float& u, float& v) const {
    const float4* r = tab + i * kRowVec;
    float4 a = r[0], b = r[1], e = r[2];
    return tri_test(v3(a.x, a.y, a.z), a.w, v3(b.x, b.y, b.z), b.w, v3(e.x, e.y, e.z), e.w, o, d,
                    t_max, eps, t, u, v);
  }
  __device__ __forceinline__ const float* row(int prim) const {
    return reinterpret_cast<const float*>(tab + prim * kRowVec);
  }

  // argmin over t_cand (invalid -> 2 t_max) takes the first minimum: a
  // strict < in triangle order does the same (geometry.cu tile_nearest_hit).
  template <bool kCount>
  __device__ __forceinline__ Hit nearest(V3 o, V3 d, float t_max, float eps, Counts& c) const {
    if (kCount) c.tri += num_tris;
    float best = INFINITY;
    Hit h = {false, 0, 0.0f, 0.0f, 0.0f};
    const float miss_t = 2.0f * t_max;
    for (int i = 0; i < num_tris; ++i) {
      if (kCount) count_lanes(c.walk_lanes, c.walk_steps);
      float t, u, v;
      bool valid = test(i, o, d, t_max, eps, t, u, v);
      float t_cand = valid ? t : miss_t;
      if (t_cand < best) {
        best = t_cand;
        h = {valid, i, t, u, v};
      }
    }
    if (!h.hit) return {false, 0, t_max, 0.0f, 0.0f};
    return h;
  }
  // Whether any triangle is hit at a distance t <= cap: the same boolean
  // as "the nearest hit is at t <= cap", since the nearest valid t is <=
  // cap exactly when some valid t is. Stops at the first such triangle.
  template <bool kCount>
  __device__ __forceinline__ bool occluded(V3 o, V3 d, float cap, float t_max, float eps,
                                           Counts& c) const {
    for (int i = 0; i < num_tris; ++i) {
      if (kCount) {
        ++c.tri;
        count_lanes(c.walk_lanes, c.walk_steps);
      }
      float t, u, v;
      if (test(i, o, d, t_max, eps, t, u, v) && t <= cap) return true;
    }
    return false;
  }
  __device__ __forceinline__ V3 normal(int prim) const { return load3(row(prim) + 21); }
  __device__ __forceinline__ V3 albedo(int prim) const { return load3(row(prim) + 24); }
  __device__ __forceinline__ V3 position(const Hit& h) const {
    const float* r = row(h.prim);
    return add(add(load3(r + 12), scale(h.u, load3(r + 15))), scale(h.v, load3(r + 18)));
  }
};

// The LBVH scene: walks in global memory, attributes read once per hit.
struct BvhTable {
  BvhScene s;

  template <bool kCount>
  __device__ __forceinline__ Hit nearest(V3 o, V3 d, float t_max, float eps, Counts& c) const {
    return bvh_nearest_hit<kCount>(s, o, d, t_max, eps, c);
  }
  template <bool kCount>
  __device__ __forceinline__ bool occluded(V3 o, V3 d, float cap, float t_max, float eps,
                                           Counts& c) const {
    return bvh_any_hit_within<kCount>(s, o, d, cap, t_max, eps, c);
  }
  __device__ __forceinline__ V3 normal(int prim) const { return load3(s.normals + 3 * prim); }
  __device__ __forceinline__ V3 albedo(int prim) const { return load3(s.albedo + 3 * prim); }
  __device__ __forceinline__ V3 position(const Hit& h) const {
    int p = 3 * h.prim;
    return add(add(load3(s.v0 + p), scale(h.u, load3(s.e1 + p))), scale(h.v, load3(s.e2 + p)));
  }
};

// checkRayLightIntersection (ops/intersect.ray_sphere)
__device__ __forceinline__ bool ray_sphere(V3 o, V3 d, V3 center, float r2, float& t_out) {
  V3 oc = sub(o, center);
  float a = dot(d, d);
  float b = 2.0f * dot(oc, d);
  float c = dot(oc, oc) - r2;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  float t = t1 > 0.0f ? t1 : t2;
  bool hit = disc >= 0.0f && t > 0.0f;
  t_out = hit ? t : 0.0f;
  return hit;
}

// skyColor (ops/shading.sky_color)
__device__ __forceinline__ V3 sky(V3 d) {
  float y = d.y;
  if (!(y > 0.0f)) return {0.03f, 0.03f, 0.03f};
  float s = 1.0f - y;
  return {s * 1.0f + y * 0.25f, s * 1.0f + y * 0.5f, s * 1.0f + y * 1.0f};
}

// The light sample of next-event estimation at the bounce vertex o
// (ops/pathtrace._nee_sample): draws two uniforms; returns whether the
// sample can contribute (cos_x > 0 and the ray meets the sphere), with the
// direction, the sphere-entry distance and the contribution if unoccluded.
__device__ __forceinline__ bool nee_light_sample(V3 o, V3 n_ff, V3 accum, uint32_t& state,
                                                 V3 light_pos, V3 light_hdr, const TraceArgs& a,
                                                 V3& w_l, float& s_t, V3& bank) {
  V3 to_l = sub(light_pos, o);
  float safe_dist = fmaxf(norm(to_l), 1e-20f);
  V3 wc = div(to_l, safe_dist);
  float sin_max = fminf(fmaxf(a.light_r / safe_dist, 0.0f), 1.0f);
  float cos_max = sqrtf(fmaxf(1.0f - sin_max * sin_max, 0.0f));
  float u1 = pcg_step(state);
  float u2 = pcg_step(state);
  float cos_t = 1.0f - u1 * (1.0f - cos_max);
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = kTwoPi * u2;
  V3 axis = fabsf(wc.x) > 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  V3 tang = cross(axis, wc);
  tang = div(tang, fmaxf(norm(tang), 1e-20f));
  V3 bitang = cross(wc, tang);
  w_l = add(add(scale(cos_t, wc), scale(sin_t * cosf(phi), tang)), scale(sin_t * sinf(phi), bitang));
  float cos_x = dot(n_ff, w_l);
  bool s_hit = ray_sphere(o, w_l, light_pos, a.light_r2, s_t);
  if (!(cos_x > 0.0f) || !s_hit) return false;
  float omega = kTwoPi * (1.0f - cos_max);
  float gain = cos_x * omega * kInvPi;
  bank = scale(gain, mul(accum, light_hdr));
  return true;
}

// A path's state between segments (the wavefront tracer keeps it in
// device memory; alive is the return value of bounce()).
struct PathState {
  V3 o, d, accum, result;
  uint32_t state;
};

// Segment ``seg`` of a path (ops/pathtrace.bounce_step on one lane):
// returns false when the path ends here. kNee / kRr compile next-event
// estimation and Russian roulette in or out, kCount the work counters.
template <bool kNee, bool kRr, bool kCount, class Scene>
__device__ __forceinline__ bool bounce(const Scene& sc, int seg, PathState& p, V3 light_pos,
                                       V3 light_hdr, const TraceArgs& a, Counts& c) {
  Hit h = sc.template nearest<kCount>(p.o, p.d, a.t_max, a.eps, c);
  float light_t;
  bool light_hit = ray_sphere(p.o, p.d, light_pos, a.light_r2, light_t);
  if (!a.light_through_walls || kNee) light_hit = light_hit && (!h.hit || light_t < h.t);
  if (light_hit) {  // light termination, checked first (raytrace:226-235)
    // under NEE only the camera segment adds the emission
    if (!kNee || seg == 0) {
      float dim = seg == 0 ? a.first_dim : 1.0f;
      p.result = scale(dim, mul(p.accum, light_hdr));
    }
    return false;
  }
  if (!h.hit) {  // sky termination (raytrace:263-268); NEE adds to its bank
    V3 sky_c = mul(p.accum, sky(p.d));
    p.result = kNee ? add(p.result, sky_c) : sky_c;
    return false;
  }
  // diffuse bounce (raytrace:238-262)
  p.accum = mul(p.accum, sc.albedo(h.prim));
  V3 n = sc.normal(h.prim);
  V3 n_ff = dot(p.d, n) < 0.0f ? n : neg(n);
  p.o = add(sc.position(h), scale(a.ray_eps, n_ff));
  V3 nd = add(n_ff, random_unit_sphere(p.state));
  p.d = div(nd, norm(nd));
  if (kNee) {
    V3 w_l, bank;
    float s_t;
    if (nee_light_sample(p.o, n_ff, p.accum, p.state, light_pos, light_hdr, a, w_l, s_t, bank) &&
        !sc.template occluded<kCount>(p.o, w_l, s_t, a.t_max, a.eps, c)) {
      p.result = add(p.result, bank);
    }
  }
  if (kRr && seg >= a.rr_start) {  // Russian roulette
    float u = pcg_step(p.state);
    float pr = fminf(fmaxf(fmaxf(fmaxf(p.accum.x, p.accum.y), p.accum.z), a.rr_min), a.rr_max);
    if (!(u < pr)) return false;  // killed: keeps its result, takes no fall-through
    p.accum = div(p.accum, pr);
  }
  return true;
}

}  // namespace ptsf
