// Per-ray BVH traversal: one thread walks one ray with a short stack.
//
// Software stand-in for optixTrace over the reference's GAS (cuProg.h:387-533,
// sutil/Scene.cpp:943). The two ray types of optixPathTracer.h:202-209:
//   closest-hit  near-child-first walk, optional back-face culling;
//   any-hit      stops at the first blocker, never culls (cuProg.h:478).
//
// The tree is ops/bvh.py's flat BVH in depth-first order, packed by
// ops/bvh_gpu.py into two float4 per node:
//   lo = (min.xyz, w0)   w0 bits: interior -> right child, leaf -> tri count
//   hi = (max.xyz, w1)   w1 bits: leaf -> first triangle, interior -> -1
// The left child of interior node i is i + 1. Triangles are three float4
// each: (p0.xyz, e1.x) (e1.yz, e2.xy) (e2.z, -, -, -).
//
// The triangle test matches ops/intersect.py (the brute-force oracle): the
// same Moller-Trumbore arithmetic and determinant epsilon. The functions
// compile for the device under nvcc and for the host otherwise, so the walk
// is tested on the CPU (tests/test_bvh_gpu.py) against the same oracle.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define SPCBPT_FN __device__ __forceinline__
#else
#define SPCBPT_FN inline
struct alignas(16) float4 {
  float x, y, z, w;
};
#endif

namespace spcbpt {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
// Both builders turn every node deeper than 60 into a leaf, so a walk holds
// at most 61 deferred far children.
constexpr int kStack = 64;

struct V3 {
  float x, y, z;
};

SPCBPT_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
SPCBPT_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
SPCBPT_FN V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

SPCBPT_FN float4 load4(const float4 *p) {
#ifdef __CUDACC__
  return __ldg(p);
#else
  return *p;
#endif
}

SPCBPT_FN int32_t as_int(float f) {
#ifdef __CUDACC__
  return __float_as_int(f);
#else
  int32_t i;
  std::memcpy(&i, &f, sizeof(i));
  return i;
#endif
}

// Entry and exit of the slab [lo, hi] along one axis. A ray parallel to the
// slab is inside it for every t when lo <= o <= hi and never otherwise, so
// a ray lying in a box face (an axis-aligned wall seen edge-on) still enters
// the box, as the brute-force oracle's inclusive edge test requires.
SPCBPT_FN void slab_axis(float lo, float hi, float o, float d, float inv,
                         float *t0, float *t1) {
  if (fabsf(d) < 1e-30f) {
    bool inside = lo <= o && o <= hi;
    *t0 = inside ? -kBig : kBig;
    *t1 = inside ? kBig : -kBig;
  } else {
    float a = (lo - o) * inv, b = (hi - o) * inv;
    *t0 = fminf(a, b);
    *t1 = fmaxf(a, b);
  }
}

// Slab test of [tmin, tmax] against a node box; *tnear is the entry
// distance. The exit distance is widened by 1 + 2*gamma(3) (Ize, "Robust BVH
// ray traversal", 2013) so that rounding never drops a box whose triangle
// the Moller-Trumbore test would hit.
SPCBPT_FN bool slab(const float4 *node, V3 o, V3 d, V3 inv, float tmin,
                    float tmax, float *tnear) {
  float4 lo = load4(node), hi = load4(node + 1);
  float x0, x1, y0, y1, z0, z1;
  slab_axis(lo.x, hi.x, o.x, d.x, inv.x, &x0, &x1);
  slab_axis(lo.y, hi.y, o.y, d.y, inv.y, &y0, &y1);
  slab_axis(lo.z, hi.z, o.z, d.z, inv.z, &z0, &z1);
  float t_in = fmaxf(fmaxf(x0, y0), fmaxf(z0, tmin));
  float t_out = fminf(fminf(x1, y1) * 1.0000004f, fminf(z1 * 1.0000004f, tmax));
  *tnear = t_in;
  return t_in <= t_out;
}

// Moller-Trumbore against triangle `tri`; true for a hit in (tmin, tmax).
SPCBPT_FN bool tri_hit(const float4 *tris, int32_t tri, V3 o, V3 d, bool cull,
                       float tmin, float tmax, float *t, float *u, float *v) {
  float4 a = load4(tris + 3 * tri), b = load4(tris + 3 * tri + 1),
         c = load4(tris + 3 * tri + 2);
  V3 p0{a.x, a.y, a.z}, e1{a.w, b.x, b.y}, e2{b.z, b.w, c.x};
  V3 pv = cross(d, e2);
  float det = dot(e1, pv);
  if (!(cull ? det > kEpsDet : fabsf(det) > kEpsDet)) return false;
  float inv = 1.0f / det;
  V3 tv = sub(o, p0);
  float uu = dot(tv, pv) * inv;
  V3 qv = cross(tv, e1);
  float vv = dot(d, qv) * inv;
  float tt = dot(e2, qv) * inv;
  if (!(uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin && tt < tmax))
    return false;
  *t = tt;
  *u = uu;
  *v = vv;
  return true;
}

// Walks the tree for one ray. kAny stops at the first hit in (tmin, tmax);
// otherwise *best_t shrinks to the nearest hit and far subtrees whose entry
// lies beyond it are skipped. Returns true when some triangle was hit.
template <bool kAny>
SPCBPT_FN bool walk(const float4 *nodes, const float4 *tris, V3 o, V3 d,
                    float tmin, float *best_t, bool cull, int32_t *best_tri,
                    float *best_u, float *best_v) {
  V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int32_t stack[kStack];
  float stack_t[kStack];
  int sp = 0;
  float tn;
  if (!(tmin <= *best_t) || !slab(nodes, o, d, inv, tmin, *best_t, &tn))
    return false;
  bool found = false;
  int32_t node = 0;
  while (true) {
    float4 lo = load4(nodes + 2 * node), hi = load4(nodes + 2 * node + 1);
    int32_t first = as_int(hi.w);
    if (first >= 0) {
      int32_t count = as_int(lo.w);
      for (int32_t k = first; k < first + count; ++k) {
        float t, u, v;
        if (tri_hit(tris, k, o, d, cull, tmin, *best_t, &t, &u, &v)) {
          found = true;
          if (kAny) return true;
          *best_t = t;
          *best_tri = k;
          *best_u = u;
          *best_v = v;
        }
      }
    } else {
      int32_t l = node + 1, r = as_int(lo.w);
      float tl, tr;
      bool hl = slab(nodes + 2 * l, o, d, inv, tmin, *best_t, &tl);
      bool hr = slab(nodes + 2 * r, o, d, inv, tmin, *best_t, &tr);
      if (hl && hr) {
        bool left_first = tl <= tr;
        stack[sp] = left_first ? r : l;
        stack_t[sp] = left_first ? tr : tl;
        ++sp;
        node = left_first ? l : r;
        continue;
      }
      if (hl || hr) {
        node = hl ? l : r;
        continue;
      }
    }
    // pop the nearest deferred subtree that can still hold a closer hit
    while (sp > 0 && stack_t[sp - 1] > *best_t) --sp;
    if (sp == 0) break;
    node = stack[--sp];
  }
  return found;
}

// One ray of a closest-hit wavefront: miss -> t = kBig, tri = -1, u = v = 0.
// A dead lane (tmax < tmin) does no work and misses.
SPCBPT_FN void closest_ray(int64_t i, const float *origins, const float *dirs,
                           const float *tmin, const float *tmax,
                           const float4 *nodes, const float4 *tris, bool cull,
                           float *out_t, int32_t *out_tri, float *out_u,
                           float *out_v) {
  V3 o{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  V3 d{dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  float best_t = fminf(tmax[i], kBig);
  int32_t best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool hit = walk<false>(nodes, tris, o, d, tmin[i], &best_t, cull, &best_tri,
                         &best_u, &best_v);
  out_t[i] = hit ? best_t : kBig;
  out_tri[i] = best_tri;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

// One ray of an any-hit wavefront: 1 when a triangle blocks (tmin, tmax).
SPCBPT_FN void any_ray(int64_t i, const float *origins, const float *dirs,
                       const float *tmin, const float *tmax,
                       const float4 *nodes, const float4 *tris,
                       int32_t *out_occluded) {
  V3 o{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  V3 d{dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
  float t = tmax[i];
  int32_t tri;
  float u, v;
  out_occluded[i] = walk<true>(nodes, tris, o, d, tmin[i], &t, false, &tri,
                               &u, &v);
}

}  // namespace spcbpt
