// Host build of the GPU traversal's per-ray walk (spcbpt_tpu/native/
// bvh_trace.cuh), so the CPU tests check the kernel's arithmetic and stack
// walk against the brute-force oracle. tests/test_bvh_gpu.py compiles it.
#include "bvh_trace.cuh"

extern "C" void closest_host(int64_t n, const float *origins,
                             const float *dirs, const float *tmin,
                             const float *tmax, const float *nodes,
                             const float *tris, int32_t cull, float *t,
                             int32_t *tri, float *u, float *v) {
  for (int64_t i = 0; i < n; ++i)
    spcbpt::closest_ray(i, origins, dirs, tmin, tmax,
                        reinterpret_cast<const float4 *>(nodes),
                        reinterpret_cast<const float4 *>(tris), cull != 0, t,
                        tri, u, v);
}

extern "C" void any_host(int64_t n, const float *origins, const float *dirs,
                         const float *tmin, const float *tmax,
                         const float *nodes, const float *tris,
                         int32_t *occluded) {
  for (int64_t i = 0; i < n; ++i)
    spcbpt::any_ray(i, origins, dirs, tmin, tmax,
                    reinterpret_cast<const float4 *>(nodes),
                    reinterpret_cast<const float4 *>(tris), occluded);
}
