// CUDA kernels for closest-hit and any-hit BVH traversal, one thread per
// ray, exposed to JAX through the XLA FFI (see ops/bvh_gpu.py, which builds
// this file with nvcc at first use and registers the handlers).
//
// The walk itself is in bvh_trace.cuh. Nodes and triangles are read through
// the read-only cache; at the bundled scenes' sizes they stay in L2.
#include <cuda_runtime.h>

#include "bvh_trace.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

__global__ void closest_kernel(int64_t n, const float *origins,
                               const float *dirs, const float *tmin,
                               const float *tmax, const float4 *nodes,
                               const float4 *tris, bool cull, float *out_t,
                               int32_t *out_tri, float *out_u, float *out_v) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n)
    spcbpt::closest_ray(i, origins, dirs, tmin, tmax, nodes, tris, cull, out_t,
                        out_tri, out_u, out_v);
}

__global__ void any_kernel(int64_t n, const float *origins, const float *dirs,
                           const float *tmin, const float *tmax,
                           const float4 *nodes, const float4 *tris,
                           int32_t *out_occluded) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n)
    spcbpt::any_ray(i, origins, dirs, tmin, tmax, nodes, tris, out_occluded);
}

int grid_for(int64_t n) { return (int)((n + kBlock - 1) / kBlock); }

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

const float4 *as_f4(const ffi::Buffer<ffi::F32> &b) {
  return reinterpret_cast<const float4 *>(b.typed_data());
}

ffi::Error closest_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> origins,
                        ffi::Buffer<ffi::F32> dirs, ffi::Buffer<ffi::F32> tmin,
                        ffi::Buffer<ffi::F32> tmax, ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::F32> tris,
                        ffi::ResultBuffer<ffi::F32> t,
                        ffi::ResultBuffer<ffi::S32> tri,
                        ffi::ResultBuffer<ffi::F32> u,
                        ffi::ResultBuffer<ffi::F32> v, int32_t cull) {
  int64_t n = tmin.element_count();
  if (n == 0) return ffi::Error::Success();
  closest_kernel<<<grid_for(n), kBlock, 0, stream>>>(
      n, origins.typed_data(), dirs.typed_data(), tmin.typed_data(),
      tmax.typed_data(), as_f4(nodes), as_f4(tris), cull != 0,
      t->typed_data(), tri->typed_data(), u->typed_data(), v->typed_data());
  return launch_status();
}

ffi::Error any_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> origins,
                    ffi::Buffer<ffi::F32> dirs, ffi::Buffer<ffi::F32> tmin,
                    ffi::Buffer<ffi::F32> tmax, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> tris,
                    ffi::ResultBuffer<ffi::S32> occluded) {
  int64_t n = tmin.element_count();
  if (n == 0) return ffi::Error::Success();
  any_kernel<<<grid_for(n), kBlock, 0, stream>>>(
      n, origins.typed_data(), dirs.typed_data(), tmin.typed_data(),
      tmax.typed_data(), as_f4(nodes), as_f4(tris), occluded->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SpcbptBvhClosest, closest_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origins
                                  .Arg<ffi::Buffer<ffi::F32>>()  // dirs
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmin
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmax
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
                                  .Attr<int32_t>("cull"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(SpcbptBvhAny, any_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origins
                                  .Arg<ffi::Buffer<ffi::F32>>()  // dirs
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmin
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmax
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Ret<ffi::Buffer<ffi::S32>>());  // occluded
