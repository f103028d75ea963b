// Device helpers the wkv6 forward (csrc/wkv6.cu) and backward
// (csrc/wkv6_bwd.cu) tensor-core kernels share: the cluster barrier,
// bf16 pair loads and stores, and the hardware 2^x every exponential of
// those kernels is taken with.  Header-only (kernels/_build.py hashes it
// into every library's name).

#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float2 bf2_to_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf2(__nv_bfloat16* p, float a,
                                          float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// 2^x by the hardware's approximation (flushes subnormal results to 0);
// every argument here is a difference of cumulative log2-decays.
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
