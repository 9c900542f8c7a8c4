// Loads shared by the port's LoRA kernels: a value or a 16-byte vector of
// float32 or bfloat16, widened to float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Vec<T>::N values of T in 16 bytes; load() reads them from a 16-byte
// aligned address and widens them to float.
template <typename T>
struct Vec;

// raw() reads the 16 bytes without widening them (4 registers, where the
// widened values take N), widen() converts them later.
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 raw(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void widen(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    widen(raw(p), out);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static uint4 raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void widen(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    widen(raw(p), out);
  }
};

}  // namespace repro
