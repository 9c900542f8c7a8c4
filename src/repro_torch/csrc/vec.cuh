// Loads and stores shared by the port's LoRA kernels: a value or a 16-byte
// vector of float32 or bfloat16, widened to float32; float4 stores that
// take a row's last partial vector.
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
// widened values take N), widen() converts them later. raw_n() reads the
// first n <= N values one at a time, from any address, and gives the rest
// the bits of +0.0.
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 raw(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static uint4 raw_n(const float* p, int n) {
    return make_uint4(n > 0 ? __float_as_uint(p[0]) : 0u,
                      n > 1 ? __float_as_uint(p[1]) : 0u,
                      n > 2 ? __float_as_uint(p[2]) : 0u,
                      n > 3 ? __float_as_uint(p[3]) : 0u);
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
  __device__ __forceinline__ static uint4 raw_n(const __nv_bfloat16* p,
                                                int n) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = 2 * i < n ? __bfloat16_as_ushort(p[2 * i]) : 0u;
      const unsigned hi =
          2 * i + 1 < n ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
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

// The vector of the n values at p: raw() when full (all N wanted, p 16-byte
// aligned: the caller knows it for a whole launch), else raw_n().
template <typename T>
__device__ __forceinline__ uint4 raw_at(const T* p, int n, bool full) {
  return full ? Vec<T>::raw(p)
              : Vec<T>::raw_n(p, n < Vec<T>::N ? n : Vec<T>::N);
}

// The first n values of v at p: one float4 when vec (n >= 4 and p 16-byte
// aligned), else one value at a time.
__device__ __forceinline__ void store4(float* p, const float4& v, int n,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

}  // namespace repro
