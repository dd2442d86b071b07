// Helpers shared by the attention kernels: 4-element vector accesses of f32
// or bf16 tensors, widened to f32 on load and narrowed on store, and the
// reference's mask fill.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int VEC = 4;                 // elements per vector access
constexpr float NEG_INF = -1e30f;      // the reference's mask fill

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void unpack(const float4& x, float* o) {
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void unpack(const uint2& x, float* o) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void pack(const float* i, float4* o) {
  *o = make_float4(i[0], i[1], i[2], i[3]);
}

__device__ __forceinline__ void pack(const float* i, uint2* o) {
  __nv_bfloat162 a = __floats2bfloat162_rn(i[0], i[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(i[2], i[3]);
  o->x = *reinterpret_cast<unsigned int*>(&a);
  o->y = *reinterpret_cast<unsigned int*>(&b);
}

}  // namespace repro
