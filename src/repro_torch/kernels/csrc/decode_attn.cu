// Flash-decode GQA attention for Hopper (sm_90a): one new query token per
// row against that row's KV view, with a per-row valid length.
//
// Replaces the TPU kernel `flash_decode_attention` (src/repro/kernels/
// decode_attn.py, wrapper :207, kernel body `_decode_kernel` :27), the
// attention of the ragged continuous-batching decode step. q (B,H,hd),
// k/v (B,T,K,hd), kv_len (B,) int32 on the device; row b attends to keys
// [0, kv_len[b]). A row with kv_len 0 (l == 0) writes 0.
//
// What bounds it on the H100: bytes. Every key of the row's prefix is read
// once and used for only Qg = H/K query heads (Llama3-8B: 4): 4*hd*Qg FLOP
// per key against 4*hd bytes of bf16 K/V, i.e. Qg FLOP per byte, two orders
// of magnitude under the card's ~295 FLOP per byte: the floor is the K/V
// bytes over 3.35 TB/s.
//
// What the design does about it:
//  * One block per (kv head, b). The block holds all Qg query rows of its KV
//    head in shared memory, so each streamed K/V tile serves every query
//    head that needs it and the cache is read exactly once.
//  * The block reads its own kv_len[b] from device memory (the TPU's scalar
//    prefetch) and streams 32-key tiles only up to it: tiles past kv_len are
//    never loaded, so the work follows each row's real context.
//  * The online-softmax state (m, l, and the f32 accumulator) never leaves
//    the block; scores and probabilities of a tile live in shared memory.
//  * Known limit, left to a later PR: with B <= 8 and K = 8 the grid has at
//    most 64 blocks for the card's 132 SMs, so at small batch it cannot
//    reach the HBM rate; a split-KV pass with a second reduce fixes that.
#include <math.h>

#include "vec.cuh"

namespace {

using repro::NEG_INF;
using repro::VEC;
using repro::unpack;

constexpr int DBK = 32;                // keys per tile (one per lane)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_QG = 16;             // query heads per KV head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ o, int T_len, int qg, long long q_sb,
              long long k_sb, long long k_ss, long long v_sb, long long v_ss,
              long long o_sb, float scale) {
  using VT = typename repro::Vec4<T>::type;
  constexpr int NV = HD / VEC;
  constexpr int EPT = MAX_QG * HD / NTHREADS;   // accumulator slots/thread
  __shared__ float q_s[MAX_QG][HD];
  __shared__ float k_s[DBK][HD + 1];            // +1: conflict-free dot rows
  __shared__ float v_s[DBK][HD];
  __shared__ float p_s[MAX_QG][DBK];
  __shared__ float m_s[MAX_QG], l_s[MAX_QG], alpha_s[MAX_QG];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * qg;                      // first query head
  const int rows = qg * HD;

  for (int i = tid; i < rows; i += NTHREADS) {
    q_s[i / HD][i % HD] = to_float(q[b * q_sb + (long long)h0 * HD + i]);
  }
  if (tid < qg) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
  const int kv_end = max(0, min(kv_len[b], T_len));
  __syncthreads();

  for (int k_lo = 0; k_lo < kv_end; k_lo += DBK) {
    for (int i = tid; i < DBK * NV; i += NTHREADS) {
      const int j = i / NV;
      const int c = i % NV;
      const int key = k_lo + j;
      float kf[VEC] = {0.f, 0.f, 0.f, 0.f};
      float vf[VEC] = {0.f, 0.f, 0.f, 0.f};
      if (key < kv_end) {
        unpack(reinterpret_cast<const VT*>(k + b * k_sb + (long long)key * k_ss + (long long)kvh * HD)[c], kf);
        unpack(reinterpret_cast<const VT*>(v + b * v_sb + (long long)key * v_ss + (long long)kvh * HD)[c], vf);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[j][c * VEC + e] = kf[e];
        v_s[j][c * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: one (query row, key) pair per thread and step
    for (int i = tid; i < qg * DBK; i += NTHREADS) {
      const int r = i / DBK;
      const int j = i % DBK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(q_s[r][d], k_s[j][d], dot);
      p_s[r][j] = (k_lo + j < kv_end) ? dot * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per key
    for (int r = warp; r < qg; r += NWARPS) {
      const float s = p_s[r][lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = (k_lo + lane < kv_end) ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, each thread owning fixed (row, dim) slots
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = tid + e * NTHREADS;
      if (idx < rows) {
        const int r = idx / HD;
        const int d = idx % HD;
        float a = acc[e] * alpha_s[r];
#pragma unroll 8
        for (int j = 0; j < DBK; ++j) a = fmaf(p_s[r][j], v_s[j][d], a);
        acc[e] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * NTHREADS;
    if (idx < rows) {
      const float l = l_s[idx / HD];
      store(o + b * o_sb + (long long)h0 * HD + idx, acc[e] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int* kv_len,
            void* o, int B, int T_len, int K, int qg, long long q_sb,
            long long k_sb, long long k_ss, long long v_sb, long long v_ss,
            long long o_sb, float scale, cudaStream_t stream) {
  dim3 grid(K, B);
  decode_kernel<T, HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), T_len, qg, q_sb,
      k_sb, k_ss, v_sb, v_ss, o_sb, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the (head, dim)
// axes of q, k, v and o are dense. kv_len is a (B,) int32 device array.
// Returns cudaGetLastError() after launch.
extern "C" int flash_decode_attention(
    const void* q, const void* k, const void* v, const int* kv_len, void* o,
    int dtype, int B, int T_len, int H, int K, int hd, long long q_sb,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long o_sb, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > MAX_QG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int qg = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(TYPE, HDV)                                        \
  launch<TYPE, HDV>(q, k, v, kv_len, o, B, T_len, K, qg, q_sb, k_sb, k_ss,  \
                    v_sb, v_ss, o_sb, scale, s)
#define REPRO_DECODE_HD(TYPE)                                \
  switch (hd) {                                              \
    case 16: REPRO_DECODE_CASE(TYPE, 16); break;             \
    case 32: REPRO_DECODE_CASE(TYPE, 32); break;             \
    case 64: REPRO_DECODE_CASE(TYPE, 64); break;             \
    case 128: REPRO_DECODE_CASE(TYPE, 128); break;           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (dtype == 0) {
    REPRO_DECODE_HD(float)
  } else if (dtype == 1) {
    REPRO_DECODE_HD(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_HD
#undef REPRO_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
