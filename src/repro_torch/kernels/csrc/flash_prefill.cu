// Chunked-causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_attention` (src/repro/kernels/
// flash_prefill.py, wrapper :105, kernel body `_flash_kernel` :36): the
// `attn` operator of every prefill segment. A query chunk q (B,Sq,H,hd)
// sits at absolute position q_offset and attends to keys k/v (B,T,K,hd)
// below kv_len, causally, optionally within a local window, or without the
// causal mask. Query head h reads KV head h / (H/K) in place: no KV copy.
//
// What bounds it on the H100: work. A 512-token chunk over a 4096-token
// prefix (Llama3-8B, H 32, K 8, hd 128) does ~32 GFLOP against ~24 MB of
// q/k/v/o in bf16, about 1300 FLOP per byte, far above the card's ~295 bf16
// FLOP per byte of HBM, so the bound is the arithmetic rate. This first kernel does that
// arithmetic on the CUDA cores in f32 (FMA, never TF32: the f32 tolerance is
// 2e-5), so it runs against the 67 TFLOP/s f32 rate and not the 989 TFLOP/s
// bf16 tensor-core rate; wgmma, TMA and warp specialisation are later work.
//
// What the design does about it:
//  * One block per (64-query tile, b*H+h); the KV loop is inside the block
//    (a TPU grid runs in order on one core, Hopper runs blocks in parallel).
//  * Four threads own one query row. Each keeps its quarter of the row's q
//    and of the f32 accumulator in registers, together with the online-
//    softmax state (m, l) and the row's 32 scores of the current tile, so
//    the softmax never touches shared or device memory.
//  * K/V tiles of 32 keys are staged in shared memory in the input type
//    (bf16: 2 x 32 x 128 x 2 B = 16 KB) and read by every row of the block;
//    the four threads of a row read 4 consecutive 4-element vectors, so the
//    reads are free of bank conflicts and broadcast across rows.
//  * Whole tiles above the causal diagonal, at or past kv_len, or below the
//    local window are skipped by the loop bounds; inside a tile, p is zeroed
//    under the mask after the exp, and a row with l == 0 writes 0.
//  * q_offset, kv_len, causal and the window are runtime arguments: no chunk
//    position or resume respecialises or rebuilds anything. The ragged Sq
//    and T edges are masked here, so the wrapper makes no padded copies.
#include <math.h>

#include "vec.cuh"

namespace {

using repro::NEG_INF;
using repro::VEC;
using repro::pack;
using repro::unpack;

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int G = 4;                   // threads per query row
constexpr int NTHREADS = BQ * G;

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               int Sq, int T_len, int H, int K,
               long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, long long o_sb, long long o_ss,
               int q_offset, int kv_len, int causal, int window, float scale) {
  using VT = typename repro::Vec4<T>::type;
  constexpr int NV = HD / VEC;         // vectors per row
  constexpr int NC = NV / G;           // vectors per thread
  __shared__ VT k_s[BK][NV];
  __shared__ VT v_s[BK][NV];

  const int tid = threadIdx.x;
  const int r = tid / G;               // query row within the tile
  const int g = tid % G;               // quarter of the head dim
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);
  const int q_start = blockIdx.x * BQ;
  const int row = q_start + r;
  const int qpos = q_offset + row;
  const bool row_ok = row < Sq;

  float qr[NC * VEC];
  float acc[NC * VEC];
  {
    const VT* qp = reinterpret_cast<const VT*>(q + b * q_sb + (long long)row * q_ss + h * HD);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      VT x = row_ok ? qp[c * G + g] : VT{};
      unpack(x, &qr[c * VEC]);
    }
  }
#pragma unroll
  for (int i = 0; i < NC * VEC; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  // block-level tile bounds (the reference's skip tests)
  const int kv_end = min(kv_len, T_len);
  const int q_lo = q_offset + q_start;
  const int q_hi = q_offset + min(q_start + BQ, Sq) - 1;
  int k_stop = kv_end;
  if (causal) k_stop = min(k_stop, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k_lo = k_begin; k_lo < k_stop; k_lo += BK) {
    for (int i = tid; i < BK * NV; i += NTHREADS) {
      const int j = i / NV;
      const int c = i % NV;
      const int key = k_lo + j;
      VT kx = VT{}, vx = VT{};
      if (key < kv_end) {
        kx = reinterpret_cast<const VT*>(k + b * k_sb + (long long)key * k_ss + kvh * HD)[c];
        vx = reinterpret_cast<const VT*>(v + b * v_sb + (long long)key * v_ss + kvh * HD)[c];
      }
      k_s[j][c] = kx;
      v_s[j][c] = vx;
    }
    __syncthreads();

    float s[BK];
    unsigned int keep = 0u;
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kf[VEC];
        unpack(k_s[j][c * G + g], kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qr[c * VEC + e], kf[e], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k_lo + j;
      bool ok = kp < kv_end;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? part * scale : NEG_INF;
      keep |= (ok ? 1u : 0u) << j;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // zero p under the mask after the exp: a row whose every key in this
      // tile is masked would otherwise get exp(0) = 1 from the -1e30 fill
      s[j] = ((keep >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      l_tile += s[j];
    }
    l_run = l_run * alpha + l_tile;
#pragma unroll
    for (int i = 0; i < NC * VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vf[VEC];
        unpack(v_s[j][c * G + g], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c * VEC + e] = fmaf(s[j], vf[e], acc[c * VEC + e]);
      }
    }
    m_run = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float inv = 1.f / (l_run == 0.f ? 1.f : l_run);
    VT* op = reinterpret_cast<VT*>(o + b * o_sb + (long long)row * o_ss + h * HD);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = acc[c * VEC + e] * inv;
      pack(out, &op[c * G + g]);
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
            int T_len, int H, int K, long long q_sb, long long q_ss,
            long long k_sb, long long k_ss, long long v_sb, long long v_ss,
            long long o_sb, long long o_ss, int q_offset, int kv_len,
            int causal, int window, float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  prefill_kernel<T, HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, T_len, H, K, q_sb,
      q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, q_offset, kv_len, causal,
      window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the (head, dim)
// axes of q, k, v and o are dense. Returns cudaGetLastError() after launch.
extern "C" int flash_prefill_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int T_len, int H, int K, int hd, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long o_sb, long long o_ss, int q_offset, int kv_len, int causal,
    int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PREFILL_CASE(TYPE, HDV)                                        \
  launch<TYPE, HDV>(q, k, v, o, B, Sq, T_len, H, K, q_sb, q_ss, k_sb, k_ss,  \
                    v_sb, v_ss, o_sb, o_ss, q_offset, kv_len, causal, window, \
                    scale, s)
#define REPRO_PREFILL_HD(TYPE)                         \
  switch (hd) {                                        \
    case 16: REPRO_PREFILL_CASE(TYPE, 16); break;      \
    case 32: REPRO_PREFILL_CASE(TYPE, 32); break;      \
    case 64: REPRO_PREFILL_CASE(TYPE, 64); break;      \
    case 128: REPRO_PREFILL_CASE(TYPE, 128); break;    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (dtype == 0) {
    REPRO_PREFILL_HD(float)
  } else if (dtype == 1) {
    REPRO_PREFILL_HD(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PREFILL_HD
#undef REPRO_PREFILL_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
