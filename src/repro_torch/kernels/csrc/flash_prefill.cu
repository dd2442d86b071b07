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
// FLOP per byte of HBM, so the bound is the arithmetic rate.
//
// Four bodies; the C entry point picks one by dtype and head_dim:
//
// * bf16 at head_dim 64 or 128 (all of Llama3-8B's prefill attention):
//   `prefill_tc_kernel`, on the tensor cores.
//    - One block per (128-query tile, b*H+h) and three warpgroups: a
//      producer, of which one thread issues TMA, and two consumers that own
//      64 query rows each. `setmaxnreg` moves registers from the producer
//      (24) to the consumers (240).
//    - Q is loaded once; K and V tiles of 128 keys stream through a
//      three-stage ring in dynamic shared memory (225 KB at hd 128), each
//      stage guarded by a full and an empty mbarrier. Boxes are 64 columns
//      (128 bytes) with 128-byte swizzle, so hd 128 takes two per tile.
//    - S = Q K^T is a wgmma m64n128k16 with both operands in shared memory
//      (K is keys x hd, already K-major). The online softmax runs on the
//      accumulator fragment in registers: row max and sum over the lane
//      quad by shuffles, exp2 (ex2.approx) with log2(e) folded into the
//      scale, p zeroed under the mask after the exp, l summed from the f32
//      p. Element masks run in passes of their own, only on tiles that
//      cross kv_len, the diagonal or the window edge: folded into the
//      element loops they cost every tile about ten predicated compares,
//      selects and branches per score in the SASS. Row max and sum are
//      folded over 8 partial chains.
//    - O += P V takes P from registers (the S accumulator maps onto the
//      wgmma register-A fragment) and V from shared memory as an MN-major B.
//      P is split into two bf16 terms, P_hi = p cut to its top 16 bits and
//      P_lo = bf16(p - P_hi), and O += P_hi V + P_lo V in f32. One bf16 P
//      would round each weight by up to 2^-9 and put outputs near zero far
//      outside the port's bf16 check (1e-5 + 1.6e-2 |plain|); two terms
//      carry p to 2^-16 and leave only the output's own rounding, at 1.5x
//      the tensor-core work of one term.
//    - Overlap: each consumer issues tile t's S together with tile t-1's
//      P V and runs the softmax of tile t while P V runs; the two consumers
//      take turns to issue (a token on named barriers), so one's products
//      can run during the other's softmax (FA3's intra-warpgroup overlap
//      and ping-pong).
//    - The K/V tensor maps stop at min(kv_len, T) keys, so TMA zero-fills
//      every key past kv_len: a NaN left in a cache slot there never meets
//      a 0 * NaN in P V. Rows past Sq are not stored. No atomics and a fixed
//      order: equal inputs give equal bits, which a resumed prefill needs.
//    - cuTensorMapEncodeTiled is a driver function; it is fetched with
//      cudaGetDriverEntryPoint(ByVersion), so nothing links -lcuda. One
//      tensor map per operand and call, passed as a __grid_constant__
//      parameter, with the operand's real strides (a layer view of the
//      (L, B, max_seq, K, hd) cache goes in without a copy). TMA needs a
//      16-byte-aligned address and strides in multiples of 16 bytes; the
//      wrapper refuses anything else.
//    - Left for later: split-KV for short chunks (tail100@2048 gives 32
//      blocks), packing the 4 query heads of a KV head into one block, a
//      TMA store of O.
//
// * bf16 at q/k width 192 and v width 128 (latent attention's up-projected
//   heads, Kanana-2-30B-A3B): `prefill_mla_kernel`, the same body with the
//   q/k and v widths apart. Its bound is work too: a 512-token chunk over a
//   4096-token prefix (H 32, K 32) does 2 * 32 * (192 + 128) operations a
//   visible pair, ~39 GFLOP, against ~166 MB of q/k/v/o, ~235 FLOP per byte;
//   the first chunk of a prompt (~5.4 GFLOP, ~23 MB) is a little under the
//   card's 295. Q (192 columns, three boxes) and two stages of 128-key K
//   (192) and V (128) tiles take 208 KB of shared memory, where three
//   stages would take 288 KB. S takes 12 k-slices of Q K^T; P V, the O
//   accumulator (64 registers a thread) and the output are 128 wide, so the
//   consumers hold what they hold at head_dim 128. V is never padded to 192.
//
// * bf16 at head_dim 256 (RecurrentGemma's): `prefill_mma_kernel`, on the
//   tensor cores by mma.sync (its note is at the kernel). The wgmma body
//   does not fit there: Q and three stages of 128-key K and V tiles take
//   448 KB of shared memory at 256 columns, against 227 KB, and a 64-row O
//   accumulator is 128 f32 registers a thread before S and P.
//
// * f32 at every head_dim, and bf16 at head_dim 16 or 32: `prefill_kernel`,
//   f32 FMA on the CUDA cores (never TF32: the f32 tolerance is 2e-5).
//    - One block per (64-query tile, b*H+h); the KV loop is inside the
//      block (a TPU grid runs in order on one core, Hopper runs blocks in
//      parallel).
//    - Four threads own one query row. Each keeps its quarter of the row's
//      q and of the f32 accumulator in registers, together with the online-
//      softmax state (m, l) and the row's scores of the current tile, so
//      the softmax never touches shared or device memory.
//    - K/V tiles of 32 keys (16 for f32 at head_dim 256, so that the two
//      tiles stay within 48 KB of static shared memory) are staged in shared
//      memory in the input type and read by every row of the block; the
//      four threads of a row read 4 consecutive 4-element vectors, so the
//      reads are free of bank conflicts and broadcast across rows.
//    - Keys at or past kv_len are loaded as zeros.
//
// Both bodies skip whole tiles above the causal diagonal, at or past kv_len,
// or below the local window by their loop bounds; inside a tile p is zeroed
// under the mask after the exp, and a row with l == 0 writes 0. q_offset,
// kv_len, causal and the window are runtime arguments: no chunk position or
// resume respecialises or rebuilds anything. The ragged Sq and T edges are
// masked in the kernels, so the wrapper makes no padded copies.
#include <cuda.h>
#include <math.h>
#include <stdio.h>

#include "hopper.cuh"
#include "vec.cuh"

namespace {

using repro::NEG_INF;
using repro::VEC;
using repro::pack;
using repro::unpack;

constexpr int BQ = 64;                 // query rows per block
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
  // keys per shared-memory tile: K and V tiles take 2 * BK * HD * sizeof(T)
  constexpr int BK = sizeof(T) * HD > 512 ? 16 : 32;
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


namespace tc {

using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int BQ = 128;                // query rows per block, 64 per consumer
constexpr int BK = 128;                // keys per K/V tile
constexpr int STAGES = 3;              // K/V tiles in flight (GQA widths)
constexpr int MLA_STAGES = 2;          // at q/k 192 and v 128 (smem)
constexpr int BOX = 64;                // columns per TMA box: 128 bytes
constexpr int NTHREADS = 3 * 128;      // producer + two consumer warpgroups
constexpr int CONSUMERS = 2 * 128;     // arrivals that free a stage
constexpr float LOG2E = 1.4426950408889634f;

// QK: the q and k width, VD: the v (and output) width, NS: the stages
template <int QK, int VD, int NS>
struct Smem {
  // QK / BOX (VD / BOX) boxes of [rows][BOX] each, 128B-swizzled; every box
  // starts on a 1024-byte boundary (BQ * BOX * 2 and BK * BOX * 2 are
  // multiples)
  bf16 q[BQ * QK];
  bf16 k[NS][BK * QK];
  bf16 v[NS][BK * VD];
  uint64_t q_full;
  uint64_t full[NS];                   // the stage's K and V have landed
  uint64_t empty[NS];                  // both consumers are done with it
};

template <int QK, int VD, int NS>
constexpr size_t smem_bytes() {
  return sizeof(Smem<QK, VD, NS>) + 1024;   // room to align the base
}

// the O accumulator's product for one 16-key slice
template <int HD>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t d);
template <>
__device__ __forceinline__ void pv_mma<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t d) {
  wgmma_m64n64k16_rs(o, a, d);
}
template <>
__device__ __forceinline__ void pv_mma<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t d) {
  wgmma_m64n128k16_rs(o, a, d);
}

// The body of both tensor-core kernels: q/k of width QK, v and the output
// of width VD, NS stages of K/V tiles; the tensor maps are the kernel's
// __grid_constant__ parameters.
template <int QK, int VD, int NS>
__device__ __forceinline__ void tc_body(
    uint8_t* smem_raw, const CUtensorMap& tm_q, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, bf16* __restrict__ o, int Sq, int T_len, int H,
    int K, long long o_sb, long long o_ss, int q_offset, int kv_len,
    int causal, int window, float scale_log2) {
  Smem<QK, VD, NS>& sm = *reinterpret_cast<Smem<QK, VD, NS>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);
  const int q_start = blockIdx.x * BQ;

  // block-level tile bounds (the reference's skip tests)
  const int kv_end = min(kv_len, T_len);
  const int q_lo = q_offset + q_start;
  const int q_hi = q_offset + min(q_start + BQ, Sq) - 1;
  int k_stop = kv_end;
  if (causal) k_stop = min(k_stop, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_stop > k_begin ? (k_stop - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load ----------------------
    regs_release<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(&sm.q_full, BQ * QK * 2);
#pragma unroll
      for (int c = 0; c < QK / BOX; ++c)
        tma_load_4d(sm.q + c * BQ * BOX, &tm_q, &sm.q_full, c * BOX, h,
                    q_start, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        mbar_wait(&sm.empty[s], ((t / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], BK * (QK + VD) * 2);
        const int k_lo = k_begin + t * BK;
#pragma unroll
        for (int c = 0; c < (QK > VD ? QK : VD) / BOX; ++c) {
          if (c < QK / BOX)
            tma_load_4d(sm.k[s] + c * BK * BOX, &tm_k, &sm.full[s],
                        c * BOX, kvh, k_lo, b);
          if (c < VD / BOX)
            tma_load_4d(sm.v[s] + c * BK * BOX, &tm_v, &sm.full[s],
                        c * BOX, kvh, k_lo, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile --
  // Tile t's S = Q K^T is issued together with tile t-1's O += P V, so the
  // softmax of tile t runs while the tensor cores work on P V. The two
  // consumers take turns to issue (named barriers 1 and 2, a token passed
  // back and forth), so one's products run during the other's softmax.
  regs_claim<240>();
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128;
  const int lane = ct % 32;
  const int t4 = lane % 4;
  const int r0 = 64 * cw + 16 * ((ct % 128) / 32) + lane / 4;  // and r0 + 8
  const int wg_lo = q_lo + 64 * cw;    // positions of the warpgroup's rows
  const int wg_hi = wg_lo + 63;

  float acc[VD / 2];
#pragma unroll
  for (int i = 0; i < VD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // row max, in log2 units
  float l_run[2] = {0.f, 0.f};         // this thread's part of the row sums
  float alpha[2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];

  // S = Q K^T for the tile in stage st: hd / 16 slices, 32 bytes apart in a
  // box, boxes apart
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < QK / 16; ++kk) {
      const uint64_t da = sw128_desc(
          sm.q + (kk / 4) * BQ * BOX + 64 * cw * BOX + (kk % 4) * 16, 16,
          1024);
      const uint64_t db = sw128_desc(
          sm.k[st] + (kk / 4) * BK * BOX + (kk % 4) * 16, 16, 1024);
      wgmma_m64n128k16_ss(s, da, db, kk > 0 ? 1 : 0);
    }
  };
  // O += P_hi V + P_lo V for the tile in stage st: V's 16-key slices are
  // 2048 bytes apart
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(sm.v[st] + kk * 16 * BOX,
                                     BK * BOX * 2, 1024);
      pv_mma<VD>(acc, p_hi[kk], dv);
      pv_mma<VD>(acc, p_lo[kk], dv);
    }
  };
  // set every element of the tile at k_lo that its row may not see to
  // `fill`; rows r0 (i = 0) and r0 + 8 (i = 1)
  auto mask = [&](int k_lo, float fill) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q_lo + r0 + 8 * i;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k_lo + 8 * c + 2 * t4 + j;
          bool ok = key < kv_end;
          if (causal) ok = ok && key <= qpos;
          if (window > 0) ok = ok && key > qpos - window;
          if (!ok) s[4 * c + 2 * i + j] = fill;
        }
      }
    }
  };
  // row i's 32 elements of the fragment folded into 8 chains by `op`,
  // then the chains folded pairwise (short dependency chains)
  auto fold = [&](int i, auto op) {
    float part[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) part[u] = s[4 * (u / 2) + 2 * i + u % 2];
#pragma unroll
    for (int c = 4; c < BK / 8; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        part[(2 * c + j) % 8] = op(part[(2 * c + j) % 8],
                                   s[4 * c + 2 * i + j]);
    }
    return op(op(op(part[0], part[1]), op(part[2], part[3])),
              op(op(part[4], part[5]), op(part[6], part[7])));
  };
  // online softmax of the tile at k_lo on the fragment, rows r0 (i = 0)
  // and r0 + 8 (i = 1): s becomes the f32 p; alpha rescales O afterwards.
  // Only tiles that cross kv_len, the diagonal or the window edge run the
  // mask passes, so the others pay nothing for masking.
  auto softmax = [&](int k_lo) {
    const bool edge = k_lo + BK > kv_end ||
                      (causal && k_lo + BK - 1 > wg_lo) ||
                      (window > 0 && k_lo <= wg_hi - window);
    if (edge) mask(k_lo, repro::NEG_INF);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fold(i, [](float a, float b) { return fmaxf(a, b); });
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // the scale is positive, so the max of the scaled scores is the
      // scaled max; a row masked so far has m = NEG_INF * scale
      const float m_new = fmaxf(m_run[i], mx * scale_log2);
      alpha[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * c + 2 * i + j];
          x = ex2(fmaf(x, scale_log2, -m_new));
        }
      }
    }
    // zero p under the mask after the exp: a row whose every key so far is
    // masked would otherwise get exp(0) = 1 from the fill
    if (edge) mask(k_lo, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] = l_run[i] * alpha[i] +
                 fold(i, [](float a, float b) { return a + b; });
    }
  };
  // rescale O, and split P into two bf16 terms in the register-A layout of
  // each 16-key slice: P_hi is p cut to its top 16 bits (a bf16 rounded
  // toward zero, by integer ops), P_lo the rest rounded to bf16, so P_hi +
  // P_lo is p to 2^-16 with one f32-to-bf16 conversion per pair
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int c = 0; c < VD / 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * c + 2 * i] *= alpha[i];
        acc[4 * c + 2 * i + 1] *= alpha[i];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * (2 * kk + r / 2) + 2 * (r % 2);
        const uint32_t b0 = __float_as_uint(s[e]);
        const uint32_t b1 = __float_as_uint(s[e + 1]);
        p_hi[kk][r] = __byte_perm(b0, b1, 0x7632);   // the two top halves
        p_lo[kk][r] = bits(__floats2bfloat162_rn(
            s[e] - __uint_as_float(b0 & 0xffff0000u),
            s[e + 1] - __uint_as_float(b1 & 0xffff0000u)));
      }
    }
  };

  // the issue token: consumer cw waits on barrier 1 + cw and hands over on
  // the other's; consumer 0 goes first, and consumer 1 skips its last hand-
  // over, which nobody would wait for
  auto take_turn = [&]() { bar_sync(1 + cw, CONSUMERS); };
  auto pass_turn = [&](bool last) {
    if (!(last && cw == 1)) bar_arrive(2 - cw, CONSUMERS);
  };

  if (n_tiles > 0) {
    if (cw == 1) bar_arrive(1, CONSUMERS);
    mbar_wait(&sm.q_full, 0);
    mbar_wait(&sm.full[0], 0);
    fence_regs(s);
    take_turn();
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(k_begin);
    rescale_and_pack();
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % NS;
    const int prev = (t - 1) % NS;
    mbar_wait(&sm.full[st], (t / NS) & 1);
    fence_regs(s);
    fence_regs(acc);
    take_turn();
    wgmma_fence();
    issue_qk(st);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<1>();                   // S of tile t is in
    fence_regs(s);
    softmax(k_begin + t * BK);
    wgmma_wait<0>();                   // P V of tile t - 1 is in
    fence_regs(acc);
    mbar_arrive(&sm.empty[prev]);
    rescale_and_pack();
  }
  if (n_tiles > 0) {
    fence_regs(acc);
    take_turn();
    wgmma_fence();
    issue_pv((n_tiles - 1) % NS);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int row = q_start + r0 + 8 * i;
    if (row < Sq) {
      bf16* op = o + b * o_sb + (long long)row * o_ss + h * VD + 2 * t4;
#pragma unroll
      for (int c = 0; c < VD / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * c) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] * inv,
                                  acc[4 * c + 2 * i + 1] * inv);
    }
  }
}

// q, k and v of one width HD (64 or 128): GQA prefill attention
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  bf16* __restrict__ o, int Sq, int T_len, int H, int K,
                  long long o_sb, long long o_ss, int q_offset, int kv_len,
                  int causal, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  tc_body<HD, HD, STAGES>(smem_raw, tm_q, tm_k, tm_v, o, Sq, T_len, H, K,
                          o_sb, o_ss, q_offset, kv_len, causal, window,
                          scale_log2);
}

// q and k of width QK, v and the output of width VD: latent attention's
// up-projected heads
template <int QK, int VD>
__global__ void __launch_bounds__(NTHREADS, 1)
prefill_mla_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ o, int Sq, int T_len, int H, int K,
                   long long o_sb, long long o_ss, int q_offset, int kv_len,
                   int causal, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  tc_body<QK, VD, MLA_STAGES>(smem_raw, tm_q, tm_k, tm_v, o, Sq, T_len, H,
                              K, o_sb, o_ss, q_offset, kv_len, causal,
                              window, scale_log2);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A (B, rows, heads, hd) bf16 operand as a 4-d tensor map (hd innermost)
// with boxes of BOX columns x 1 head x box_rows rows x 1 batch; strides in
// elements. Rows at or past `rows` read as zeros.
int encode(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
           int batch, long long row_stride, long long batch_stride,
           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)row_stride * 2,
                                 (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_prefill_attention: cuTensorMapEncodeTiled "
            "failed with CUresult %d\n", static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int T_len, int H, int K, long long q_sb, long long q_ss,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss,
           long long o_sb, long long o_ss, int q_offset, int kv_len,
           int causal, int window, float scale, cudaStream_t stream) {
  // the K/V maps end at kv_len: TMA zero-fills every key past it
  const int kv_rows = max(1, min(kv_len, T_len));
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, HD, H, Sq, B, q_ss, q_sb, BQ);
  if (!err) err = encode(&tk, k, HD, K, kv_rows, B, k_ss, k_sb, BK);
  if (!err) err = encode(&tv, v, HD, K, kv_rows, B, v_ss, v_sb, BK);
  if (err) return err;
  constexpr size_t smem = smem_bytes<HD, HD, STAGES>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  prefill_tc_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), Sq, T_len, H, K, o_sb, o_ss,
      q_offset, kv_len, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// the latent-attention body at q/k width QK and v width VD
template <int QK, int VD>
int launch_mla(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int T_len, int H, int K, long long q_sb,
               long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, long long o_sb,
               long long o_ss, int q_offset, int kv_len, int causal,
               int window, float scale, cudaStream_t stream) {
  const int kv_rows = max(1, min(kv_len, T_len));
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, QK, H, Sq, B, q_ss, q_sb, BQ);
  if (!err) err = encode(&tk, k, QK, K, kv_rows, B, k_ss, k_sb, BK);
  if (!err) err = encode(&tv, v, VD, K, kv_rows, B, v_ss, v_sb, BK);
  if (err) return err;
  constexpr size_t smem = smem_bytes<QK, VD, MLA_STAGES>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_mla_kernel<QK, VD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  prefill_mla_kernel<QK, VD><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), Sq, T_len, H, K, o_sb, o_ss,
      q_offset, kv_len, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

namespace hd256 {

using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int HD = 256;
constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;         // query rows per block, 16 a warp
constexpr int BK = 32;                 // keys per K/V tile
constexpr int NTHREADS = 32 * WARPS;
constexpr int STR = HD + 8;            // elements per shared row (16-byte pad)
constexpr int CPR = HD * 2 / 16;       // 16-byte chunks per row
// Q, then two stages of K and of V
constexpr size_t SMEM = sizeof(bf16) * STR * (BQ + 4 * BK);

// bf16 at head_dim 256 on the tensor cores by mma.sync m16n8k16: one block
// per (64-query tile, b*H+h), four warps of 16 query rows. Q stays in shared
// memory and is read by ldmatrix per 16-wide slice of hd, so a thread holds
// only its 16 x 256 f32 accumulator (128 registers), one tile's scores and
// its two-term P. K/V tiles of 32 keys arrive by cp.async into two stages
// (zero past kv_len), the next tile loading while this one is computed. S =
// Q K^T and O += P V run as the split-KV decode body's warp tile does (the
// same fragments, P as two bf16 terms); the online softmax carries each
// row's max and sum across tiles, masks only edge tiles and zeroes p under
// the mask after the exp.
__global__ void __launch_bounds__(NTHREADS, 2)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                   int T_len, int H, int K, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, long long o_sb, long long o_ss,
                   int q_offset, int kv_len, int causal, int window,
                   float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BQ * STR;          // [2][BK][STR]
  bf16* v_s = k_s + 2 * BK * STR;      // [2][BK][STR]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);
  const int q_start = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, tig = lane % 4;

  // block-level tile bounds (the reference's skip tests)
  const int kv_end = min(kv_len, T_len);
  const int q_lo = q_offset + q_start;
  const int q_hi = q_offset + min(q_start + BQ, Sq) - 1;
  int k_stop = kv_end;
  if (causal) k_stop = min(k_stop, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_stop > k_begin ? (k_stop - k_begin + BK - 1) / BK : 0;

  const bf16* qg = q + b * q_sb + (long long)h * HD;
  for (int i = tid; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR, row = q_start + r;
    const bool ok = row < Sq;
    cp_async16(q_s + r * STR + c * 8,
               ok ? qg + (long long)row * q_ss + c * 8 : qg, ok);
  }
  const bf16* kg = k + b * k_sb + (long long)kvh * HD;
  const bf16* vg = v + b * v_sb + (long long)kvh * HD;
  auto load_tile = [&](int t) {
    const int st = t % 2, k_lo = k_begin + t * BK;
    for (int i = tid; i < BK * CPR; i += NTHREADS) {
      const int j = i / CPR, c = i % CPR, key = k_lo + j;
      const bool ok = key < kv_end;
      cp_async16(k_s + (st * BK + j) * STR + c * 8,
                 ok ? kg + (long long)key * k_ss + c * 8 : kg, ok);
      cp_async16(v_s + (st * BK + j) * STR + c * 8,
                 ok ? vg + (long long)key * v_ss + c * 8 : vg, ok);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();                   // Q and tile 0

  // rows r0 (i = 0) and r0 + 8 (i = 1) of the block; the warp's positions
  const int r0 = 16 * warp + grp;
  const int w_lo = q_lo + 16 * warp;
  const int w_hi = w_lo + 15;
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // row max, in log2 units
  float l_run[2] = {0.f, 0.f};         // this thread's part of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and Q) have landed
    __syncthreads();
    const int k_lo = k_begin + t * BK;
    const bf16* ks = k_s + (t % 2) * BK * STR;
    const bf16* vs = v_s + (t % 2) * BK * STR;

    // S = Q K^T: four n8 tiles of 8 keys over 16 slices of hd
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, q_s + (16 * warp + lane % 8 + ((lane / 8) % 2) * 8) * STR +
                      16 * kk + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (16 * n2 + (lane / 16) * 8 + lane % 8) * STR +
                        16 * kk + ((lane / 8) % 2) * 8);
        mma_m16n8k16(s[2 * n2], qa, kb[0], kb[1]);
        mma_m16n8k16(s[2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }

    // online softmax: element (n, c) is key k_lo + 8n + 2 tig + c % 2 of
    // row r0 (c < 2) or r0 + 8 (c >= 2); only tiles that cross kv_len, the
    // diagonal or the window edge of the warp's rows are masked
    const bool edge = k_lo + BK > kv_end ||
                      (causal && k_lo + BK - 1 > w_lo) ||
                      (window > 0 && k_lo <= w_hi - window);
    uint32_t hidden = 0;               // bit 4n + c: element (n, c) masked
    if (edge) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k_lo + 8 * n + 2 * tig + (c & 1);
          const int qpos = w_lo + grp + 8 * (c / 2);
          bool ok = key < kv_end;
          if (causal) ok = ok && key <= qpos;
          if (window > 0) ok = ok && key > qpos - window;
          hidden |= (ok ? 0u : 1u) << (4 * n + c);
        }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] *= scale_log2;
        if ((hidden >> (4 * n + c)) & 1u) s[n][c] = repro::NEG_INF;
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = fmaxf(s[0][2 * i], s[0][2 * i + 1]);
#pragma unroll
      for (int n = 1; n < 4; ++n) x = fmaxf(x, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m_run[i], x);
      alpha[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = ex2(s[n][c] - m_run[c / 2]);
        // p is zeroed under the mask after the exp: a row that has seen no
        // key yet would otherwise get exp(0) = 1 from the fill
        if ((hidden >> (4 * n + c)) & 1u) s[n][c] = 0.f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) x += s[n][2 * i] + s[n][2 * i + 1];
      l_run[i] = l_run[i] * alpha[i] + x;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P_hi V + P_lo V, one 16-key slice at a time (P in the
    // register-A layout, as two bf16 terms, packed just before its slice's
    // products); ldmatrix.trans gives the B fragments of two 8-wide slices
    // of hd
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t p_hi[4], p_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[2 * kk + r / 2][2 * (r % 2)];
        const float x1 = s[2 * kk + r / 2][2 * (r % 2) + 1];
        const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
        p_hi[r] = __byte_perm(b0, b1, 0x7632);       // the two top halves
        p_lo[r] = bits(__floats2bfloat162_rn(
            x0 - __uint_as_float(b0 & 0xffff0000u),
            x1 - __uint_as_float(b1 & 0xffff0000u)));
      }
      const int key = 16 * kk + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + key * STR + 16 * dp + (lane / 16) * 8);
        mma_m16n8k16(acc[2 * dp], p_hi, vb[0], vb[1]);
        mma_m16n8k16(acc[2 * dp], p_lo, vb[0], vb[1]);
        mma_m16n8k16(acc[2 * dp + 1], p_hi, vb[2], vb[3]);
        mma_m16n8k16(acc[2 * dp + 1], p_lo, vb[2], vb[3]);
      }
    }
    __syncthreads();                   // this stage is reloaded at t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int row = q_start + r0 + 8 * i;
    if (row < Sq) {
      bf16* op = o + b * o_sb + (long long)row * o_ss + h * HD + 2 * tig;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * i] * inv,
                                  acc[j][2 * i + 1] * inv);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int T_len, int H, int K, long long q_sb, long long q_ss,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss,
           long long o_sb, long long o_ss, int q_offset, int kv_len,
           int causal, int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  prefill_mma_kernel<<<grid, NTHREADS, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, T_len, H, K,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, q_offset, kv_len,
      causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hd256

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
// axes of q, k, v and o are dense; hd is the q/k width, hd_v the v and
// output width. bf16 at head_dim 64 or 128 runs the wgmma body, bf16 at 256
// the mma.sync body, bf16 at q/k 192 and v 128 the latent-attention wgmma
// body, and all set *tensor_core to 1; everything else at hd_v == hd (f32
// at 16, 32, 64, 128 or 256; bf16 at 16 or 32) runs the CUDA-core body and
// sets it to 0. Returns cudaGetLastError() after launch, or the error that
// stopped it.
extern "C" int flash_prefill_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int T_len, int H, int K, int hd, int hd_v, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long o_sb, long long o_ss, int q_offset, int kv_len,
    int causal, int window, float scale, void* stream, int* tensor_core) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd_v != hd) {
    *tensor_core = dtype == 1 && hd == 192 && hd_v == 128;
    if (!*tensor_core) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch_mla<192, 128>(q, k, v, o, B, Sq, T_len, H, K, q_sb,
                                    q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                                    q_offset, kv_len, causal, window, scale,
                                    s);
  }
  *tensor_core = dtype == 1 && (hd == 64 || hd == 128 || hd == 256);
  if (*tensor_core && hd == 256) {
    return hd256::launch(q, k, v, o, B, Sq, T_len, H, K, q_sb, q_ss, k_sb,
                         k_ss, v_sb, v_ss, o_sb, o_ss, q_offset, kv_len,
                         causal, window, scale, s);
  }
  if (*tensor_core) {
    return (hd == 64 ? tc::launch<64> : tc::launch<128>)(
        q, k, v, o, B, Sq, T_len, H, K, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
        o_sb, o_ss, q_offset, kv_len, causal, window, scale, s);
  }
#define REPRO_PREFILL_CASE(TYPE, HDV)                                        \
  launch<TYPE, HDV>(q, k, v, o, B, Sq, T_len, H, K, q_sb, q_ss, k_sb, k_ss,  \
                    v_sb, v_ss, o_sb, o_ss, q_offset, kv_len, causal, window, \
                    scale, s)
  if (dtype == 0) {
    switch (hd) {
      case 16: REPRO_PREFILL_CASE(float, 16); break;
      case 32: REPRO_PREFILL_CASE(float, 32); break;
      case 64: REPRO_PREFILL_CASE(float, 64); break;
      case 128: REPRO_PREFILL_CASE(float, 128); break;
      case 256: REPRO_PREFILL_CASE(float, 256); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: REPRO_PREFILL_CASE(__nv_bfloat16, 16); break;
      case 32: REPRO_PREFILL_CASE(__nv_bfloat16, 32); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PREFILL_CASE
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of one tensor-core block at head_dim 64, 128 or
// 256, or at q/k 192 (v 128)
extern "C" int flash_prefill_tc_smem_bytes(int hd) {
  if (hd == 256) return static_cast<int>(hd256::SMEM);
  if (hd == 192)
    return static_cast<int>(tc::smem_bytes<192, 128, tc::MLA_STAGES>());
  return static_cast<int>(hd == 64 ? tc::smem_bytes<64, 64, tc::STAGES>()
                                   : tc::smem_bytes<128, 128, tc::STAGES>());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
