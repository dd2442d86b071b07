// Split-KV flash-decode GQA attention for Hopper (sm_90a): one body for the
// ragged decode step (one query per row) and the speculative verify step (S
// consecutive query positions per row), and a second small kernel that
// combines the splits.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attn.py:
//  * `flash_decode_attention` (wrapper :207, body `_decode_kernel` :27): q
//    (B,H,hd), k/v (B,T,K,hd), kv_len (B,) int32 on the device; row b
//    attends to keys [0, kv_len[b]). A row with kv_len 0 (l == 0) writes 0.
//  * `flash_verify_attention` (wrapper :129, body `_verify_kernel` :73): q
//    (B,S,H,hd) holds the S = draft_k + 1 positions kv_len[b] .. kv_len[b] +
//    S - 1, whose draft K/V are already in k/v; query s attends to keys
//    [0, kv_len[b] + s] (and < T).
// Both are one function of a run-time shift: query s of row b sits at
// position kv_len[b] + shift + s and sees keys [0, min(that + 1, T)).
// Decode is S = 1, shift = -1; verify is shift = 0.
//
// What bounds them on the H100: bytes. Every key of a row's prefix is read
// once and serves R = S*Qg query rows (Llama3-8B: Qg = 4, R 4 when decoding,
// 20 when verifying at draft_k 4): 4*hd*R FLOP against 4*hd bytes of bf16
// K/V, R FLOP per byte. The floor is the K/V bytes over 3.35 TB/s; at R 20
// the f32 FMA work alone would take the card's whole CUDA-core rate, so
// bf16 runs its products on the tensor cores.
//
// What the design does about it:
//  * Split-KV. The grid is (splits, K, B); split j covers the fixed keys
//    [SPLIT j, SPLIT j + SPLIT) of one (row b, KV head), whatever S, kv_len
//    or T, so a row's arithmetic never depends on them. SPLIT is 128 keys
//    (4 warps) up to head_dim 128 and 32 keys (1 warp) at head_dim 256,
//    where a 128-key split of f32 K and V alone would take 266 KB of shared
//    memory, and where a ring of 2048 keys behind one KV head
//    (RecurrentGemma, B 1) would give 16 blocks for 132 SMs; 32-key splits
//    give 64. A block whose split lies past its row's last key exits at
//    once. B 4 at kv_len 1/1000/2600/4096 runs 496 blocks, B 1 over 3000
//    keys 192, on 132 SMs.
//  * Each warp owns 32 fixed keys of the split and loads them by cp.async
//    (16 bytes a thread, K then V as two groups) into its own part of
//    shared memory, kept in the input type: every load of the block is in
//    flight at once, and the scores and softmax run while V arrives. Keys
//    past the block's last visible key are zero-filled, never read. With
//    one query tile the warps' merge rows lie over their own K rows, so a
//    bf16 decode block at hd 128 takes 70 KB and three fit an SM.
//  * The block holds all R rows of its KV head (r = s*Qg + g, in tiles of
//    16) so each key serves every query that needs it. bf16: S = Q K^T and
//    O = P V by mma.sync m16n8k16 (bf16 in, f32 sums), Q padded to 16 rows
//    with zeros, P taken from S's accumulator as the A fragment and carried
//    as two bf16 terms (P_hi = p cut to its top 16 bits, P_lo = bf16(p -
//    P_hi)): one term moves outputs near zero far outside the port's bf16
//    limit (tests/test_torch_kernels.py). f32: FMA on the CUDA cores, never
//    TF32, one key per lane.
//  * Each warp's softmax covers its 32 keys in one pass (no rescaling). The
//    warps' states (m, l, acc) merge in shared memory in warp order, then
//    in the combine kernel over the splits in ascending order, each pass
//    skipping the parts in which a row saw no key; it stages the splits'
//    m and l in shared memory and keeps 8 loads a thread in flight. No
//    atomics: two calls give the same bits.
//  * Column 0 of verify equals decode at kv_len + 1 bit for bit: the split
//    and warp boundaries are the same in both calls, every reduction is per
//    row in a fixed order, masked keys get p = 0 after the exp, a part in
//    which a row saw no key is skipped by its row's own end, and padded
//    rows are never read back.
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "vec.cuh"

namespace {

using repro::NEG_INF;
using namespace repro::sm90;

constexpr int WKEYS = 32;              // keys per warp
constexpr int MT = 16;                 // query rows per tile (mma M)
constexpr int MAX_ROWS = 64;           // S * Qg a block holds

// warps of a split block, and keys per split (one block), by head_dim
template <int HD>
__host__ __device__ constexpr int nwarps() { return HD > 128 ? 1 : 4; }
template <int HD>
__host__ __device__ constexpr int split_keys() {
  return WKEYS * nwarps<HD>();
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* o;
  float* ws;                           // (B, K, splits, R, hd) acc, then m, l
  int S, T, qg, R, shift, split, nsplit;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale_log2;                    // log2(e) / sqrt(hd)
};

// one past the last key row r of batch row b sees (0: none)
__device__ __forceinline__ int row_end(const Args& a, int first, int r) {
  return min(max(first + r / a.qg + 1, 0), a.T);
}

// Shared memory of one block: the warps' K and V rows (padded by 16 bytes,
// so ldmatrix and the f32 row reads are free of bank conflicts), the warps'
// m and l for the merge, for f32 the query tile, and the warps' acc for the
// merge. Warp w's acc slab has the size and place of its K rows, so in bf16
// the last query tile writes it over them (the warp has read its K by
// then); only a block with more than one tile, or f32, whose rows are
// written while K is still read, needs the separate area at the end.
template <typename T, int HD>
struct Smem {
  static constexpr int NWARPS = nwarps<HD>();
  static constexpr int SPLIT = split_keys<HD>();
  static constexpr bool ALIAS = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int KSTR = HD + 16 / sizeof(T);   // elements per K/V row
  static constexpr int MSTR = HD + 8;                // floats per merge row
  static constexpr int WSTR = WKEYS * KSTR * sizeof(T) / sizeof(float);
  static_assert(MT * MSTR <= WSTR, "a warp's merge rows fit its K slab");
  static constexpr size_t kv = sizeof(T) * SPLIT * KSTR;
  static constexpr size_t ml = sizeof(float) * 2 * NWARPS * MT;
  static constexpr size_t qt =
      std::is_same<T, float>::value ? sizeof(float) * MT * HD : 0;
  static constexpr size_t merge = 2 * kv + ml + qt;  // offset of the area
  static constexpr size_t bytes(int tiles) {
    return merge + (ALIAS && tiles == 1 ? 0 : kv);
  }
};

// The per-warp state of one query tile over the warp's 32 keys, bf16 on the
// tensor cores: writes m (log2 units), l and the unnormalised acc of its 16
// rows to the merge area.
template <int HD>
__device__ __forceinline__ void warp_tile_bf16(
    const Args& a, const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
    float* mg_acc, float* mg_m, float* mg_l, int b, int kvh, int mt,
    int first, int key0, int lane) {
  using SM = Smem<__nv_bfloat16, HD>;
  const int grp = lane / 4, tig = lane % 4;
  const int r0 = mt * MT + grp, r1 = r0 + 8;
  const int blk_end = row_end(a, first, a.R - 1);
  const int re0 = r0 < a.R ? row_end(a, first, r0) : blk_end;
  const int re1 = r1 < a.R ? row_end(a, first, r1) : blk_end;
  // rows are ordered by position, so the tile's first row sees the fewest
  // keys: the warp's tile needs the masking passes only if it reaches past
  // that row's end
  const bool edge = key0 + WKEYS > row_end(a, first, mt * MT);

  // Q fragments (register A of m16n8k16) straight from device memory; the
  // padded rows are zeros
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  auto q_row = [&](int r) {
    return q + b * a.q_sb + (long long)(r / a.qg) * a.q_ss +
           (long long)(kvh * a.qg + r % a.qg) * HD;
  };
  const __nv_bfloat16* q0 = q_row(min(r0, a.R - 1));
  const __nv_bfloat16* q1 = q_row(min(r1, a.R - 1));
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = 16 * kk + 2 * tig;
    qa[kk][0] = r0 < a.R ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
    qa[kk][1] = r1 < a.R ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
    qa[kk][2] = r0 < a.R ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
    qa[kk][3] = r1 < a.R ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
  }

  // the warp's K has landed (its V may still be in flight; waits on
  // groups that completed in an earlier tile return at once)
  cp_async_wait<1>();
  __syncwarp();

  // S = Q K^T: four n8 tiles of 8 keys; ldmatrix.x4 gives the B fragments
  // of two of them for one 16-wide slice of hd
  float s[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) {
    const int key = 16 * n2 + (lane / 16) * 8 + lane % 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, k_s + key * SM::KSTR + 16 * kk + ((lane / 8) % 2) * 8);
      mma_m16n8k16(s[2 * n2], qa[kk], kb[0], kb[1]);
      mma_m16n8k16(s[2 * n2 + 1], qa[kk], kb[2], kb[3]);
    }
  }

  // softmax over the warp's keys: element (n, c) is key key0 + 8n + 2 tig +
  // c % 2 of row r0 (c < 2) or r1 (c >= 2)
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] *= a.scale_log2;
  if (edge) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (key0 + 8 * n + 2 * tig + (c & 1) >= (c < 2 ? re0 : re1))
          s[n][c] = NEG_INF;
  }
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = fmaxf(s[0][2 * i], s[0][2 * i + 1]);
#pragma unroll
    for (int n = 1; n < 4; ++n) x = fmaxf(x, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    m[i] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = ex2(s[n][c] - m[c / 2]);
  // p is zeroed under the mask after the exp: a row that sees none of the
  // warp's keys would otherwise get exp(0) = 1 from the fill
  if (edge) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (key0 + 8 * n + 2 * tig + (c & 1) >= (c < 2 ? re0 : re1))
          s[n][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) x += s[n][2 * i] + s[n][2 * i + 1];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    l[i] = x + __shfl_xor_sync(0xffffffffu, x, 2);
  }

  // P in the register-A layout of each 16-key slice, as two bf16 terms
  uint32_t p_hi[2][4], p_lo[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[2 * kk + r / 2][2 * (r % 2)];
      const float x1 = s[2 * kk + r / 2][2 * (r % 2) + 1];
      const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
      p_hi[kk][r] = __byte_perm(b0, b1, 0x7632);     // the two top halves
      p_lo[kk][r] = bits(__floats2bfloat162_rn(
          x0 - __uint_as_float(b0 & 0xffff0000u),
          x1 - __uint_as_float(b1 & 0xffff0000u)));
    }
  }

  cp_async_wait<0>();
  __syncwarp();

  // O = P V: ldmatrix.x4.trans gives the B fragments of two 8-wide slices
  // of hd for one 16-key slice
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int key = 16 * kk + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_t(vb, v_s + key * SM::KSTR + 16 * dp + (lane / 16) * 8);
      mma_m16n8k16(acc[2 * dp], p_hi[kk], vb[0], vb[1]);
      mma_m16n8k16(acc[2 * dp], p_lo[kk], vb[0], vb[1]);
      mma_m16n8k16(acc[2 * dp + 1], p_hi[kk], vb[2], vb[3]);
      mma_m16n8k16(acc[2 * dp + 1], p_lo[kk], vb[2], vb[3]);
    }
  }

  __syncwarp();                  // in the last tile these rows are K's
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(mg_acc + grp * SM::MSTR + d) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(mg_acc + (grp + 8) * SM::MSTR + d) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (tig == 0) {
    mg_m[grp] = m[0];
    mg_l[grp] = l[0];
    mg_m[grp + 8] = m[1];
    mg_l[grp + 8] = l[1];
  }
}

// The same state in f32 on the CUDA cores: one key per lane, one row at a
// time, every sum a fixed FMA chain.
template <int HD>
__device__ __forceinline__ void warp_tile_f32(
    const Args& a, const float* k_s, const float* v_s, const float* q_s,
    float* mg_acc, float* mg_m, float* mg_l, int mt, int first, int key0,
    int lane) {
  using SM = Smem<float, HD>;
  constexpr int DPL = (HD + 31) / 32;                // dims per lane
  const int rows = min(MT, a.R - mt * MT);
  for (int rl = 0; rl < rows; ++rl) {
    const int re = row_end(a, first, mt * MT + rl);
    if (key0 >= re) continue;                        // warp-uniform
    const float4* kr = reinterpret_cast<const float4*>(k_s + lane * SM::KSTR);
    const float4* qr = reinterpret_cast<const float4*>(q_s + rl * HD);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      const float4 kv = kr[c], qv = qr[c];
      dot = fmaf(qv.x, kv.x, dot);
      dot = fmaf(qv.y, kv.y, dot);
      dot = fmaf(qv.z, kv.z, dot);
      dot = fmaf(qv.w, kv.w, dot);
    }
    const bool vis = key0 + lane < re;
    const float x = vis ? dot * a.scale_log2 : NEG_INF;
    float mx = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float p = vis ? ex2(x - mx) : 0.f;
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
#pragma unroll 8
    for (int j = 0; j < WKEYS; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc[i] = fmaf(pj, v_s[j * SM::KSTR + d], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) mg_acc[rl * SM::MSTR + d] = acc[i];
    }
    if (lane == 0) {
      mg_m[rl] = mx;
      mg_l[rl] = sum;
    }
  }
}

// One block per (split, KV head, batch row): the states of the split's
// keys for every query row, written to the workspace.
// bf16 blocks of a single query tile take 70 KB of shared memory at hd
// 128, so three fit an SM when their registers do too; at hd 256 a block
// is one warp.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * nwarps<HD>(),
                                  Smem<T, HD>::ALIAS && HD <= 128 ? 3 : 1)
split_kernel(const Args a) {
  using SM = Smem<T, HD>;
  constexpr int NWARPS = SM::NWARPS, SPLIT = SM::SPLIT;
  constexpr int NTHREADS = 32 * NWARPS;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_all = reinterpret_cast<T*>(smem);
  T* v_all = reinterpret_cast<T*>(smem + SM::kv);
  float* mg_m = reinterpret_cast<float*>(smem + 2 * SM::kv);
  float* mg_l = mg_m + NWARPS * MT;
  float* q_s = mg_m + 2 * NWARPS * MT;                // f32 only

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int first = a.kv_len[b] + a.shift;            // query 0's position
  const int blk_end = row_end(a, first, a.R - 1);     // keys any row sees
  const int lo = split * SPLIT;
  // the combine kernel may be scheduled once every block got here; it
  // waits for this grid's results before reading them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (lo >= blk_end) return;                          // past every row

  // the warp's 32 keys, K then V, zero past the block's last visible key
  const int key0 = lo + warp * WKEYS;
  T* k_s = k_all + warp * WKEYS * SM::KSTR;
  T* v_s = v_all + warp * WKEYS * SM::KSTR;
  constexpr int CPR = HD * sizeof(T) / 16;            // 16-byte chunks a row
  constexpr int EPC = 16 / sizeof(T);                 // elements a chunk
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + (long long)kvh * HD;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + (long long)kvh * HD;
  const bool busy = key0 < blk_end;
  if (busy) {
#pragma unroll
    for (int i = lane; i < WKEYS * CPR; i += 32) {
      const int j = i / CPR, c = i % CPR, key = key0 + j;
      const bool ok = key < blk_end;
      cp_async16(k_s + j * SM::KSTR + c * EPC,
                 ok ? kg + (long long)key * a.k_ss + c * EPC : kg, ok);
    }
    cp_async_commit();
#pragma unroll
    for (int i = lane; i < WKEYS * CPR; i += 32) {
      const int j = i / CPR, c = i % CPR, key = key0 + j;
      const bool ok = key < blk_end;
      cp_async16(v_s + j * SM::KSTR + c * EPC,
                 ok ? vg + (long long)key * a.v_ss + c * EPC : vg, ok);
    }
    cp_async_commit();
  }

  const int tiles = (a.R + MT - 1) / MT;
  for (int mt = 0; mt < tiles; ++mt) {
    const int rows = min(MT, a.R - mt * MT);
    const int tile_end = row_end(a, first, mt * MT + rows - 1);
    float* mg_acc = reinterpret_cast<float*>(
        SM::ALIAS && mt == tiles - 1 ? smem : smem + SM::merge);
    float* w_acc = mg_acc + warp * SM::WSTR;
    float* w_m = mg_m + warp * MT;
    float* w_l = mg_l + warp * MT;
    if constexpr (BF16) {
      if (key0 < tile_end)
        warp_tile_bf16<HD>(a, k_s, v_s, w_acc, w_m, w_l, b, kvh, mt, first,
                           key0, lane);
    } else {
      const float* q = static_cast<const float*>(a.q);
      for (int i = tid; i < MT * HD; i += NTHREADS) {
        const int r = mt * MT + i / HD;
        q_s[i] = r < a.R ? q[b * a.q_sb + (long long)(r / a.qg) * a.q_ss +
                             (long long)(kvh * a.qg + r % a.qg) * HD + i % HD]
                         : 0.f;
      }
      if (mt == 0 && busy) cp_async_wait<0>();
      __syncthreads();
      if (key0 < tile_end)
        warp_tile_f32<HD>(a, k_s, v_s, q_s, w_acc, w_m, w_l, mt, first, key0,
                          lane);
    }
    __syncthreads();

    // merge the warps in order, skipping those that hold none of the row's
    // keys, and write the split's state of each real row
    for (int i = tid; i < rows * HD; i += NTHREADS) {
      const int rl = i / HD, d = i % HD, r = mt * MT + rl;
      const int re = row_end(a, first, r);
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w)
        if (lo + w * WKEYS < re) mx = fmaxf(mx, mg_m[w * MT + rl]);
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        if (lo + w * WKEYS < re) {
          const float e = ex2(mg_m[w * MT + rl] - mx);
          acc = fmaf(e, mg_acc[w * SM::WSTR + rl * SM::MSTR + d], acc);
          l = fmaf(e, mg_l[w * MT + rl], l);
        }
      }
      const long long part = ((long long)(b * K + kvh) * a.nsplit + split) * a.R + r;
      a.ws[part * HD + d] = acc;
      if (d == 0) {
        float* ml = a.ws + (long long)gridDim.z * K * a.nsplit * a.R * HD;
        ml[2 * part] = mx;
        ml[2 * part + 1] = l;
      }
    }
    __syncthreads();                                  // merge area reused
  }
}

// One block per (query row, KV head, batch row), one thread per dim: the
// row's splits combined in ascending order, skipping any in which the row
// saw no key; 0 where it saw none at all. It is launched while the split
// kernel runs (programmatic dependent launch) and waits for its results
// only after its own set-up. The first CU splits' acc are loaded at once,
// before the max is known; the splits' m and l go through shared memory,
// HD at a time.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) combine_kernel(const Args a) {
  constexpr int SPLIT = split_keys<HD>();
  // splits whose acc are loaded before the max is known
  constexpr int CU = HD > 128 ? 64 : (HD < 32 ? HD : 32);
  __shared__ float m_s[HD], l_s[HD];
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int K = gridDim.y;
  const int re = row_end(a, a.kv_len[b] + a.shift, r);
  const int n = (re + SPLIT - 1) / SPLIT;
  const long long part0 = (long long)(b * K + kvh) * a.nsplit * a.R + r;
  const float* __restrict__ ml =
      a.ws + (long long)gridDim.z * K * a.nsplit * a.R * HD;
  const float* __restrict__ acc_p = a.ws + part0 * HD + d;
  const long long step = (long long)a.R * HD;       // one split to the next
  auto stage = [&](int c0) {                        // splits c0 .. c0 + HD
    __syncthreads();
    if (c0 + d < n) {
      const long long part = part0 + (long long)(c0 + d) * a.R;
      m_s[d] = ml[2 * part];
      l_s[d] = ml[2 * part + 1];
    }
    __syncthreads();
  };
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float x[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) x[u] = u < n ? acc_p[u * step] : 0.f;
  float mx = -INFINITY;
  for (int c0 = 0; c0 < n; c0 += HD) {
    stage(c0);
    for (int j = 0; j < min(HD, n - c0); ++j)
      if (l_s[j] != 0.f) mx = fmaxf(mx, m_s[j]);
  }
  if (n > HD) stage(0);
  float acc = 0.f, l = 0.f;
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    if (u < n && l_s[u] != 0.f) {
      const float e = ex2(m_s[u] - mx);
      acc = fmaf(e, x[u], acc);
      l = fmaf(e, l_s[u], l);
    }
  }
  for (int j = CU; j < n; ++j) {
    if (j % HD == 0) stage(j);
    const float lj = l_s[j % HD];
    if (lj == 0.f) continue;
    const float e = ex2(m_s[j % HD] - mx);
    acc = fmaf(e, acc_p[j * step], acc);
    l = fmaf(e, lj, l);
  }
  const float out = l == 0.f ? 0.f : acc / l;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + (long long)(r / a.qg) * a.o_ss +
         (long long)(kvh * a.qg + r % a.qg) * HD + d;
  if constexpr (std::is_same<T, float>::value) {
    *o = out;
  } else {
    *o = __float2bfloat16_rn(out);
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, int K, cudaStream_t stream) {
  // above 48 KB of shared memory a launch needs the opt-in; it is a
  // property of the function, so setting it twice from two threads is fine
  if (a.split != split_keys<HD>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<T, HD>::bytes(2)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const size_t smem = Smem<T, HD>::bytes((a.R + MT - 1) / MT);
  split_kernel<T, HD><<<dim3(a.nsplit, K, B), 32 * nwarps<HD>(), smem,
                        stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.R, K, B);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, combine_kernel<T, HD>, a));
}

}  // namespace

// Decode (S = 1, shift = -1) and verify (shift = 0) through the one body.
// q/o (B,S,H,hd) with strides in elements (q_ss/o_ss unused at S = 1), k/v
// (B,T,K,hd); the (head, dim) axes of all four are dense, and k/v rows are
// 16-byte aligned. kv_len is a (B,) int32 device array. ws is an f32
// workspace of ws_floats >= B*K*ceil(T/split_keys)*S*(H/K)*(hd+2) elements;
// split_keys must be the body's keys per split at this head_dim
// (`decode_split_keys`). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches.
extern "C" int flash_decode_verify_attention(
    const void* q, const void* k, const void* v, const int* kv_len, void* o,
    float* ws, long long ws_floats, int split_keys, int dtype, int B, int S,
    int T_len, int H, int K, int hd, int shift, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long o_sb, long long o_ss, float scale, void* stream) {
  if (K <= 0 || S <= 0 || T_len <= 0 || H % K != 0 ||
      S * (H / K) > MAX_ROWS || split_keys <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q; a.k = k; a.v = v; a.kv_len = kv_len; a.o = o; a.ws = ws;
  a.S = S; a.T = T_len; a.qg = H / K; a.R = S * a.qg; a.shift = shift;
  a.split = split_keys;
  a.nsplit = (T_len + split_keys - 1) / split_keys;
  a.q_sb = q_sb; a.q_ss = q_ss; a.k_sb = k_sb; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_ss = v_ss; a.o_sb = o_sb; a.o_ss = o_ss;
  a.scale_log2 = scale * 1.4426950408889634f;
  if (ws_floats < (long long)B * K * a.nsplit * a.R * (hd + 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SPLIT_HD(TYPE)                                  \
  switch (hd) {                                               \
    case 16: return launch<TYPE, 16>(a, B, K, s);             \
    case 32: return launch<TYPE, 32>(a, B, K, s);             \
    case 64: return launch<TYPE, 64>(a, B, K, s);             \
    case 128: return launch<TYPE, 128>(a, B, K, s);           \
    case 256: return launch<TYPE, 256>(a, B, K, s);           \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }
  if (dtype == 0) {
    REPRO_SPLIT_HD(float)
  } else if (dtype == 1) {
    REPRO_SPLIT_HD(__nv_bfloat16)
  }
#undef REPRO_SPLIT_HD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the split body (bytes) for dtype (0 f32, 1
// bf16), head_dim and query tiles (16 rows each); 0 for a pair it does not
// take.
extern "C" int decode_split_smem_bytes(int dtype, int hd, int tiles) {
#define REPRO_SMEM(TYPE)                                               \
  switch (hd) {                                                        \
    case 16: return static_cast<int>(Smem<TYPE, 16>::bytes(tiles));    \
    case 32: return static_cast<int>(Smem<TYPE, 32>::bytes(tiles));    \
    case 64: return static_cast<int>(Smem<TYPE, 64>::bytes(tiles));    \
    case 128: return static_cast<int>(Smem<TYPE, 128>::bytes(tiles));  \
    case 256: return static_cast<int>(Smem<TYPE, 256>::bytes(tiles));  \
    default: return 0;                                                 \
  }
  if (dtype == 0) {
    REPRO_SMEM(float)
  } else if (dtype == 1) {
    REPRO_SMEM(__nv_bfloat16)
  }
#undef REPRO_SMEM
  return 0;
}

// keys per split of the body at a head_dim (0 for one it does not take)
extern "C" int decode_split_keys(int hd) {
  switch (hd) {
    case 16: return split_keys<16>();
    case 32: return split_keys<32>();
    case 64: return split_keys<64>();
    case 128: return split_keys<128>();
    case 256: return split_keys<256>();
    default: return 0;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
