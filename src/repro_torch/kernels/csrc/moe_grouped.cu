// The `experts` operator of an MoE layer over its routed pairs only, for
// Hopper (sm_90a): route, gate|up grouped GEMM, down grouped GEMM, combine.
//
// Replaces no TPU kernel: the JAX package computes the experts with one-hot
// einsums (src/repro/models/layers.py `moe_apply`), which XLA lowers to
// dense products over every (expert, capacity slot). The port's plain
// version (`models/layers.py` `moe_apply_ref`) gathers a slot table of
// (E, G * cap) rows and runs `bmm` over all E experts; at the capacity
// factor E/k the MoE cells serve (cap = g), that is E/k times the routed
// products (16x for Qwen3-30B-A3B, 21.3x for Kanana-2-30B-A3B). Here only
// the pairs the reference keeps are computed, with the reference's rule.
//
// What bounds it on the H100: bytes. A 512-token chunk of Qwen3 routes 4096
// pairs, 38.7 GFLOP (39 us at 989 TFLOP/s), against 1.21 GB of expert
// weights a layer (0.36 ms at 3.35 TB/s). At 4096 tokens (32768 pairs, 310
// GFLOP) the two bounds meet. So every expert's weight tiles are read from
// device memory once per call, and the tensor cores only have to keep up.
//
// Six launches from one C call on the caller's stream, and no host sync:
// every grid is sized from n * k and E alone, and the work a block finds is
// read from device memory, so the operator can be captured in a CUDA graph.
//
// 1. `route_scan_kernel`, one block per group: each pair's position in its
//    expert's queue within the group, token-major and slot-minor (the
//    reference's running count), and the group's count per expert. A chunk
//    of 1024 pairs is ranked by warp match (`__match_any_sync`) and an
//    exclusive scan over the 32 warps per expert: no atomics, the same
//    positions whatever the order the warps run in.
// 2. `route_plan_kernel`, one block: per local expert the kept rows (pos <
//    cap, expert in [e0, e0 + El)) of each group and in all, its first row
//    (experts in order, each expert's rows group-major then by position)
//    and its M tiles of BM rows, whose offsets are the exclusive scan of
//    ceil(rows / BM); the tile list (expert, first row, end row) and its
//    length.
// 3. `route_gather_kernel`, a warp per pair: the pair's row (-1 where it is
//    dropped or another rank's expert) and a copy of its token's activation
//    row into a contiguous (n * k, D) buffer. 16 MB at 4096 pairs against
//    1.21 GB of weights: a copy is cheaper than a gathering GEMM producer,
//    and TMA cannot gather rows.
// 4. `grouped_gemm_tc_kernel<GATE_UP>`: for each (M tile, N tile) of the
//    tile list, silu(x W_gate) * (x W_up) over the tile's 128 rows and 64
//    columns of F, stored in bf16 once (rows, F).
//    - A persistent grid of one block per SM walks the (M tile, N tile)
//      pairs with N tiles fastest. The blocks at work at one time then
//      read the same weight rows side by side (all of an expert's columns,
//      so device memory serves whole rows), and an expert's M tiles follow
//      each other closely enough that all but the first read its weight
//      tiles from L2: each weight tile leaves device memory once per call.
//    - Three warpgroups: a producer, of which one thread issues TMA, and
//      two consumers that own 64 rows each. A six-stage ring of 64-deep
//      stages holds the tile's activation rows (two 64-row boxes; the
//      second is not loaded where the tile has no rows there) and its
//      weight columns (two 64-column boxes, 128-byte swizzle), each stage
//      guarded by a full and an empty mbarrier. The ring runs on across
//      tiles, so the next tile's loads overlap this tile's epilogue.
//    - One wgmma m64n128k16 per 16-deep slice: A K-major, B the weight
//      matrix as it is stored, (K, N) with N innermost (MN-major). The
//      gate|up tile's two B boxes are gate columns [64j, 64j + 64) and up
//      columns F + [64j, 64j + 64), so accumulator column c (gate) and c +
//      64 (up) of a row sit in the same thread: the epilogue forms silu(g)
//      u in f32 from the accumulators.
//    - Both consumers issue every product, also one whose 64 rows are all
//      past the expert's count (its A box is then not loaded, and nothing
//      of it is stored): ptxas serialises a wgmma under a branch it cannot
//      prove uniform. With that branch, and M tiles fastest, a 512-token
//      chunk of Qwen3 took 0.77 ms on an H100 against 0.53 ms without.
// 5. `grouped_gemm_tc_kernel<DOWN>`: the same body over (rows, F) x (F, D),
//    128 output columns a tile, each row rounded to bf16 (the reference's
//    ye) and stored (rows, D).
// 6. `combine_kernel`: each token's k rows times their weights rounded to
//    the activation dtype (as the reference casts them), summed in slot
//    order in f32, rounded once, and added into the residual where one is
//    given (the segment's `h += y`, fused). No float atomics. The weight
//    product sits here rather than in the down epilogue: bf16 x bf16 is
//    exact in f32, so the sum is the same and ye is stored in half the
//    bytes.
//
// f32 activations, or widths the tensor-core body does not take (D not a
// multiple of 128 or F of 64), run `grouped_gemm_simt_kernel` in place of 4
// and 5: f32 FMA on the CUDA cores over the same tile list, 32 output
// columns a block. Everything else is shared.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;                // rows per M tile (two warpgroups of 64)
constexpr int SCAN_THREADS = 1024;     // pairs a route_scan pass ranks
constexpr int MAX_EXPERTS = 1024;
constexpr int GATE_UP = 0, DOWN = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + __expf(-g));
}

// ---- route ----------------------------------------------------------------

// pos[p] for every pair p of group blockIdx.x whose expert is in [0, E);
// cnt[group * E + e] the group's pairs routed to e. gk pairs a group.
__global__ void __launch_bounds__(SCAN_THREADS)
route_scan_kernel(const long long* __restrict__ idx, int gk, int E,
                  int* __restrict__ pos, int* __restrict__ cnt) {
  extern __shared__ int sh[];
  int* wcnt = sh;                      // [32 warps][E], then their offsets
  int* run = sh + 32 * E;              // [E] pairs ranked so far
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < 33 * E; i += SCAN_THREADS) sh[i] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * gk;
  for (int c0 = 0; c0 < gk; c0 += SCAN_THREADS) {
    const int p = c0 + tid;
    int e = -1;
    if (p < gk) {
      const long long v = idx[base + p];
      e = v >= 0 && v < E ? static_cast<int>(v) : -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (e >= 0 && rank == 0) wcnt[warp * E + e] = __popc(peers);
    __syncthreads();
    for (int x = tid; x < E; x += SCAN_THREADS) {
      int r = run[x];
      for (int w = 0; w < 32; ++w) {
        const int c = wcnt[w * E + x];
        wcnt[w * E + x] = r;
        r += c;
      }
      run[x] = r;
    }
    __syncthreads();
    if (e >= 0) pos[base + p] = wcnt[warp * E + e] + rank;
    __syncthreads();
    for (int i = tid; i < 32 * E; i += SCAN_THREADS) wcnt[i] = 0;
    __syncthreads();
  }
  for (int x = tid; x < E; x += SCAN_THREADS)
    cnt[(long long)blockIdx.x * E + x] = run[x];
}

// One block. grp_base[g * El + el]: the rows of local expert el kept in
// groups before g; row_off[el]: its first row; tiles[t] = (el, first row,
// end row of el) for each of its M tiles, experts in order; meta[0]: the
// number of tiles.
__global__ void __launch_bounds__(1024)
route_plan_kernel(const int* __restrict__ cnt, int G, int E, int e0, int El,
                  int cap, int* __restrict__ grp_base,
                  int* __restrict__ row_off, int4* __restrict__ tiles,
                  int* __restrict__ meta) {
  __shared__ int tot[MAX_EXPERTS], roff[MAX_EXPERTS], toff[MAX_EXPERTS];
  const int tid = threadIdx.x, lane = tid % 32;
  for (int el = tid; el < El; el += blockDim.x) {
    int r = 0;
    for (int g = 0; g < G; ++g) {
      grp_base[(long long)g * El + el] = r;
      r += min(cnt[(long long)g * E + e0 + el], cap);
    }
    tot[el] = r;
  }
  __syncthreads();
  if (tid < 32) {
    // each lane scans a run of experts; the runs are joined by shuffles
    const int per = (El + 31) / 32;
    const int lo = min(lane * per, El), hi = min(lo + per, El);
    int rows = 0, nt = 0;
    for (int el = lo; el < hi; ++el) {
      rows += tot[el];
      nt += (tot[el] + BM - 1) / BM;
    }
    int rs = rows, ts = nt;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int a = __shfl_up_sync(0xffffffffu, rs, d);
      const int b = __shfl_up_sync(0xffffffffu, ts, d);
      if (lane >= d) {
        rs += a;
        ts += b;
      }
    }
    int r0 = rs - rows, t0 = ts - nt;
    for (int el = lo; el < hi; ++el) {
      roff[el] = r0;
      toff[el] = t0;
      r0 += tot[el];
      t0 += (tot[el] + BM - 1) / BM;
    }
    if (lane == 31) meta[0] = ts;
  }
  __syncthreads();
  for (int el = tid; el < El; el += blockDim.x) {
    row_off[el] = roff[el];
    const int n = (tot[el] + BM - 1) / BM;
    for (int j = 0; j < n; ++j)
      tiles[toff[el] + j] =
          make_int4(el, roff[el] + j * BM, roff[el] + tot[el], 0);
  }
}

// A warp per pair: pair_row[p] (-1 where dropped or another rank's) and the
// token's row of x copied into xg at it; vec16: rows are whole 16-byte
// vectors.
template <typename T>
__global__ void __launch_bounds__(256)
route_gather_kernel(const long long* __restrict__ idx,
                    const int* __restrict__ pos,
                    const int* __restrict__ grp_base,
                    const int* __restrict__ row_off, const T* __restrict__ x,
                    long long n_pairs, int k, int gk, int E, int e0, int El,
                    int cap, int D, int vec16, int* __restrict__ pair_row,
                    T* __restrict__ xg) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long p = (long long)blockIdx.x * (blockDim.x / 32) +
                     threadIdx.x / 32;
       p < n_pairs; p += warps) {
    const long long v = idx[p];
    const long long el = v - e0;
    int row = -1;
    if (v >= 0 && v < E && el >= 0 && el < El) {
      const int ps = pos[p];
      if (ps < cap)
        row = row_off[el] + grp_base[(p / gk) * El + el] + ps;
    }
    if (lane == 0) pair_row[p] = row;
    if (row < 0) continue;
    const T* src = x + (p / k) * (long long)D;
    T* dst = xg + (long long)row * D;
    if (vec16) {
      const int nv = D * (int)sizeof(T) / 16;
      for (int i = lane; i < nv; i += 32)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int i = lane; i < D; i += 32) dst[i] = src[i];
    }
  }
}

// ---- the grouped GEMMs on the tensor cores (bf16) -------------------------

namespace tc {

constexpr int BK = 64;                 // reduction depth of a stage
constexpr int BOX = 64;                // columns of a TMA box: 128 bytes
constexpr int HALF = 64;               // rows of a consumer warpgroup
constexpr int NS = 6;                  // stages in the ring
constexpr int NTHREADS = 3 * 128;      // producer + two consumer warpgroups
constexpr int CONSUMERS = 2 * 128;     // arrivals that free a stage

struct __align__(1024) Smem {
  // every box starts on a 1024-byte boundary (HALF * BK * 2 = 8 KB)
  bf16 a[NS][2 * HALF * BK];           // two 64-row boxes of activations
  bf16 b[NS][2 * BK * BOX];            // two 64-column boxes of weights
  uint64_t full[NS];
  uint64_t empty[NS];
};

constexpr size_t SMEM = sizeof(Smem) + 1024;   // room to align the base

// tm_a: the (rows, K) activations, boxes of 64 x 64; tm_b: the (El, K, N)
// weights, boxes of 64 columns x 64 rows x 1 expert. GATE_UP: N = 2F, out
// (rows, F) = silu(gate) * up of N tile j's columns [64j, 64j + 64) and F +
// the same; DOWN: out (rows, D) of columns [128j, 128j + 128). n_nt: N
// tiles; ldo: out's row length.
template <int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
grouped_gemm_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const int4* __restrict__ tiles,
                       const int* __restrict__ meta, int n_nt, int K,
                       int col_up, bf16* __restrict__ out, int ldo) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_mt = meta[0];
  const int total = n_mt * n_nt;
  const int kblocks = K / BK;

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load ----------------------
    if (threadIdx.x == 0) {
      int it = 0;                      // stages filled, across tiles
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        const int4 t = tiles[w / n_nt];
        const int nt = w % n_nt;
        const bool two = t.y + HALF < t.z;
        const int c0 = EPI == GATE_UP ? nt * BOX : nt * 2 * BOX;
        const int c1 = EPI == GATE_UP ? col_up + nt * BOX : c0 + BOX;
        const uint32_t bytes = (two ? 2 : 1) * HALF * BK * 2 + 2 * BK * BOX * 2;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % NS;
          mbar_wait(&sm.empty[s], ((it / NS) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.full[s], bytes);
          tma_load_3d(sm.b[s], &tm_b, &sm.full[s], c0, kb * BK, t.x);
          tma_load_3d(sm.b[s] + BK * BOX, &tm_b, &sm.full[s], c1, kb * BK,
                      t.x);
          tma_load_2d(sm.a[s], &tm_a, &sm.full[s], kb * BK, t.y);
          if (two)
            tma_load_2d(sm.a[s] + HALF * BK, &tm_a, &sm.full[s], kb * BK,
                        t.y + HALF);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of a tile ----
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128;
  const int warp = (ct % 128) / 32;
  const int lane = ct % 32;
  const int t4 = lane % 4;
  float acc[64];
  int it = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const int4 t = tiles[w / n_nt];
    const int nt = w % n_nt;
    const int row0 = t.y + HALF * cw;
    // both warpgroups issue every product (see the header)
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % NS;
      mbar_wait(&sm.full[s], (it / NS) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da =
            sw128_desc(sm.a[s] + cw * HALF * BK + kk * 16, 16, 1024);
        const uint64_t db =
            sw128_desc(sm.b[s] + kk * 16 * BOX, BK * BOX * 2, 1024);
        wgmma_m64n128k16_ss_tb(acc, da, db, (kb > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<1>();                 // the previous stage's products are in
      fence_regs(acc);
      if (kb > 0) mbar_arrive(&sm.empty[(it - 1) % NS]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty[(it - 1) % NS]);
    if (row0 >= t.z) continue;

    // accumulator register 4c + 2i + j: row 16 warp + lane / 4 + 8 i,
    // column 8c + 2 t4 + j
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 16 * warp + lane / 4 + 8 * i;
      if (r >= t.z) continue;
      if (EPI == GATE_UP) {
        bf16* o = out + (long long)r * ldo + nt * BOX + 2 * t4;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float h0 = silu(acc[4 * c + 2 * i]) * acc[4 * (c + 8) + 2 * i];
          const float h1 =
              silu(acc[4 * c + 2 * i + 1]) * acc[4 * (c + 8) + 2 * i + 1];
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * c) =
              __floats2bfloat162_rn(h0, h1);
        }
      } else {
        bf16* o = out + (long long)r * ldo + nt * 2 * BOX + 2 * t4;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * c) =
              __floats2bfloat162_rn(acc[4 * c + 2 * i],
                                    acc[4 * c + 2 * i + 1]);
      }
    }
  }
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

// a bf16 tensor of `rank` dims (innermost first) and strides in elements of
// dims 1.. as a 128-byte-swizzled tensor map with boxes of `box`; reads past
// a dim's end are zeros
int encode(CUtensorMap* map, const void* ptr, int rank,
           const cuuint64_t* dims, const long long* strides,
           const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t bytes[2];
  for (int i = 0; i + 1 < rank; ++i) bytes[i] = (cuuint64_t)strides[i] * 2;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "moe_grouped_ffn: cuTensorMapEncodeTiled failed with "
            "CUresult %d\n", static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// out (rows, N_out) from a (rows, K) and the weights w (El, K, N): one of
// the two products, on a persistent grid of one block per SM
template <int EPI>
int launch(const void* a, long long rows, int K, const void* w, int El,
           int N, int n_nt, int col_up, const int4* tiles, const int* meta,
           void* out, int ldo, int grid, cudaStream_t stream) {
  CUtensorMap ta, tb;
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const long long sa[1] = {K};
  const cuuint32_t ba[2] = {BK, HALF};
  const cuuint64_t db[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)El};
  const long long sb[2] = {N, (long long)K * N};
  const cuuint32_t bb[3] = {BOX, BK, 1};
  int err = encode(&ta, a, 2, da, sa, ba);
  if (!err) err = encode(&tb, w, 3, db, sb, bb);
  if (err) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_gemm_tc_kernel<EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  grouped_gemm_tc_kernel<EPI><<<grid, NTHREADS, SMEM, stream>>>(
      ta, tb, tiles, meta, n_nt, K, col_up, static_cast<bf16*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- the grouped GEMMs on the CUDA cores (f32 FMA) ------------------------

namespace simt {

constexpr int BN = 32;                 // output columns a block
constexpr int BKS = 16;                // reduction depth a pass
constexpr int NTHREADS = 256;          // column tid % 32, rows tid / 32 + 8 j

// The same products as tc:: over the same tile list: GATE_UP out (rows, F)
// = silu(a W[:, c]) * (a W[:, F + c]), DOWN out (rows, N) = a W; W (El, K,
// N) in T, summed in f32.
template <typename T, int EPI>
__global__ void __launch_bounds__(NTHREADS)
grouped_gemm_simt_kernel(const T* __restrict__ a, const T* __restrict__ w,
                         const int4* __restrict__ tiles,
                         const int* __restrict__ meta, int n_nt, int K,
                         int N, int n_out, T* __restrict__ out) {
  __shared__ float as[BKS][BM];
  __shared__ float bs[2][BKS][BN];
  const int tid = threadIdx.x, col = tid % BN, rg = tid / BN;
  const int n_mt = meta[0];
  const int total = n_mt * n_nt;
  for (int wi = blockIdx.x; wi < total; wi += gridDim.x) {
    const int4 t = tiles[wi % n_mt];
    const int c0 = (wi / n_mt) * BN;
    const T* wp = w + (long long)t.x * K * N;
    float acc[BM / 8], accu[BM / 8];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) acc[j] = accu[j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BKS) {
      for (int i = tid; i < BKS * BM; i += NTHREADS) {
        const int r = i / BKS, kk = i % BKS;
        const int row = t.y + r;
        as[kk][r] = row < t.z && k0 + kk < K
                        ? to_f(a[(long long)row * K + k0 + kk]) : 0.f;
      }
      for (int i = tid; i < BKS * BN; i += NTHREADS) {
        const int kk = i / BN, c = i % BN;
        const bool ok = k0 + kk < K && c0 + c < n_out;
        const long long off = (long long)(k0 + kk) * N + c0 + c;
        bs[0][kk][c] = ok ? to_f(wp[off]) : 0.f;
        if (EPI == GATE_UP) bs[1][kk][c] = ok ? to_f(wp[off + n_out]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BKS; ++kk) {
        const float b = bs[0][kk][col];
        const float bu = EPI == GATE_UP ? bs[1][kk][col] : 0.f;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float x = as[kk][rg + 8 * j];
          acc[j] = fmaf(x, b, acc[j]);
          if (EPI == GATE_UP) accu[j] = fmaf(x, bu, accu[j]);
        }
      }
      __syncthreads();
    }
    if (c0 + col >= n_out) continue;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int row = t.y + rg + 8 * j;
      if (row >= t.z) continue;
      const float v = EPI == GATE_UP ? silu(acc[j]) * accu[j] : acc[j];
      out[(long long)row * n_out + c0 + col] = from_f<T>(v);
    }
  }
}

}  // namespace simt

// ---- combine ----------------------------------------------------------------

// V elements of a row to f32 and back: one 16-byte access where V > 1
template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(*p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(f[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// A block per token: out[t] = (res[t] +) round(sum_j ye[pair_row[t, j]] *
// round(w[t, j])), the sum over the k slots in order in f32; res may be out
// itself. V elements a thread access (D % V == 0).
template <typename T, int V>
__global__ void __launch_bounds__(256)
combine_kernel(const T* __restrict__ ye, const int* __restrict__ pair_row,
               const float* __restrict__ wts, const T* res, T* out, int k,
               int D) {
  __shared__ int rows[64];
  __shared__ float ws[64];
  const long long tok = blockIdx.x;
  if (threadIdx.x < k) {
    rows[threadIdx.x] = pair_row[tok * k + threadIdx.x];
    ws[threadIdx.x] = to_f(from_f<T>(wts[tok * k + threadIdx.x]));
  }
  __syncthreads();
  for (int d = threadIdx.x * V; d < D; d += blockDim.x * V) {
    float acc[V], y[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      if (rows[j] < 0) continue;
      load_f<T, V>(ye + (long long)rows[j] * D + d, y);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(y[i], ws[j], acc[i]);
    }
    const long long o = tok * D + d;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = to_f(from_f<T>(acc[i]));
    if (res != nullptr) {
      load_f<T, V>(res + o, y);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = y[i] + acc[i];
    }
    store_f<T, V>(out + o, acc);
  }
}

// ---- workspace ------------------------------------------------------------

// byte offsets of the workspace's parts, each 256-byte aligned: pos,
// cnt, grp_base, row_off, tiles, meta, pair_row, xg, inter, ye, end
constexpr int PARTS = 10;

long long align256(long long x) { return (x + 255) / 256 * 256; }

void layout(int n, int k, int G, int E, int El, int D, int F, int es,
            long long* off) {
  const long long pairs = (long long)n * k;
  const long long max_tiles = (pairs + BM - 1) / BM + El;
  const long long size[PARTS] = {
      pairs * 4, (long long)G * E * 4, (long long)G * El * 4, El * 4LL,
      max_tiles * 16, 16, pairs * 4, pairs * D * es, pairs * F * es,
      pairs * D * es};
  long long at = 0;
  for (int i = 0; i < PARTS; ++i) {
    off[i] = at;
    at = align256(at + size[i]);
  }
  off[PARTS] = at;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

template <typename T>
int run(const void* x, const float* wts, const long long* idx, const void* w1,
        const void* w2, const void* res, void* out, uint8_t* ws, int n,
        int k, int G, int cap, int E, int e0, int El, int D, int F,
        bool tensor_core, cudaStream_t stream) {
  long long off[PARTS + 1];
  layout(n, k, G, E, El, D, F, sizeof(T), off);
  int* pos = reinterpret_cast<int*>(ws + off[0]);
  int* cnt = reinterpret_cast<int*>(ws + off[1]);
  int* grp_base = reinterpret_cast<int*>(ws + off[2]);
  int* row_off = reinterpret_cast<int*>(ws + off[3]);
  int4* tiles = reinterpret_cast<int4*>(ws + off[4]);
  int* meta = reinterpret_cast<int*>(ws + off[5]);
  int* pair_row = reinterpret_cast<int*>(ws + off[6]);
  T* xg = reinterpret_cast<T*>(ws + off[7]);
  T* inter = reinterpret_cast<T*>(ws + off[8]);
  T* ye = reinterpret_cast<T*>(ws + off[9]);
  const long long pairs = (long long)n * k;
  const int gk = static_cast<int>(pairs / G);

  const int scan_smem = 33 * E * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      route_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      33 * MAX_EXPERTS * 4);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  route_scan_kernel<<<G, SCAN_THREADS, scan_smem, stream>>>(idx, gk, E, pos,
                                                            cnt);
  route_plan_kernel<<<1, 1024, 0, stream>>>(cnt, G, E, e0, El, cap, grp_base,
                                            row_off, tiles, meta);
  const int vec16 = (D * sizeof(T)) % 16 == 0;
  const long long gblocks = (pairs + 7) / 8;
  route_gather_kernel<T><<<(int)(gblocks < 4096 ? gblocks : 4096), 256, 0,
                           stream>>>(idx, pos, grp_base, row_off,
                                     static_cast<const T*>(x), pairs, k, gk,
                                     E, e0, El, cap, D, vec16, pair_row, xg);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const long long max_tiles = (pairs + BM - 1) / BM + El;
  const int sms = sm_count();
  if (tensor_core) {
    const int nt1 = F / tc::BOX, nt2 = D / (2 * tc::BOX);
    const int g1 = (int)(max_tiles * nt1 < sms ? max_tiles * nt1 : sms);
    const int g2 = (int)(max_tiles * nt2 < sms ? max_tiles * nt2 : sms);
    err = tc::launch<GATE_UP>(xg, pairs, D, w1, El, 2 * F, nt1, F, tiles,
                              meta, inter, F, g1, stream);
    if (!err)
      err = tc::launch<DOWN>(inter, pairs, F, w2, El, D, nt2, 0, tiles, meta,
                             ye, D, g2, stream);
  } else {
    const int nt1 = (F + simt::BN - 1) / simt::BN;
    const int nt2 = (D + simt::BN - 1) / simt::BN;
    const long long cap1 = max_tiles * nt1, cap2 = max_tiles * nt2;
    simt::grouped_gemm_simt_kernel<T, GATE_UP>
        <<<(int)(cap1 < 4 * sms ? cap1 : 4 * sms), simt::NTHREADS, 0,
           stream>>>(static_cast<const T*>(xg), static_cast<const T*>(w1),
                     tiles, meta, nt1, D, 2 * F, F, inter);
    simt::grouped_gemm_simt_kernel<T, DOWN>
        <<<(int)(cap2 < 4 * sms ? cap2 : 4 * sms), simt::NTHREADS, 0,
           stream>>>(static_cast<const T*>(inter),
                     static_cast<const T*>(w2), tiles, meta, nt2, F, D, D,
                     ye);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err) return err;
  constexpr int V = 16 / sizeof(T);
  const T* r = static_cast<const T*>(res);
  if (D % V == 0)
    combine_kernel<T, V><<<n, 256, 0, stream>>>(ye, pair_row, wts, r,
                                               static_cast<T*>(out), k, D);
  else
    combine_kernel<T, 1><<<n, 256, 0, stream>>>(ye, pair_row, wts, r,
                                               static_cast<T*>(out), k, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Workspace byte offsets of the parts (see `layout`) and its size, at
// off[0..PARTS]; returns PARTS.
extern "C" int moe_grouped_layout(int n, int k, int G, int E, int El, int D,
                                  int F, int es, long long* off) {
  layout(n, k, G, E, El, D, F, es, off);
  return PARTS;
}

// The experts of n tokens x (n, D) routed to idx (n, k) int64 with weights
// wts (n, k) f32, in G groups of n / G tokens at capacity cap per expert
// and group; only experts [e0, e0 + El) of E run, with w1 (El, D, 2F)
// gate|up and w2 (El, F, D). out (n, D) = the combine, plus res where res
// is not null (res may be out). dtype 0 f32, 1 bf16; bf16 with D % 128 ==
// 0 and F % 64 == 0 runs the tensor-core GEMMs and sets *tensor_core.
// Returns cudaGetLastError() after the launches, or the error that stopped
// them.
extern "C" int moe_grouped_ffn(const void* x, const void* wts,
                               const void* idx, const void* w1,
                               const void* w2, const void* res, void* out,
                               void* ws, int dtype, int n, int k, int G,
                               int cap, int E, int e0, int El, int D, int F,
                               void* stream, int* tensor_core) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *tensor_core = dtype == 1 && D % 128 == 0 && F % 64 == 0;
  if (n <= 0 || k <= 0 || k > 64 || G <= 0 || n % G || E <= 0 ||
      E > MAX_EXPERTS || El <= 0 || e0 < 0 || e0 + El > E)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w = static_cast<const float*>(wts);
  const long long* ix = static_cast<const long long*>(idx);
  uint8_t* wb = static_cast<uint8_t*>(ws);
  if (dtype == 0)
    return run<float>(x, w, ix, w1, w2, res, out, wb, n, k, G, cap, E, e0,
                      El, D, F, false, s);
  if (dtype == 1)
    return run<bf16>(x, w, ix, w1, w2, res, out, wb, n, k, G, cap, E, e0,
                     El, D, F, *tensor_core != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moe_grouped_tc_smem_bytes() {
  return static_cast<int>(tc::SMEM);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
