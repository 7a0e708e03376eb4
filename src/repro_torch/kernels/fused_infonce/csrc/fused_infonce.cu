// Blocked InfoNCE for Hopper (sm_90a): the forward row statistics and the
// two backward products of the contrastive loss, without the (M, N) score
// matrix ever reaching device memory.
//
// Replaces the TPU kernels of src/repro/kernels/fused_infonce/fused_infonce.py:
//   forward  _fwd_kernel (:54) -> bf16: hp::infonce_fwd_small_kernel at up to 16
//                                 query rows (hp::infonce_fwd_split_kernel past d =
//                                 1024), hp::infonce_fwd_rows_kernel above (+
//                                 infonce_stats_merge_kernel); fp32 with d a
//                                 multiple of 4: tx::infonce_tf32x3_fwd_kernel
//                                 (3xTF32, + the merge); else infonce_fwd_kernel
//   dQ       _dq_kernel (:205) -> bf16: hp::infonce_small_kernel<true> at up to 16
//                                 query rows (hp::infonce_dq_split_kernel past d =
//                                 1024) (+ infonce_grad_reduce_kernel); fp32 with d
//                                 a multiple of 4: tx::infonce_tf32x3_kernel<true>
//                                 (3xTF32, + the reduce kernel where split); else
//                                 infonce_dq_kernel
//   dP       _dp_kernel (:229) -> bf16: hp::infonce_small_kernel<false> at up to 16
//                                 query rows (hp::infonce_dp_split_kernel past d =
//                                 1024), hp::infonce_dp_cluster_kernel above; fp32
//                                 with d a multiple of 4:
//                                 tx::infonce_tf32x3_kernel<false>; else
//                                 infonce_dp_kernel (+ infonce_grad_reduce_kernel)
// ops.py picks the kernel of each call (ops.path_of). Same contract. s = (q .
// p_n) * inv_tau, products accumulated in fp32; an invalid column
// (col_valid[n] == 0) has s = -1e30 (finite, never -inf), so a fully masked
// row gets lse ~ -1e30 and no NaN. Per row: lse over the columns, pos = s
// at labels[i] (0 when the label is outside [0, N), -1e30 when it points at
// a masked column), amax = the running max. Backward: coeff = exp(s - lse) *
// g_lse + onehot(label) * g_pos, zero on masked columns, times inv_tau,
// rounded to the operand type BEFORE its product (as the TPU kernel's
// coeff.astype(p.dtype)); dQ = coeff . P and dP = coeff^T . Q accumulate in
// fp32 and are cast to the operand type at the end. No float atomics and a
// fixed summation order: two calls on the same inputs give the same bits.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), bf16, d=768,
// at the shapes of a contaccum_bf16 chunk (N = 8 + 8 + 2048 = 2064 columns):
//   local queries, M=8:     fwd ~1.0 us, dQ ~1.0 us, dP ~1.9 us, all set by
//                           the bytes of P (3.2 MB); the products are tiny.
//   query-bank rows, M=2048: fwd 2*M*N*d = 6.5 GFLOP ~6.6 us and dP
//                           4*M*N*d = 13 GFLOP ~13 us, set by the tensor cores.
//
// bf16 on Hopper (namespace hp): TMA, wgmma, statistics and coefficients
// from the registers that hold the scores.
//  - The forward: each block owns one tile of 64 passages (wgmma's 64 rows)
//    and a range of query rows, and writes for each row that tile's partial
//    (max, sum-exp, pos) to part (3, M, tiles); infonce_stats_merge_kernel
//    combines each row's partials (a warp a row, a fixed order), launched
//    as a programmatic dependent so its launch overlaps the tiles. A
//    tile's statistics come from its score registers: the two passage rows
//    a thread holds, a reduce-scatter over lane bits 2-4, the 4 warps
//    through 2 KB of shared memory per 128 queries.
//    M <= 16: infonce_fwd_small_kernel, the scores as in the small dQ/dP
//    kernel below (33 blocks at N = 2064); what bounds it: launch and TMA
//    latency. M > 16: infonce_fwd_rows_kernel, a block per (passage tile,
//    group of ops.fwd_plan rows: 4 of 512 at M = 2048, 132 blocks, one
//    wave); a producer warp streams (P chunk, 256-row Q chunk) stages
//    through a 5-stage ring to two consumer warpgroups (m64n128 each), the
//    dP cluster kernel's pass 1 without the cluster. What bounds it: each
//    SM's stream of Q and P from L2 (about 1 MB a block), not the tensor
//    cores. Three warps share an SM sub-partition, so a thread has at most
//    168 registers: the statistics make each value just before its first
//    shuffle. A tile whose passages are all masked computes nothing and
//    writes what computing it gives (max -1e30, sum-exp its in-range
//    columns, pos -1e30 where the label lies in it).
//  - dQ and dP at M <= 16: one block of one warpgroup per 64 passages.
//    Thread 0 puts the block's whole P tile and the queries in flight by
//    TMA, a barrier per d-chunk; S^T = P Q^T runs as wgmma m64n16 with the
//    queries as N (rows past M are TMA's zeros). The coefficients are
//    computed in registers. dP: they are the register A operand of one
//    k-step per d-chunk (dP tile = C^T Q, Q the MN-major B); the tile is
//    staged in bf16 where P was and written in 16-byte stores. dQ: C^T
//    goes to shared memory as a K-major B, dQ^T = P^T C^T (P the MN-major
//    A), one fp32 partial per block, summed in block order by
//    infonce_grad_reduce_kernel. P is read once; no row is padding except
//    wgmma's N of 16 for 8 queries. What bounds it: launch and TMA latency
//    (33 blocks), not bytes.
//  - dP at M > 16: infonce_dp_cluster_kernel, clusters of `ranks` blocks on
//    one tile of 64 passages (ops.dp_plan: 3 ranks of 768 rows at M = 2048,
//    99 blocks, one wave). A producer warp feeds two consumer warpgroups
//    through an mbarrier ring. Pass 1: each rank's query rows in tiles of
//    256, S^T by wgmma m64n128 (the passages as its 64 rows), coefficients
//    in registers, rounded to bf16 and stored in the rank's strip as the
//    register A operand of the next product. Cluster barrier. Pass 2: each
//    rank takes a third of d (2 d-chunks per warpgroup) and accumulates dP
//    += C^T Q over every query row, reading the other ranks' coefficients
//    through distributed shared memory (one k-tile ahead); bf16 out, one
//    launch, no fp32 partial in device memory. What bounds it: each block's
//    stream of Q and P tiles through a ring of about 100 KB (the strip takes
//    the rest of shared memory); the tensor cores run at about a quarter of
//    their peak.
//  - Past d = 1024 (16 d-chunks; the LM retriever's 2048), up to 8192: at
//    M > 16 the cluster dP and the rows forward as above (nothing in their
//    plans depends on d: the dP's 3 ranks each take 10-11 of the 32 chunks
//    in groups of up to 4; the forward's ring streams 32 chunks a query
//    tile). At M <= 16 the small kernels' P tile (10 KB a d-chunk with the
//    queries) no longer fits a block: the split kernels
//    (infonce_fwd_split_kernel, infonce_dq_split_kernel,
//    infonce_dp_split_kernel) put a cluster of ceil(nc / 16) blocks on each
//    passage tile, each rank on its share of the d-chunks; the partial
//    scores are summed through distributed shared memory in rank order,
//    then each rank writes its columns of dP or of dQ's partial, and rank 0
//    the forward's partials; see the kernels.
//  - A dQ or dP block whose passages are all masked writes zeros and
//    computes nothing.
//
// fp32 operands with d a multiple of 4 run 3xTF32 on wgmma (namespace tx,
// below): the forward up to d = 8192, dQ and dP up to 1536. fp32 at other
// d, and the bf16 shapes the Hopper kernels do not take (d not a multiple
// of 8 or above 8192; dQ above 16 rows, dP above 6144 rows) keep the first
// design: 64 x 64 score tiles on wmma bf16 16x16x16 (fp32
// inputs: a CUDA-core FMA loop, no TF32), looping over d in chunks of 64
// with synchronous loads; the backward kernels first compute the block's
// coefficient strip (64 x up to 512) into shared memory, then take the
// product one d-chunk at a time. At M=8 the long axis is split: (row tile x
// column split) blocks for fwd and dQ, (column tile x row split) blocks for
// dP, each walking up to SPLIT_TILES tiles; a second pass merges the
// splits: the forward's (max, sum-exp) pairs by the online-softmax combine,
// the gradients by an fp32 sum of per-split partials, in split order.
//
// Plain C interface for ctypes: pointers and the stream are void*, each
// launch returns cudaGetLastError(). Nothing is allocated or synchronised
// here; ops.py allocates outputs and scratch with torch.empty.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;           // rows (queries) per tile
constexpr int BN = 64;           // columns (passages) per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT_TILES = 8;   // most tiles a block walks on the split axis
constexpr int SLD = BN + 4;      // score tile row stride, floats

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 64;      // d-chunk
  static constexpr int LD = BK + 8;  // 16-byte rows, skewed banks
  static constexpr int CPAD = 8;     // coefficient strip row padding
};
template <> struct Tile<float> {
  static constexpr int BK = 32;
  static constexpr int LD = BK + 1;  // odd stride: conflict-free column reads
  static constexpr int CPAD = 4;
};

// coefficient strip of dQ: BM rows x (SPLIT_TILES * BN) columns;
// of dP: (SPLIT_TILES * BM) rows x BN columns
template <typename T> __host__ __device__ constexpr int cld_q() { return SPLIT_TILES * BN + Tile<T>::CPAD; }
template <typename T> __host__ __device__ constexpr int cld_p() { return BN + Tile<T>::CPAD; }

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
constexpr size_t base_smem() {  // q chunk, p chunk, score tile
  return 2 * align128(size_t(64) * Tile<T>::LD * sizeof(T)) +
         align128(size_t(BM) * SLD * sizeof(float));
}
template <typename T> constexpr size_t fwd_smem() {
  return base_smem<T>() + 4 * align128(BM * sizeof(float));
}
template <typename T> constexpr size_t dq_smem() {
  return base_smem<T>() + align128(size_t(BM) * cld_q<T>() * sizeof(T)) +
         4 * align128(BM * sizeof(float));
}
template <typename T> constexpr size_t dp_smem() {
  return base_smem<T>() +
         align128(size_t(SPLIT_TILES) * BM * cld_p<T>() * sizeof(T)) +
         4 * align128(size_t(SPLIT_TILES) * BM * sizeof(float));
}

template <typename T> __device__ __forceinline__ T to_t(float x);
template <> __device__ __forceinline__ float to_t<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Programmatic dependent launch: a grid launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the grid before it has called grid_dependents_launch (any one
// thread of it) or exited, and its grid_dependency_wait returns once that
// grid has finished and its writes are visible. Both are no-ops otherwise.
// The Hopper forward's blocks call it after their last scores, so the
// merge's launch overlaps their statistics and little of its wait counts
// as its time in a profile.
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A 64 x BK chunk of a row-major (rows_total, d) matrix into shared memory,
// zero past either edge. vec: 16-byte loads (d a multiple of 16 bytes' worth
// of T and a 16-byte aligned base).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, T* dst,
                                           int rows_total, int row0, int d,
                                           int k0, bool vec) {
  constexpr int BK = Tile<T>::BK, LD = Tile<T>::LD;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int PER_ROW = BK / VEC;
    for (int t = threadIdx.x; t < 64 * PER_ROW; t += THREADS) {
      const int r = t / PER_ROW, c = (t % PER_ROW) * VEC;
      const int gr = row0 + r, gc = k0 + c;
      const uint4 v =
          (gr < rows_total && gc < d)
              ? __ldg(reinterpret_cast<const uint4*>(src + size_t(gr) * d + gc))
              : make_uint4(0u, 0u, 0u, 0u);
      if constexpr ((LD * sizeof(T)) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
      } else {
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int y = 0; y < VEC; ++y) dst[r * LD + c + y] = e[y];
      }
    }
  } else {
    for (int t = threadIdx.x; t < 64 * BK; t += THREADS) {
      const int r = t / BK, c = t % BK;
      const int gr = row0 + r, gc = k0 + c;
      dst[r * LD + c] =
          (gr < rows_total && gc < d) ? src[size_t(gr) * d + gc] : to_t<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Score tile: S (BM x BN, fp32, unscaled) = Q rows row0.. . P rows n0..^T.
// bf16: 8 warps as 4 x 2 of 16 x 32 (two 16x16 fragments each).
// fp32: 16 x 16 threads, each rows ty + 16i, columns tx + 16j.
// ---------------------------------------------------------------------------
template <typename T> struct ScoreAcc;

template <> struct ScoreAcc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int BK = Tile<T>::BK, LD = Tile<T>::LD;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2];

  __device__ __forceinline__ void zero() {
    nvcuda::wmma::fill_fragment(f[0], 0.f);
    nvcuda::wmma::fill_fragment(f[1], 0.f);
  }
  __device__ __forceinline__ void mma(const T* q_s, const T* p_s) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, wr = warp / 2, wc = warp % 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, q_s + wr * 16 * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, p_s + (wc * 32 + j * 16) * LD + kk, LD);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* score_s) const {
    const int warp = threadIdx.x >> 5, wr = warp / 2, wc = warp % 2;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(score_s + wr * 16 * SLD + wc * 32 + j * 16,
                                      f[j], SLD, nvcuda::wmma::mem_row_major);
  }
};

// fp32: each 8 columns of d summed by FMAs from 0, then added to the score.
// A running sum over all of d = 768 puts the score of a logit of ~100
// many ulp off (each FMA rounds at the running sum's size), and a backward
// given this lse (the "fp32" route's, or the 3xTF32 kernels' where a caller
// mixes routes) takes its coefficients exp(s - lse) against scores of its
// own: the lse's error would reach the gradients whole. The partial sums
// cost one add per 8 FMAs.
template <> struct ScoreAcc<float> {
  static constexpr int BK = Tile<float>::BK, LD = Tile<float>::LD;
  float a[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
  }
  __device__ __forceinline__ void mma(const float* q_s, const float* p_s) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int k8 = 0; k8 < BK; k8 += 8) {
      float c[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll
      for (int kk = k8; kk < k8 + 8; ++kk) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = q_s[(ty + 16 * i) * LD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = p_s[(tx + 16 * j) * LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(x[i], y[j], c[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] += c[i][j];
    }
  }
  __device__ __forceinline__ void store(float* score_s) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) score_s[(ty + 16 * i) * SLD + tx + 16 * j] = a[i][j];
  }
};

// Leaves S in score_s. Opens and closes with a block barrier.
template <typename T>
__device__ void score_tile(const T* __restrict__ q, const T* __restrict__ p,
                           T* q_s, T* p_s, float* score_s, int M, int N, int d,
                           int row0, int n0, bool vec) {
  constexpr int BK = Tile<T>::BK;
  ScoreAcc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < d; k0 += BK) {
    __syncthreads();
    load_chunk(q, q_s, M, row0, d, k0, vec);
    load_chunk(p, p_s, N, n0, d, k0, vec);
    __syncthreads();
    acc.mma(q_s, p_s);
  }
  acc.store(score_s);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Gradient accumulator: G (64 x BK, fp32) += A (64 x 64) . B (64 x BK), B a
// chunk in shared memory (row = the summed index). A is the coefficient
// strip: for dQ row-major C[r][c_off + k], for dP transposed C[r_off + k][n].
// bf16: 8 warps as 4 x 2 of 16 x 32. fp32: rows ty + 16a, columns tx + 16b.
// ---------------------------------------------------------------------------
template <typename T> struct GradAcc;

template <> struct GradAcc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int LD = Tile<T>::LD;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2];

  __device__ __forceinline__ void zero() {
    nvcuda::wmma::fill_fragment(f[0], 0.f);
    nvcuda::wmma::fill_fragment(f[1], 0.f);
  }
  template <bool TRANS>
  __device__ __forceinline__ void mma(const T* c_s, int cld, int off, const T* b_s) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, wr = warp / 2, wc = warp % 2;
    using Layout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, Layout> a;
      if constexpr (TRANS)
        wmma::load_matrix_sync(a, c_s + (off + kk) * cld + wr * 16, cld);
      else
        wmma::load_matrix_sync(a, c_s + wr * 16 * cld + off + kk, cld);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_s + kk * LD + wc * 32 + j * 16, LD);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* out_s) const {
    const int warp = threadIdx.x >> 5, wr = warp / 2, wc = warp % 2;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(out_s + wr * 16 * SLD + wc * 32 + j * 16,
                                      f[j], SLD, nvcuda::wmma::mem_row_major);
  }
};

template <> struct GradAcc<float> {
  static constexpr int LD = Tile<float>::LD;
  float a[4][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i][0] = a[i][1] = 0.f;
  }
  template <bool TRANS>
  __device__ __forceinline__ void mma(const float* c_s, int cld, int off,
                                      const float* b_s) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < 64; ++kk) {
      float x[4], y[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = TRANS ? c_s[(off + kk) * cld + ty + 16 * i]
                     : c_s[(ty + 16 * i) * cld + off + kk];
#pragma unroll
      for (int j = 0; j < 2; ++j) y[j] = b_s[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* out_s) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) out_s[(ty + 16 * i) * SLD + tx + 16 * j] = a[i][j];
  }
};

// The backward coefficient of one logit (see the header); 0 when invalid.
__device__ __forceinline__ float coeff(float raw, float inv_tau, float lse,
                                       float g_lse, float g_pos, bool is_label) {
  const float s = raw * inv_tau;
  float c = expf(s - lse) * g_lse;
  if (is_label) c += g_pos;
  return c * inv_tau;
}

// Writes a finished 64 x BK gradient chunk (in out_s) to the output (one
// split: cast to T) or to this split's fp32 partial.
template <typename T>
__device__ __forceinline__ void write_grad(const float* out_s, T* out,
                                           float* partial, int rows_total,
                                           int row0, int d, int k0) {
  constexpr int BK = Tile<T>::BK;
  const bool direct = gridDim.y == 1;
  const size_t slab = size_t(blockIdx.y) * rows_total * d;
  for (int t = threadIdx.x; t < 64 * BK; t += THREADS) {
    const int r = t / BK, c = t % BK;
    const int gr = row0 + r, gc = k0 + c;
    if (gr < rows_total && gc < d) {
      const float v = out_s[r * SLD + c];
      if (direct)
        out[size_t(gr) * d + gc] = to_t<T>(v);
      else
        partial[slab + size_t(gr) * d + gc] = v;
    }
  }
}

struct Smem {
  unsigned char* at;
  template <typename U> __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(at);
    at += align128(bytes);
    return r;
  }
};

// ---------------------------------------------------------------------------
// Forward: grid (row tiles, column splits). Per row the block keeps the
// running (max, sum-exp, pos) of the online softmax over its column range;
// one warp owns a row for the whole walk.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
infonce_fwd_kernel(const T* __restrict__ q, const T* __restrict__ p,
                   const int* __restrict__ labels,
                   const uint8_t* __restrict__ col_valid, float* __restrict__ lse,
                   float* __restrict__ pos, float* __restrict__ amax,
                   float* __restrict__ part, int M, int N, int d,
                   int tiles_per_split, float inv_tau, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm{smem};
  T* q_s = sm.take<T>(size_t(64) * Tile<T>::LD * sizeof(T));
  T* p_s = sm.take<T>(size_t(64) * Tile<T>::LD * sizeof(T));
  float* score_s = sm.take<float>(size_t(BM) * SLD * sizeof(float));
  float* m_s = sm.take<float>(BM * sizeof(float));
  float* l_s = sm.take<float>(BM * sizeof(float));
  float* pos_s = sm.take<float>(BM * sizeof(float));
  int* lab_s = sm.take<int>(BM * sizeof(int));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int r = threadIdx.x; r < BM; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    pos_s[r] = 0.f;
    lab_s[r] = row0 + r < M ? labels[row0 + r] : -1;
  }
  // score_tile opens with __syncthreads(), which orders this initialisation

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * BN;
    score_tile(q, p, q_s, p_s, score_s, M, N, d, row0, n0, vec != 0);
    for (int r = warp; r < BM && row0 + r < M; r += WARPS) {
      float s[2];
      bool in[2];
      float mx = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + lane + 32 * h;
        in[h] = n < N;
        const bool ok = in[h] && (col_valid == nullptr || col_valid[n] != 0);
        s[h] = ok ? score_s[r * SLD + lane + 32 * h] * inv_tau : NEG_INF;
        if (in[h]) mx = fmaxf(mx, s[h]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float e = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (in[h]) e += expf(s[h] - m_new);
      e = warp_sum(e);
      const int c = lab_s[r] - n0;
      if (c >= 0 && c < BN && n0 + c < N && (c & 31) == lane)
        pos_s[r] = s[c >> 5];
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_prev - m_new) + e;
        m_s[r] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const int splits = gridDim.y;
  for (int r = threadIdx.x; r < BM && row0 + r < M; r += THREADS) {
    const int gr = row0 + r;
    if (splits == 1) {
      lse[gr] = m_s[r] + logf(l_s[r]);
      pos[gr] = pos_s[r];
      amax[gr] = m_s[r];
    } else {
      const size_t i = size_t(gr) * splits + blockIdx.y;
      part[i] = m_s[r];
      part[size_t(M) * splits + i] = l_s[r];
      part[2 * size_t(M) * splits + i] = pos_s[r];
    }
  }
}

// One warp per row: the online-softmax combine of the row's splits' (max,
// sum-exp) pairs, part (3, M, splits); pos is the owning split's value (the
// others hold 0). Lane i takes splits i, i + 32, ..., the lanes combine by
// butterflies: a fixed order, and the row's loads in parallel. Waits for
// the grid before it (griddepcontrol.wait: a no-op unless launched as a
// programmatic dependent, as the Hopper forward launches it).
__global__ void __launch_bounds__(THREADS)
infonce_stats_merge_kernel(const float* __restrict__ part, float* __restrict__ lse,
                           float* __restrict__ pos, float* __restrict__ amax,
                           int M, int splits) {
  grid_dependency_wait();
  const int r = blockIdx.x * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= M) return;   // the row's whole warp
  const float* pm = part + size_t(r) * splits;
  const float* pl = pm + size_t(M) * splits;
  const float* pp = pl + size_t(M) * splits;
  float m = NEG_INF;
  for (int s = lane; s < splits; s += 32) m = fmaxf(m, pm[s]);
  m = warp_max(m);
  float l = 0.f, ps = 0.f;
  for (int s = lane; s < splits; s += 32) {
    l += pl[s] * expf(pm[s] - m);
    ps += pp[s];
  }
  l = warp_sum(l);
  ps = warp_sum(ps);
  if (lane == 0) {
    lse[r] = m + logf(l);
    pos[r] = ps;
    amax[r] = m;
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (row tiles, column splits). Pass 1 fills the coefficient strip
// C (64 x the split's columns) in the operand type; pass 2 walks d in chunks:
// dQ[:, chunk] = sum over the split's column tiles of C_tile . P_tile[:, chunk].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
infonce_dq_kernel(const T* __restrict__ q, const T* __restrict__ p,
                  const int* __restrict__ labels,
                  const uint8_t* __restrict__ col_valid,
                  const float* __restrict__ lse, const float* __restrict__ g_lse,
                  const float* __restrict__ g_pos, T* __restrict__ dq,
                  float* __restrict__ partial, int M, int N, int d,
                  int tiles_per_split, float inv_tau, int vec) {
  constexpr int BK = Tile<T>::BK, CLD = cld_q<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm{smem};
  T* q_s = sm.take<T>(size_t(64) * Tile<T>::LD * sizeof(T));
  T* p_s = sm.take<T>(size_t(64) * Tile<T>::LD * sizeof(T));
  float* score_s = sm.take<float>(size_t(BM) * SLD * sizeof(float));
  T* c_s = sm.take<T>(size_t(BM) * CLD * sizeof(T));
  float* lse_s = sm.take<float>(BM * sizeof(float));
  float* gl_s = sm.take<float>(BM * sizeof(float));
  float* gp_s = sm.take<float>(BM * sizeof(float));
  int* lab_s = sm.take<int>(BM * sizeof(int));

  const int row0 = blockIdx.x * BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool in = row0 + r < M;
    lse_s[r] = in ? lse[row0 + r] : 0.f;
    gl_s[r] = in ? g_lse[row0 + r] : 0.f;
    gp_s[r] = in ? g_pos[row0 + r] : 0.f;
    lab_s[r] = in ? labels[row0 + r] : -1;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * BN;
    score_tile(q, p, q_s, p_s, score_s, M, N, d, row0, n0, vec != 0);
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, n = n0 + c;
      const bool ok = row0 + r < M && n < N &&
                      (col_valid == nullptr || col_valid[n] != 0);
      const float v = ok ? coeff(score_s[r * SLD + c], inv_tau, lse_s[r], gl_s[r],
                                 gp_s[r], lab_s[r] == n)
                         : 0.f;
      c_s[r * CLD + (t - t_begin) * BN + c] = to_t<T>(v);
    }
  }

  GradAcc<T> acc;
  for (int k0 = 0; k0 < d; k0 += BK) {
    acc.zero();
    for (int t = t_begin; t < t_end; ++t) {
      __syncthreads();
      load_chunk(p, p_s, N, t * BN, d, k0, vec != 0);
      __syncthreads();
      acc.template mma<false>(c_s, CLD, (t - t_begin) * BN, p_s);
    }
    acc.store(score_s);
    __syncthreads();
    write_grad(score_s, dq, partial, M, row0, d, k0);
  }
}

// ---------------------------------------------------------------------------
// dP: grid (column tiles, row splits). Pass 1 fills C (the split's rows x 64)
// in the operand type; pass 2: dP[:, chunk] = sum over the split's row tiles
// of C_tile^T . Q_tile[:, chunk].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
infonce_dp_kernel(const T* __restrict__ q, const T* __restrict__ p,
                  const int* __restrict__ labels,
                  const uint8_t* __restrict__ col_valid,
                  const float* __restrict__ lse, const float* __restrict__ g_lse,
                  const float* __restrict__ g_pos, T* __restrict__ dp,
                  float* __restrict__ partial, int M, int N, int d,
                  int tiles_per_split, float inv_tau, int vec) {
  constexpr int BK = Tile<T>::BK, CLD = cld_p<T>();
  constexpr int ROWS = SPLIT_TILES * BM;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm{smem};
  T* q_s = sm.take<T>(size_t(64) * Tile<T>::LD * sizeof(T));
  T* p_s = sm.take<T>(size_t(64) * Tile<T>::LD * sizeof(T));
  float* score_s = sm.take<float>(size_t(BM) * SLD * sizeof(float));
  T* c_s = sm.take<T>(size_t(ROWS) * CLD * sizeof(T));
  float* lse_s = sm.take<float>(ROWS * sizeof(float));
  float* gl_s = sm.take<float>(ROWS * sizeof(float));
  float* gp_s = sm.take<float>(ROWS * sizeof(float));
  int* lab_s = sm.take<int>(ROWS * sizeof(int));

  const int n0 = blockIdx.x * BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(m_tiles, t_begin + tiles_per_split);
  const int r_begin = t_begin * BM;

  for (int r = threadIdx.x; r < (t_end - t_begin) * BM; r += THREADS) {
    const int gr = r_begin + r;
    const bool in = gr < M;
    lse_s[r] = in ? lse[gr] : 0.f;
    gl_s[r] = in ? g_lse[gr] : 0.f;
    gp_s[r] = in ? g_pos[gr] : 0.f;
    lab_s[r] = in ? labels[gr] : -1;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = t * BM;
    score_tile(q, p, q_s, p_s, score_s, M, N, d, row0, n0, vec != 0);
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN, n = n0 + c;
      const int rr = (t - t_begin) * BM + r;
      const bool ok = row0 + r < M && n < N &&
                      (col_valid == nullptr || col_valid[n] != 0);
      const float v = ok ? coeff(score_s[r * SLD + c], inv_tau, lse_s[rr], gl_s[rr],
                                 gp_s[rr], lab_s[rr] == n)
                         : 0.f;
      c_s[rr * CLD + c] = to_t<T>(v);
    }
  }

  GradAcc<T> acc;
  for (int k0 = 0; k0 < d; k0 += BK) {
    acc.zero();
    for (int t = t_begin; t < t_end; ++t) {
      __syncthreads();
      load_chunk(q, q_s, M, t * BM, d, k0, vec != 0);
      __syncthreads();
      acc.template mma<true>(c_s, CLD, (t - t_begin) * BM, q_s);
    }
    acc.store(score_s);
    __syncthreads();
    write_grad(score_s, dp, partial, N, n0, d, k0);
  }
}

// out[x] = T(sum over splits of partial[s][x]), in split order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
infonce_grad_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                           size_t total, int splits) {
  for (size_t x = size_t(blockIdx.x) * THREADS + threadIdx.x; x < total;
       x += size_t(gridDim.x) * THREADS) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[size_t(s) * total + x];
    out[x] = to_t<T>(v);
  }
}

// infonce_stats_merge_kernel over part (3, M, tiles) as a programmatic
// dependent of the tile kernel just launched on `st`: launched while the
// tiles run, it waits in griddepcontrol.wait for their partials.
cudaError_t launch_stats_merge(const float* part, float* lse, float* pos, float* amax, int M,
                               int tiles, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned((M + WARPS - 1) / WARPS));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, infonce_stats_merge_kernel, part, lse, pos, amax, M, tiles);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

int reduce_blocks(size_t total) {
  const size_t b = (total + THREADS - 1) / THREADS;
  return int(b < 4096 ? b : 4096);
}

template <typename T>
cudaError_t fwd(const void* q, const void* p, const void* labels,
                const void* col_valid, void* lse, void* pos, void* amax,
                void* part, int M, int N, int d, int splits, int tiles_per_split,
                float inv_tau, int vec, cudaStream_t st) {
  const size_t smem = fwd_smem<T>();
  cudaError_t err = allow_smem(infonce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, splits);
  infonce_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(p),
      static_cast<const int*>(labels), static_cast<const uint8_t*>(col_valid),
      static_cast<float*>(lse), static_cast<float*>(pos),
      static_cast<float*>(amax), static_cast<float*>(part), M, N, d,
      tiles_per_split, inv_tau, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  infonce_stats_merge_kernel<<<(M + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(lse),
      static_cast<float*>(pos), static_cast<float*>(amax), M, splits);
  return cudaGetLastError();
}

template <typename T, bool DP>
cudaError_t grad(const void* q, const void* p, const void* labels,
                 const void* col_valid, const void* lse, const void* g_lse,
                 const void* g_pos, void* out, void* partial, int M, int N,
                 int d, int splits, int tiles_per_split, float inv_tau, int vec,
                 cudaStream_t st) {
  auto kernel = DP ? infonce_dp_kernel<T> : infonce_dq_kernel<T>;
  const size_t smem = DP ? dp_smem<T>() : dq_smem<T>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = DP ? (N + BN - 1) / BN : (M + BM - 1) / BM;
  kernel<<<dim3(tiles, splits), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(p),
      static_cast<const int*>(labels), static_cast<const uint8_t*>(col_valid),
      static_cast<const float*>(lse), static_cast<const float*>(g_lse),
      static_cast<const float*>(g_pos), static_cast<T*>(out),
      static_cast<float*>(partial), M, N, d, tiles_per_split, inv_tau, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = size_t(DP ? N : M) * d;
  infonce_grad_reduce_kernel<T><<<reduce_blocks(total), THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), total, splits);
  return cudaGetLastError();
}

// ============================================================================
// bf16 dQ and dP on Hopper: TMA, wgmma, coefficients from registers
// ============================================================================
namespace hp {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int PB = 64;            // passages a block: wgmma's 64-row side
constexpr int BOX = 64 * 128;     // a 64 x 64 bf16 box, 128-byte swizzled (8 KB)
constexpr int NC_MAX = 16;        // d-chunks of 64 a small block: d up to 1024

// ---- dP at many query rows: a cluster of `ranks` blocks on one tile of
// 64 passages, rank r holding the coefficients of query rows r * rq ..
constexpr int TQ = 256;           // pass-1 query tile: two consumer warpgroups x 128
constexpr int RQ_MAX = 768;       // most query rows a rank holds coefficients for
constexpr int RANKS_MAX = 8;      // the portable cluster size
constexpr int KT = 64;            // pass-2 k-tile (query rows)
constexpr int NCH = 4;            // most d-chunks one pass-2 group takes: 2 a warpgroup
constexpr int S1 = 3, S2 = 3;     // ring stages of pass 1 and pass 2
constexpr int STAGE1 = BOX + TQ * 128;   // a P chunk, then the Q tile's chunk (40 KB)
constexpr int STAGE2 = NCH * BOX;        // a Q k-tile: NCH chunks (32 KB)
constexpr int U1 = S1 * STAGE1, U2 = S2 * STAGE2;
constexpr int OFF_STRIP = U1 > U2 ? U1 : U2;            // pass 2 reuses pass 1's ring
constexpr int STRIP = RQ_MAX / 16 * 128 * 16;           // A fragments, 16 bytes a thread a k-step
constexpr int QV = 128 * 16;                            // a warpgroup's 128 queries: L, G, H, label
constexpr int OFF_QV = OFF_STRIP + STRIP;
constexpr int OFF_BAR = OFF_QV + 2 * QV;
constexpr int N_BARS = 2 * S1 + 2 * S2;
constexpr int SMEM_CLUSTER = OFF_BAR + 8 * N_BARS + 1024;   // + slack to align the base
constexpr int CLUSTER_THREADS = 2 * 128 + 32;           // two consumer warpgroups, a producer warp
static_assert(STAGE1 % 1024 == 0 && STAGE2 % 1024 == 0 && OFF_STRIP % 1024 == 0,
              "1 KB aligned tiles");
static_assert(SMEM_CLUSTER <= 232448, "shared memory over the 227 KB a block may use");

// ---- dQ and dP at up to SQ query rows: one block per 64 passages
constexpr int SQ = 16;            // query rows, wgmma's N (rows past M are TMA's zeros)
constexpr int QBOX = SQ * 128;    // a 16 x 64 bf16 box (2 KB)
__host__ __device__ constexpr int small_off_c(int nc) { return nc * (BOX + QBOX); }
__host__ __device__ constexpr int small_off_qv(int nc) { return small_off_c(nc) + SQ * 128; }
__host__ __device__ constexpr int small_off_bar(int nc) { return small_off_qv(nc) + 4 * SQ * 4; }
__host__ __device__ constexpr int small_smem(int nc) { return small_off_bar(nc) + 8 * nc + 1024; }
static_assert(small_smem(NC_MAX) <= 232448, "shared memory over the 227 KB a block may use");
// The split kernels (up to SQ query rows past NC_MAX d-chunks): a rank of
// the cluster holds the small kernels' layout for its nc <= NC_MAX chunks,
// then each thread's 8 partial scores (4 KB a block) for the other ranks to
// read
__host__ __device__ constexpr int split_off_x(int nc) { return (small_off_bar(nc) + 8 * nc + 15) / 16 * 16; }
__host__ __device__ constexpr int split_smem(int nc) { return split_off_x(nc) + 128 * 32 + 1024; }
static_assert(split_smem(NC_MAX) <= 232448, "shared memory over the 227 KB a block may use");

// ---- the forward: per query row and passage tile a partial (max, sum-exp,
// pos) in part (3, M, tiles); infonce_stats_merge_kernel merges each row's
// partials in a fixed order
constexpr int SF = 5;                     // ring stages of the forward at many rows
constexpr int FSTATS = 7 * 128 * 4;       // a warpgroup's statistics scratch (tile_partials)
constexpr int OFF_FSTATS = SF * STAGE1;
constexpr int OFF_FBAR = OFF_FSTATS + 2 * FSTATS;
constexpr int SMEM_FWD = OFF_FBAR + 8 * 2 * SF + 1024;   // + slack to align the base
static_assert(SMEM_FWD <= 232448, "shared memory over the 227 KB a block may use");
static_assert(7 * SQ * 4 <= SQ * 128, "the small forward's scratch fits the coefficient area");

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// The coefficient of one raw score (see the file's header): 2^(raw k1 - L)
// G + [label] H with k1 = inv_tau log2(e), L = lse log2(e), G = g_lse
// inv_tau, H = g_pos inv_tau; 0 where the passage is not valid (a select,
// so the exponential of a masked column's score never enters).
__device__ __forceinline__ float coef(float raw, float k1, float L, float G, float H, bool is_label,
                                      bool valid) {
  const float c = fmaf(ex2(fmaf(raw, k1, -L)), G, is_label ? H : 0.f);
  return valid ? c : 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool passage_valid(const uint8_t* col_valid, int n, int N) {
  return n < N && (col_valid == nullptr || col_valid[n] != 0);
}

// Per query row m0 + i, i < count: L, G, H and the label at qv[i],
// qv[count + i], qv[2 count + i], qv[3 count + i]; zeros and -1 past M.
// Thread `t` of `threads` loads rows t, t + threads, ...
__device__ __forceinline__ void load_query_values(float* qv, int count, int m0, int M,
                                                  const int* labels, const float* lse,
                                                  const float* g_lse, const float* g_pos,
                                                  float inv_tau, int t, int threads) {
  const int stride = count;
  int* lab = reinterpret_cast<int*>(qv + 3 * stride);
  for (int i = t; i < count; i += threads) {
    const int m = m0 + i;
    const bool in = m < M;
    qv[i] = in ? lse[m] * LOG2E : 0.f;
    qv[stride + i] = in ? g_lse[m] * inv_tau : 0.f;
    qv[2 * stride + i] = in ? g_pos[m] * inv_tau : 0.f;
    lab[i] = in ? labels[m] : -1;
  }
}

// dP rows n0.. (up to 64, below N), columns [c0, c1) of d, set to 0: the
// coefficient of a wholly masked passage tile is 0 everywhere.
__device__ __forceinline__ void zero_rows(__nv_bfloat16* out, int n0, int N, int d, int c0, int c1,
                                          int threads) {
  const int groups = (c1 - c0) / 8;   // d is a multiple of 8
  for (int x = threadIdx.x; x < PB * groups; x += threads) {
    const int r = x / groups, c = c0 + (x % groups) * 8;
    if (n0 + r < N)
      *reinterpret_cast<uint4*>(out + size_t(n0 + r) * d + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---- the pass-1 ring (dP at many rows, and the forward at many rows):
// stage s at base + s STAGE1 holds P chunk c of passages n0.. (64 x 64)
// and then chunk c of a tile of TQ query rows (4 boxes of 64 rows); full
// barrier s at full0 + 8 s (one arrival and the bytes), empty barrier s at
// empty0 + 8 s (one arrival a consumer warp of both warpgroups).

// Producer (one thread): every d-chunk of query tiles 0 .. t1 - 1 (rows
// q_begin + TQ t ..; rows past the tensor are TMA's zeros). Returns the
// stages issued.
template <int S>
__device__ __forceinline__ int ring_load(const CUtensorMap* tq, const CUtensorMap* tp,
                                         uint32_t base, uint32_t full0, uint32_t empty0, int n0,
                                         int q_begin, int t1, int nc) {
  int it = 0;
  for (int t = 0; t < t1; ++t)
    for (int c = 0; c < nc; ++c, ++it) {
      const int s = it % S;
      mbar_wait(empty0 + 8u * s, ((it / S) & 1) ^ 1);   // the first round passes at once
      mbar_expect_tx(full0 + 8u * s, STAGE1);
      const uint32_t st = base + s * STAGE1;
      tma_load_2d(tp, st, full0 + 8u * s, 64 * c, n0);
#pragma unroll
      for (int h = 0; h < TQ / 64; ++h)
        tma_load_2d(tq, st + BOX + h * BOX, full0 + 8u * s, 64 * c, q_begin + TQ * t + 64 * h);
    }
  return it;
}

// Consumer warpgroup wg: S^T = P Q^T over the nc stages from `it` on for
// its 128 of the tile's queries (wgmma m64n128, the 64 passages as its
// rows), each stage released (by lane 0 of each warp) once its product has
// landed. Register 4i + e of acc: passage 16 v + g + 8 (e / 2), query 128
// wg + 8 i + 2 t4 + e % 2 of the tile (v the warp in the warpgroup, g =
// lane / 4, t4 = lane % 4). Returns the next stage's count.
template <int S>
__device__ __forceinline__ int ring_scores(float (&acc)[64], uint32_t base, uint32_t full0,
                                           uint32_t empty0, int wg, int lane, int nc, int it) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < nc; ++c, ++it) {
    const int s = it % S;
    const uint32_t st = base + s * STAGE1;
    mbar_wait(full0 + 8u * s, (it / S) & 1);
    fence_regs<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(acc, desc_sw128(st + kk * 32, 16, 1024),
                    desc_sw128(st + BOX + wg * 128 * 128 + kk * 32, 16, 1024), (c | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8u * s);
  }
  return it;
}

// ---------------------------------------------------------------------------
// dP, many query rows. Grid: (passage tiles x ranks) blocks, clusters of
// `ranks` along x. Pass 1: rank r streams its query rows [r rq, (r+1) rq) in
// tiles of 256 with the tile's P chunks through a ring (S1 stages: a 64 x 64
// P chunk and a 256 x 64 Q chunk); each consumer warpgroup computes S^T =
// P Q^T for 128 of the tile's queries (wgmma m64n128, 64 passages as its
// rows), turns the accumulator into coefficients in registers, rounds them
// to bf16 as the register A operand of the next product and stores them in
// its rank's strip in that order. Cluster barrier. Pass 2: rank r takes
// d-chunks [r nc / ranks, (r+1) nc / ranks), up to NCH at a time, two to a
// warpgroup; the ring (reusing pass 1's bytes) streams every 64-row Q k-tile
// of those chunks, each warpgroup reads the k-tile's A fragments from the
// strip of the rank that holds them (distributed shared memory) and
// accumulates dP tile += C^T Q over every query row in order (wgmma m64n128
// or m64n64, Q the MN-major B), then writes its columns in bf16. No fp32
// partial leaves the registers and no second launch follows.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
infonce_dp_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                          const uint8_t* __restrict__ col_valid, const float* __restrict__ lse,
                          const float* __restrict__ g_lse, const float* __restrict__ g_pos,
                          __nv_bfloat16* __restrict__ dp, int M, int N, int d, int rq, float k1,
                          float inv_tau) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int ranks = int(cluster_nctarank());
  const int rank = int(cluster_ctarank());
  const int n0 = (blockIdx.x / ranks) * PB;
  const int nc = (d + 63) / 64;
  const int q_begin = rank * rq, q_end = min(M, q_begin + rq);
  const int t1 = (q_end - q_begin + TQ - 1) / TQ;   // pass-1 tiles
  const int kt = (M + KT - 1) / KT;                 // pass-2 k-tiles: every query row
  const int c_lo = rank * nc / ranks, c_hi = (rank + 1) * nc / ranks;
  const int groups = (c_hi - c_lo + NCH - 1) / NCH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // a wholly masked passage tile: its dP rows are 0 (every rank of the
  // cluster sees the same tile and leaves here, before any cluster barrier)
  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {
    zero_rows(dp, n0, N, d, 64 * c_lo, min(d, 64 * c_hi), CLUSTER_THREADS);
    return;
  }

  const uint32_t bar = base + OFF_BAR;
  auto full1 = [&](int s) { return bar + 8u * s; };
  auto empty1 = [&](int s) { return bar + 8u * (S1 + s); };
  auto full2 = [&](int s) { return bar + 8u * (2 * S1 + s); };
  auto empty2 = [&](int s) { return bar + 8u * (2 * S1 + S2 + s); };
  if (tid == 0) {
    for (int s = 0; s < S1; ++s) {
      mbar_init(full1(s), 1);
      mbar_init(empty1(s), 8);   // one arrival a consumer warp: both warpgroups read a stage
    }
    for (int s = 0; s < S2; ++s) {
      mbar_init(full2(s), 1);
      mbar_init(empty2(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer warp: lane 0 issues every load
    cluster_arrive_relaxed();   // phase 1 (strips written): the producer writes none
    if (lane == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tp);
      const int it = ring_load<S1>(&tq, &tp, base, full1(0), empty1(0), n0, q_begin, t1, nc);
      // pass 2 writes over the ring: every pass-1 stage released first
      for (int s = 0; s < S1 && s < it; ++s)
        mbar_wait(empty1(s), ((it - s + S1 - 1) / S1 - 1) & 1);
      int it2 = 0;
      for (int gi = 0; gi < groups; ++gi) {
        const int c0 = c_lo + gi * NCH, cnt = min(NCH, c_hi - c0);
        for (int j = 0; j < kt; ++j, ++it2) {
          const int s = it2 % S2;
          mbar_wait(empty2(s), ((it2 / S2) & 1) ^ 1);
          mbar_expect_tx(full2(s), cnt * BOX);
          for (int c = 0; c < cnt; ++c)
            tma_load_2d(&tq, base + s * STAGE2 + c * BOX, full2(s), 64 * (c0 + c), KT * j);
        }
      }
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive_relaxed();   // phase 2 (strips no longer read)
    cluster_wait();
    return;
  }

  // ---- consumer warpgroup wg; warp v holds passages 16 v + g and + 8
  const int wg = warp / 4, v = warp % 4, g = lane / 4, t4 = lane % 4;
  const int pa = n0 + 16 * v + g, pb = pa + 8;
  const bool va = passage_valid(col_valid, pa, N), vb = passage_valid(col_valid, pb, N);
  const uint32_t strip = base + OFF_STRIP;
  auto release = [&](uint32_t b) {
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
  };
  auto wg_sync = [&]() {
    if (wg == 0)   // barrier 0 is __syncthreads; one id a consumer warpgroup
      named_bar_sync<1, 128>();
    else
      named_bar_sync<2, 128>();
  };

  float acc[64];
  {
    float* qv = reinterpret_cast<float*>(smem + OFF_QV + wg * QV);
    const int* qlab = reinterpret_cast<const int*>(qv + 3 * 128);
    int it = 0;
    for (int t = 0; t < t1; ++t) {
      const int ql0 = t * TQ + wg * 128;   // local query row of accumulator column 0
      wg_sync();                           // the last tile's values are read
      load_query_values(qv, 128, q_begin + ql0, min(M, q_end), labels, lse, g_lse, g_pos,
                        inv_tau, tid % 128, 128);
      it = ring_scores<S1>(acc, base, full1(0), empty1(0), wg, lane, nc, it);
      wg_sync();   // this tile's values are written
      // register 4i + e: passage pa (e < 2) or pb, query ql0 + 8i + 2 t4 + e % 2
      uint32_t pk[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int x = 8 * i + 2 * t4;
        const float2 L = *reinterpret_cast<const float2*>(qv + x);
        const float2 G = *reinterpret_cast<const float2*>(qv + 128 + x);
        const float2 H = *reinterpret_cast<const float2*>(qv + 256 + x);
        const int2 lab = *reinterpret_cast<const int2*>(qlab + x);
        pk[2 * i] = pack_bf16(coef(acc[4 * i], k1, L.x, G.x, H.x, lab.x == pa, va),
                              coef(acc[4 * i + 1], k1, L.y, G.y, H.y, lab.y == pa, va));
        pk[2 * i + 1] = pack_bf16(coef(acc[4 * i + 2], k1, L.x, G.x, H.x, lab.x == pb, vb),
                                  coef(acc[4 * i + 3], k1, L.y, G.y, H.y, lab.y == pb, vb));
      }
      // k-step kk of this warpgroup's 128 queries: pk[4 kk .. 4 kk + 3]
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int ks = ql0 / 16 + kk;
        *reinterpret_cast<uint4*>(smem + OFF_STRIP + ((ks * 4 + v) * 32 + lane) * 16) =
            make_uint4(pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]);
      }
    }
  }
  cluster_arrive();   // phase 1: this rank's strip is written
  cluster_wait();     // and every rank's

  int it2 = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int c0 = c_lo + gi * NCH, cnt = min(NCH, c_hi - c0);
    const int mine = max(0, min(2, cnt - 2 * wg));   // this warpgroup's chunks: c0 + 2 wg ..
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // k-tile j's A fragments, from the rank that holds its coefficients;
    // the next k-tile's are in flight while this one multiplies
    auto load_frags = [&](uint32_t* dst, int j) {
      const int owner = KT * j / rq;
      const int ks0 = (KT * j - owner * rq) / 16;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 f = ld_cluster_v4(strip + (((ks0 + kk) * 4 + v) * 32 + lane) * 16, owner);
        dst[4 * kk] = f.x;
        dst[4 * kk + 1] = f.y;
        dst[4 * kk + 2] = f.z;
        dst[4 * kk + 3] = f.w;
      }
    };
    uint32_t a[16], next[16];
    if (mine > 0) load_frags(a, 0);
    for (int j = 0; j < kt; ++j, ++it2) {
      const int s = it2 % S2;
      const uint32_t b = base + s * STAGE2 + 2 * wg * BOX;   // this warpgroup's chunks
      if (mine > 0 && j + 1 < kt) load_frags(next, j + 1);
      mbar_wait(full2(s), (it2 / S2) & 1);
      if (mine > 0) {
        fence_regs<64>(acc);
        fence_regs<16>(a);
        wgmma_fence();
        // Always both chunks (with one, the second half reads a stale slot
        // of the stage and is not stored): no branch may merge between a
        // wgmma and its wait, or the compiler may copy the accumulator
        // before the product lands in it.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n128(acc, &a[4 * kk], desc_sw128(b + kk * 2048, BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<64>(acc);
        fence_regs<16>(a);
      }
      release(empty2(s));
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = next[i];
    }
    if (gi == groups - 1) cluster_arrive();   // phase 2: no more reads of the strips

    // register 4i + e: passage 16 v + g + 8 (e / 2), column 64 (c0 + 2 wg)
    // + 8 i + 2 t4 + e % 2
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i >= 8 * mine) continue;
      const int col = 64 * (c0 + 2 * wg) + 8 * i + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = pa + 8 * h;
        if (n < N && col < d)
          *reinterpret_cast<uint32_t*>(dp + size_t(n) * d + col) =
              pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
  if (groups == 0) cluster_arrive();
  cluster_wait();   // no rank leaves while another may read its strip
}

// The small kernels' scores: thread 0 puts the P tile of passages n0..
// (64) and the query rows 0..15 in flight by TMA, every d-chunk on its own
// barrier, and the warpgroup accumulates S^T = P Q^T (wgmma m64n16, the
// queries as N; rows past M are TMA's zeros) as each chunk lands. Register
// 4i + e of acc: passage 16 v + g + 8 (e / 2), query 8 i + 2 t4 + e % 2.
// Opens with a block barrier, which also orders the caller's earlier
// shared-memory writes.
// c_lo: the first d-chunk (chunk c of shared memory is chunk c_lo + c of d).
__device__ __forceinline__ void small_scores(const CUtensorMap* tq, const CUtensorMap* tp,
                                             uint32_t base, int nc, int n0, float (&acc)[8],
                                             int c_lo = 0) {
  const uint32_t bar = base + small_off_bar(nc);
  const uint32_t p_s = base, q_s = base + nc * BOX;
  if (threadIdx.x == 0) {
    for (int c = 0; c < nc; ++c) mbar_init(bar + 8u * c, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    prefetch_tensormap(tq);
    prefetch_tensormap(tp);
    for (int c = 0; c < nc; ++c) {
      mbar_expect_tx(bar + 8u * c, BOX + QBOX);
      tma_load_2d(tp, p_s + c * BOX, bar + 8u * c, 64 * (c_lo + c), n0);
      tma_load_2d(tq, q_s + c * QBOX, bar + 8u * c, 64 * (c_lo + c), 0);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int c = 0; c < nc; ++c) {
    mbar_wait(bar + 8u * c, 0);
    fence_regs<8>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n16<0>(acc, desc_sw128(p_s + c * BOX + kk * 32, 16, 1024),
                      desc_sw128(q_s + c * QBOX + kk * 32, 16, 1024), (c | kk) != 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<8>(acc);
}

// The dP tile of passages n0.. over d-chunks [c_lo, c_lo + nc) (chunk c of
// shared memory: P at c BOX, Q at nc BOX + c QBOX) from this thread's 8
// coefficients (passages pl and pl + 8, queries 8 i + 2 t4 + e % 2): the
// coefficients are the register A operand of one k-step a d-chunk (dP tile
// = C^T Q, Q the MN-major B), staged in bf16 where the P tile was and
// written in 16-byte stores. Opens with a block barrier: every warp's score
// products have read the P tile.
__device__ __forceinline__ void small_dp_tile(uint8_t* smem, uint32_t base, const float (&cf)[8],
                                              int nc, int c_lo, int n0, int N, int d, int pl,
                                              int t4, __nv_bfloat16* dp) {
  const uint32_t q_s = base + nc * BOX;
  // the coefficients as the A operand of one k-step (16 queries)
  uint32_t a[4] = {pack_bf16(cf[0], cf[1]), pack_bf16(cf[2], cf[3]), pack_bf16(cf[4], cf[5]),
                   pack_bf16(cf[6], cf[7])};
  __syncthreads();   // every warp's score products have read the P tile: it stages dP now
  for (int c0 = 0; c0 < nc; c0 += 2) {
    float o[2][32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
    fence_regs<32>(o[0]);
    fence_regs<32>(o[1]);
    fence_regs<4>(a);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)   // past the last chunk: the last again, not stored
      wgmma_rs_n64(o[h], a, desc_sw128(q_s + min(c0 + h, nc - 1) * QBOX, QBOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(o[0]);
    fence_regs<32>(o[1]);
    fence_regs<4>(a);
    // chunk c of the tile into P chunk c's bytes, in the same 128-byte
    // swizzle (16-byte group i of row r at i ^ (r % 8): no bank conflicts)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (c0 + h >= nc) continue;
      uint8_t* tile = smem + (c0 + h) * BOX;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = pl + 8 * e;
          *reinterpret_cast<uint32_t*>(tile + r * 128 + ((i ^ (r & 7)) << 4) + t4 * 4) =
              pack_bf16(o[h][4 * i + 2 * e], o[h][4 * i + 2 * e + 1]);
        }
    }
  }
  __syncthreads();
  // the tile's rows in 16-byte stores, consecutive threads on consecutive bytes
  const int col0 = 64 * c_lo, groups = (min(d, 64 * (c_lo + nc)) - col0) / 8;
  for (int x = threadIdx.x; x < PB * groups; x += 128) {
    const int r = x / groups, k = x % groups;
    if (n0 + r < N)
      *reinterpret_cast<uint4*>(dp + size_t(n0 + r) * d + col0 + 8 * k) =
          *reinterpret_cast<const uint4*>(smem + (k / 8) * BOX + r * 128 +
                                          (((k % 8) ^ (r & 7)) << 4));
  }
}

// This thread's 8 coefficients (passages n0 + pl and + 8, queries 8 i + 2 t4
// + e % 2, in acc's layout) from its scores, the query values at qv
// (load_query_values of SQ rows).
__device__ __forceinline__ void small_coefs(const float (&acc)[8], const float* qv, float k1,
                                            const uint8_t* col_valid, int n0, int N, int pl, int t4,
                                            float (&cf)[8]) {
  const int* qlab = reinterpret_cast<const int*>(qv + 3 * SQ);
  const bool va = passage_valid(col_valid, n0 + pl, N);
  const bool vb = passage_valid(col_valid, n0 + pl + 8, N);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 8 * i + 2 * t4 + (e & 1), p = n0 + pl + 8 * (e >> 1);
      cf[4 * i + e] = coef(acc[4 * i + e], k1, qv[q], qv[SQ + q], qv[2 * SQ + q], qlab[q] == p,
                           (e >> 1) ? vb : va);
    }
}

// dQ's fp32 partial (M, d) of a wholly masked passage tile, columns [c0, c1),
// set to 0 (what the coefficient gives there).
__device__ __forceinline__ void zero_partial(float* part, int M, int d, int c0, int c1) {
  const int w = c1 - c0;
  for (int x = threadIdx.x; x < M * w; x += blockDim.x) part[size_t(x / w) * d + c0 + x % w] = 0.f;
}

// dQ^T of the passage tile over d-chunks [c_lo, c_lo + nc) (P chunk c of
// shared memory at c BOX) from this thread's 8 coefficients: C^T goes to
// shared memory as a K-major B (row q: 64 passages, 128-byte swizzled, in
// the coefficient area) and dQ^T (64 d x 16) = P^T C^T (P the MN-major A),
// four d-chunks a round, written as columns of the tile's fp32 partial
// part (M, d).
__device__ __forceinline__ void small_dq_tile(uint8_t* smem, uint32_t base, const float (&cf)[8],
                                              int nc, int c_lo, int M, int d, int pl, int t4,
                                              float* part) {
  uint8_t* cs = smem + small_off_c(nc);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 8 * i + 2 * t4 + (e & 1), p = pl + 8 * (e >> 1);
      const int at = q * 128 + (((p >> 3) ^ (q & 7)) << 4) + (p & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(cs + at) = __float2bfloat16(cf[4 * i + e]);
    }
  fence_proxy_async();
  __syncthreads();
  const uint32_t p_s = base, c_s = base + small_off_c(nc);
  // dQ^T chunk: register 4i + e is d-row 64 c + 16 v + g + 8 (e / 2), query 8 i + 2 t4 + e % 2
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float o[4][8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
#pragma unroll
      for (int i = 0; i < 8; ++i) o[h][i] = 0.f;
      fence_regs<8>(o[h]);
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 4; ++h)   // past the last chunk: the last again, not stored
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n16<1>(o[h], desc_sw128(p_s + min(c0 + h, nc - 1) * BOX + kk * 2048, BOX, 1024),
                        desc_sw128(c_s + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      fence_regs<8>(o[h]);
      if (c0 + h >= nc) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * (c_lo + c0 + h) + pl + 8 * (e >> 1), q = 8 * i + 2 * t4 + (e & 1);
          if (q < M && col < d) part[size_t(q) * d + col] = o[h][4 * i + e];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ and dP at up to SQ query rows: one block (one warpgroup) per 64
// passages. Thread 0 loads the whole P tile and the queries by TMA, every
// d-chunk on its own barrier, so the score product starts on the first
// chunk while the rest land. S^T = P Q^T (wgmma m64n16, the queries as N;
// rows past M are TMA's zeros), coefficients in registers, then
//   dP: the coefficients are the register A operand of one k-step a
//       d-chunk: dP tile = C^T Q (Q the MN-major B), staged in bf16 where
//       the P tile was and written out in 16-byte stores (small_dp_tile);
//   dQ: C^T goes to shared memory as a K-major B and dQ^T (64 d x 16) =
//       P^T C^T (P the MN-major A), written as this block's fp32 partial
//       (small_dq_tile); the reduce kernel sums the partials in block order.
// ---------------------------------------------------------------------------
template <bool DQ>
__global__ void __launch_bounds__(128, 1)
infonce_small_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                     const uint8_t* __restrict__ col_valid, const float* __restrict__ lse,
                     const float* __restrict__ g_lse, const float* __restrict__ g_pos,
                     void* __restrict__ out, int M, int N, int d, float k1, float inv_tau) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int n0 = blockIdx.x * PB;
  const int nc = (d + 63) / 64;
  const int tid = threadIdx.x, v = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  float* part = DQ ? static_cast<float*>(out) + size_t(blockIdx.x) * M * d : nullptr;
  __nv_bfloat16* dp = DQ ? nullptr : static_cast<__nv_bfloat16*>(out);

  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {   // a wholly masked tile: its products are 0
    if (DQ) {
      zero_partial(part, M, d, 0, d);
    } else {
      zero_rows(dp, n0, N, d, 0, d, 128);
    }
    return;
  }

  float* qv = reinterpret_cast<float*>(smem + small_off_qv(nc));
  load_query_values(qv, SQ, 0, M, labels, lse, g_lse, g_pos, inv_tau, tid, 128);
  // S^T: register 4i + e is passage 16 v + g + 8 (e / 2), query 8 i + 2 t4 + e % 2
  float acc[8];
  small_scores(&tq, &tp, base, nc, n0, acc);

  const int pl = 16 * v + g;   // this thread's passages: n0 + pl and + 8
  float cf[8];
  small_coefs(acc, qv, k1, col_valid, n0, N, pl, t4, cf);
  if constexpr (DQ)
    small_dq_tile(smem, base, cf, nc, 0, M, d, pl, t4, part);
  else
    small_dp_tile(smem, base, cf, nc, 0, n0, N, d, pl, t4, dp);
}

// ---------------------------------------------------------------------------
// The split kernels: dP, dQ and the forward at up to SQ query rows on rows
// of more than NC_MAX d-chunks, where the small kernels' P tile (10 KB a
// d-chunk with the queries) no longer fits a block. A cluster of `ranks`
// blocks on one tile of 64 passages, rank r taking d-chunks [r nc / ranks,
// (r + 1) nc / ranks) (at most NC_MAX: 2 ranks of 16 at d = 2048, 3 of
// 13-14 at 2560). Each rank loads its share of the P tile and of the
// queries by TMA exactly as the small kernels do all of them, and
// accumulates its partial S^T (wgmma m64n16) over its share. The partials
// (64 x 16 fp32, 4 KB a rank) are summed through distributed shared memory
// in rank order, so every rank holds the same scores (split_scores). Then
//   dP: every rank forms the same bf16 coefficients in registers and writes
//       its own columns of dP as the small kernel writes all of them (C^T
//       Q, the tile staged in bf16 where its P chunks were);
//   dQ: every rank forms the same coefficients and writes its own columns
//       of the tile's fp32 partial (P_r^T C^T from the chunks it holds);
//       the reduce kernel sums the partials in block order, as after the
//       small kernel;
//   the forward: rank 0 writes the tile's (max, sum-exp, pos) partial of
//       each row from the summed scores (tile_partials); the others write
//       nothing.
// P is read once; what bounds each is those bytes (8.4 MB at d = 2048, N =
// 2064: 2.5 us; dP also writes as many), with twice the small kernels'
// blocks (66) to carry them.
// ---------------------------------------------------------------------------
struct SplitShare {
  int ranks, rank, tile;   // the cluster's size, this block's rank and passage tile
  int c_lo, nc;            // this rank's d-chunks [c_lo, c_lo + nc)
  int nc_max;              // the largest share of any rank (the shared-memory plan's)
};

__device__ __forceinline__ SplitShare split_share(int d) {
  SplitShare s;
  s.ranks = int(cluster_nctarank());
  s.rank = int(cluster_ctarank());
  s.tile = blockIdx.x / s.ranks;
  const int nc_all = (d + 63) / 64;
  s.c_lo = s.rank * nc_all / s.ranks;
  s.nc = (s.rank + 1) * nc_all / s.ranks - s.c_lo;
  s.nc_max = (nc_all + s.ranks - 1) / s.ranks;
  return s;
}

// The scores of the split kernels into acc (the small kernels' register
// layout: 4i + e is passage 16 v + g + 8 (e / 2), query 8 i + 2 t4 + e % 2),
// the same on every rank. Leaves with this rank's phase-2 cluster arrival
// made (it reads no more partials): the caller ends with cluster_wait(), so
// that no rank leaves while another may read its partial.
__device__ __forceinline__ void split_scores(const CUtensorMap* tq, const CUtensorMap* tp,
                                             uint8_t* smem, uint32_t base, const SplitShare& s,
                                             int n0, float (&acc)[8]) {
  float part[8];
  small_scores(tq, tp, base, s.nc, n0, part, s.c_lo);
  // at one offset in every rank (the ranks' shares differ by a chunk at most)
  const int x_off = split_off_x(s.nc_max) + threadIdx.x * 32;
  const uint32_t x_s = base + x_off;
  *reinterpret_cast<float4*>(smem + x_off) = make_float4(part[0], part[1], part[2], part[3]);
  *reinterpret_cast<float4*>(smem + x_off + 16) = make_float4(part[4], part[5], part[6], part[7]);
  cluster_arrive();   // phase 1: this rank's partial is written
  cluster_wait();     // and every rank's
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int r = 0; r < s.ranks; ++r) {   // rank order: every rank sums the same way
    const uint4 lo = ld_cluster_v4(x_s, r), hi = ld_cluster_v4(x_s + 16, r);
    acc[0] += __uint_as_float(lo.x);
    acc[1] += __uint_as_float(lo.y);
    acc[2] += __uint_as_float(lo.z);
    acc[3] += __uint_as_float(lo.w);
    acc[4] += __uint_as_float(hi.x);
    acc[5] += __uint_as_float(hi.y);
    acc[6] += __uint_as_float(hi.z);
    acc[7] += __uint_as_float(hi.w);
  }
  cluster_arrive_relaxed();   // phase 2: this rank reads no more partials
}

// dP (split): each rank its columns of the tile's dP rows.
__global__ void __launch_bounds__(128, 1)
infonce_dp_split_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                        const uint8_t* __restrict__ col_valid, const float* __restrict__ lse,
                        const float* __restrict__ g_lse, const float* __restrict__ g_pos,
                        __nv_bfloat16* __restrict__ dp, int M, int N, int d, float k1,
                        float inv_tau) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const SplitShare s = split_share(d);
  const int n0 = s.tile * PB;
  const int tid = threadIdx.x, v = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;

  // a wholly masked passage tile: its dP rows are 0 (every rank of the
  // cluster sees the same tile and leaves here, before any cluster barrier)
  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {
    zero_rows(dp, n0, N, d, 64 * s.c_lo, min(d, 64 * (s.c_lo + s.nc)), 128);
    return;
  }

  float* qv = reinterpret_cast<float*>(smem + small_off_qv(s.nc));
  load_query_values(qv, SQ, 0, M, labels, lse, g_lse, g_pos, inv_tau, tid, 128);
  float acc[8];
  split_scores(&tq, &tp, smem, base, s, n0, acc);
  const int pl = 16 * v + g;   // this thread's passages: n0 + pl and + 8
  float cf[8];
  small_coefs(acc, qv, k1, col_valid, n0, N, pl, t4, cf);
  small_dp_tile(smem, base, cf, s.nc, s.c_lo, n0, N, d, pl, t4, dp);
  cluster_wait();   // no rank leaves while another may read its partial
}

// dQ (split): each rank its columns of the tile's fp32 partial (tiles, M, d).
__global__ void __launch_bounds__(128, 1)
infonce_dq_split_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                        const uint8_t* __restrict__ col_valid, const float* __restrict__ lse,
                        const float* __restrict__ g_lse, const float* __restrict__ g_pos,
                        float* __restrict__ partial, int M, int N, int d, float k1,
                        float inv_tau) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const SplitShare s = split_share(d);
  const int n0 = s.tile * PB;
  const int tid = threadIdx.x, v = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  float* part = partial + size_t(s.tile) * M * d;

  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {   // as in the dP split kernel: every rank leaves here
    zero_partial(part, M, d, 64 * s.c_lo, min(d, 64 * (s.c_lo + s.nc)));
    return;
  }

  float* qv = reinterpret_cast<float*>(smem + small_off_qv(s.nc));
  load_query_values(qv, SQ, 0, M, labels, lse, g_lse, g_pos, inv_tau, tid, 128);
  float acc[8];
  split_scores(&tq, &tp, smem, base, s, n0, acc);
  const int pl = 16 * v + g;
  float cf[8];
  small_coefs(acc, qv, k1, col_valid, n0, N, pl, t4, cf);
  small_dq_tile(smem, base, cf, s.nc, s.c_lo, M, d, pl, t4, part);
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Forward (bf16). Each block owns one tile of 64 passages and a range of
// query rows, and writes for each of its rows that tile's partial: max of
// the valid columns' s = raw inv_tau, sum over the valid columns of
// exp(s - max) (ex2 with log2(e) folded into the scores: 2^(raw k1 - max
// log2(e)), k1 = inv_tau log2(e)), and pos = s at the label when the label
// lies in the tile (-1e30 on a masked column), else 0. A tile whose 64
// columns are all masked computes nothing and writes what computing it
// gives: max -1e30, sum-exp the count of its in-range columns (each
// exp(-1e30 - (-1e30)) = 1, so a fully masked row keeps the finite lse
// -1e30 + log N), pos -1e30 where the label lies in it. The statistics of
// a score tile come from the registers that hold it (tile_partials).
// ---------------------------------------------------------------------------
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// One step of a reduce-scatter over lane bit `off`: this lane keeps the
// upper HALF of v when its bit is set, sends the other half to its partner
// and combines what comes back into v[0 .. HALF).
template <int HALF, class Op>
__device__ __forceinline__ void scatter_step(float* v, bool hi, int off, Op op) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = hi ? v[k] : v[HALF + k];
    const float keep = hi ? v[HALF + k] : v[k];
    v[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, off));
  }
}

// Combines value(j), j < J, over the 8 lanes that share lane % 4 (lane bits
// 2-4: the passage rows g of a wgmma accumulator). J >= 8: a reduce-scatter
// (J / 2 + J / 4 + J / 8 shuffles), lane g left with j in [g J / 8, (g + 1)
// J / 8) in v[0 .. J / 8); each value is made just before its first
// shuffle, so no more than J / 2 of them are live at once. J < 8: a
// butterfly (3 J shuffles), every lane with every j in v.
template <int J, class F, class Op>
__device__ __forceinline__ void reduce_rows(float (&v)[J], int lane, F value, Op op) {
  if constexpr (J >= 8) {
    const bool hi = lane & 16;
#pragma unroll
    for (int k = 0; k < J / 2; ++k) {
      const float lo_v = value(k), hi_v = value(J / 2 + k);
      v[k] = op(hi ? hi_v : lo_v, __shfl_xor_sync(0xffffffffu, hi ? lo_v : hi_v, 16));
    }
    scatter_step<J / 4>(v, lane & 8, 8, op);
    scatter_step<J / 8>(v, lane & 4, 4, op);
  } else {
#pragma unroll
    for (int k = 0; k < J; ++k) v[k] = value(k);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < J; ++k) v[k] = op(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
}

// This lane's share of v (reduce_rows) as warp v_idx's value of each query
// column: red[v_idx Q + column]. Value j of a thread is column 8 (j / 2) +
// 2 t4 + j % 2 of the accumulator.
template <int J>
__device__ __forceinline__ void store_rows(float* red, const float (&v)[J], int v_idx, int lane) {
  constexpr int Q = 4 * J;
  const int g = lane / 4, t4 = lane % 4;
  if constexpr (J >= 8) {
#pragma unroll
    for (int k = 0; k < J / 8; ++k) {
      const int j = g * (J / 8) + k;
      red[v_idx * Q + 8 * (j >> 1) + 2 * t4 + (j & 1)] = v[k];
    }
  } else {
    if (g == 0)
#pragma unroll
      for (int j = 0; j < J; ++j) red[v_idx * Q + 8 * (j >> 1) + 2 * t4 + (j & 1)] = v[j];
  }
}

// The partials of one warpgroup's score tile: acc holds S^T (64 passages x
// Q = 8 NI query columns, register 4i + e: passage pa + 8 (e / 2), column
// 8 i + 2 t4 + e % 2). Columns are query rows qbase + column (below q_end).
// scratch (7 Q words): the columns' labels (filled by the caller before
// its first `sync`), then pos, row max and the 4 warps' values of each
// column. t is the thread in the warpgroup; `sync` a barrier of the
// warpgroup. Leaves with the scratch still read by threads t < Q.
template <int NI, class Sync>
__device__ __forceinline__ void tile_partials(const float (&acc)[4 * NI], float* scratch, int t,
                                              int qbase, int q_end, int n0, int N,
                                              const uint8_t* __restrict__ col_valid,
                                              float inv_tau, float k1, float* __restrict__ part,
                                              int tiles, int tile, int M, Sync sync) {
  constexpr int Q = 8 * NI, J = 2 * NI;
  const int v = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  const int* lab = reinterpret_cast<const int*>(scratch);
  float* posv = scratch + Q;
  float* mrow = scratch + 2 * Q;
  float* red = scratch + 3 * Q;
  const int pa = n0 + 16 * v + g, pb = pa + 8;
  const bool va = passage_valid(col_valid, pa, N), vb = passage_valid(col_valid, pb, N);

  // the tile's max of each column (a block computes only tiles with a
  // valid column, so the max is a valid column's); value j of this thread
  // is column 8 (j / 2) + 2 t4 + j % 2, its registers 4 (j / 2) + j % 2 (+ 2)
  float x[J];
  reduce_rows(x, lane, [&](int j) {
    const int r = 4 * (j >> 1) + (j & 1);
    return fmaxf(va ? acc[r] * inv_tau : NEG_INF, vb ? acc[r + 2] * inv_tau : NEG_INF);
  }, MaxOp{});
  store_rows(red, x, v, lane);
  sync();   // also orders the caller's labels
  if (t < Q) mrow[t] = fmaxf(fmaxf(red[t], red[Q + t]), fmaxf(red[2 * Q + t], red[3 * Q + t]));
  sync();
  // sum-exp of each column over the valid passages; pos from the thread
  // that holds the label's score
  reduce_rows(x, lane, [&](int j) {
    const int r = 4 * (j >> 1) + (j & 1), col = 8 * (j >> 1) + 2 * t4 + (j & 1);
    const float sa = acc[r] * inv_tau, sb = acc[r + 2] * inv_tau;
    const int l = lab[col];
    if (l == pa) posv[col] = va ? sa : NEG_INF;
    if (l == pb) posv[col] = vb ? sb : NEG_INF;
    const float ml = mrow[col] * LOG2E;
    const float ea = ex2(fmaf(acc[r], k1, -ml)), eb = ex2(fmaf(acc[r + 2], k1, -ml));
    return (va ? ea : 0.f) + (vb ? eb : 0.f);
  }, AddOp{});
  store_rows(red, x, v, lane);
  sync();
  if (t < Q && qbase + t < q_end) {
    const int l = lab[t];
    const size_t at = size_t(qbase + t) * tiles + tile, plane = size_t(tiles) * M;
    part[at] = mrow[t];
    part[plane + at] = ((red[t] + red[Q + t]) + red[2 * Q + t]) + red[3 * Q + t];
    part[2 * plane + at] = l >= n0 && l < min(n0 + PB, N) ? posv[t] : 0.f;
  }
}

// The partials of a wholly masked passage tile (`width` passages from n0)
// for query rows [q0, q1).
__device__ __forceinline__ void masked_partials(float* __restrict__ part,
                                                const int* __restrict__ labels, int tiles,
                                                int tile, int n0, int N, int M, int q0, int q1,
                                                int threads, int width = PB) {
  const int n1 = min(n0 + width, N);
  const size_t plane = size_t(tiles) * M;
  for (int q = q0 + int(threadIdx.x); q < q1; q += threads) {
    const int l = labels[q];
    const size_t at = size_t(q) * tiles + tile;
    part[at] = NEG_INF;
    part[plane + at] = float(n1 - n0);
    part[2 * plane + at] = l >= n0 && l < n1 ? NEG_INF : 0.f;
  }
}

// The forward at up to SQ query rows: one block (one warpgroup) per 64
// passages, the scores as in the small dQ/dP kernel (small_scores).
__global__ void __launch_bounds__(128, 1)
infonce_fwd_small_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                         const uint8_t* __restrict__ col_valid, float* __restrict__ part, int M,
                         int N, int d, float inv_tau, float k1) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int n0 = blockIdx.x * PB, tiles = gridDim.x;
  const int nc = (d + 63) / 64;
  const int tid = threadIdx.x;

  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {
    masked_partials(part, labels, tiles, blockIdx.x, n0, N, M, 0, M, 128);
    return;
  }
  float* scratch = reinterpret_cast<float*>(smem + small_off_c(nc));
  if (tid < SQ) reinterpret_cast<int*>(scratch)[tid] = tid < M ? labels[tid] : -1;
  float acc[8];
  small_scores(&tq, &tp, base, nc, n0, acc);
  grid_dependents_launch();   // the merge may start now: it waits for this grid's end
  tile_partials<2>(acc, scratch, tid, 0, M, n0, N, col_valid, inv_tau, k1, part, tiles,
                   blockIdx.x, M, [] { __syncthreads(); });
}

// The forward at up to SQ query rows past NC_MAX d-chunks (see the split
// kernels above): rank 0 of each cluster writes the tile's partials from
// the summed scores; a wholly masked tile's are written once, by rank 0,
// before any cluster barrier. Every rank triggers the merge once the
// scores are summed (the merge waits for this grid's end all the same).
__global__ void __launch_bounds__(128, 1)
infonce_fwd_split_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                         const uint8_t* __restrict__ col_valid, float* __restrict__ part, int M,
                         int N, int d, float inv_tau, float k1) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const SplitShare s = split_share(d);
  const int n0 = s.tile * PB, tiles = gridDim.x / s.ranks;
  const int tid = threadIdx.x;

  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {
    if (s.rank == 0) masked_partials(part, labels, tiles, s.tile, n0, N, M, 0, M, 128);
    return;
  }
  float* scratch = reinterpret_cast<float*>(smem + small_off_c(s.nc));
  if (tid < SQ) reinterpret_cast<int*>(scratch)[tid] = tid < M ? labels[tid] : -1;
  float acc[8];
  split_scores(&tq, &tp, smem, base, s, n0, acc);
  grid_dependents_launch();
  if (s.rank == 0)
    tile_partials<2>(acc, scratch, tid, 0, M, n0, N, col_valid, inv_tau, k1, part, tiles, s.tile,
                     M, [] { __syncthreads(); });
  cluster_wait();   // no rank leaves while another may read its partial
}

// The forward at more query rows. Grid: passage tiles x row groups of rq
// rows (a multiple of TQ; ops.fwd_plan), block b on tile b / groups. A
// producer warp feeds two consumer warpgroups through an SF-stage ring
// (ring_load: a P chunk and a 256-row Q chunk a stage, as the dP cluster
// kernel's pass 1); each warpgroup takes 128 of a tile's rows, its scores
// by wgmma m64n128 (ring_scores) and their partials from its registers
// (tile_partials).
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
infonce_fwd_rows_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tp, const int* __restrict__ labels,
                        const uint8_t* __restrict__ col_valid, float* __restrict__ part, int M,
                        int N, int d, int rq, float inv_tau, float k1) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int groups = (M + rq - 1) / rq;
  const int tile = blockIdx.x / groups, tiles = gridDim.x / groups;
  const int n0 = tile * PB;
  const int q_begin = (blockIdx.x % groups) * rq, q_end = min(M, q_begin + rq);
  const int t1 = (q_end - q_begin + TQ - 1) / TQ;
  const int nc = (d + 63) / 64;
  const int tid = threadIdx.x, warp = tid / 32;

  const int any = tid < PB && passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {
    masked_partials(part, labels, tiles, tile, n0, N, M, q_begin, q_end, CLUSTER_THREADS);
    return;
  }

  const uint32_t full0 = base + OFF_FBAR, empty0 = full0 + 8u * SF;
  if (tid == 0) {
    for (int s = 0; s < SF; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, 8);   // one arrival a consumer warp: both warpgroups read a stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {   // producer warp: lane 0 issues every load
    if (tid % 32 == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tp);
      ring_load<SF>(&tq, &tp, base, full0, empty0, n0, q_begin, t1, nc);
    }
    return;
  }

  const int wg = warp / 4, t = tid % 128;
  float* scratch = reinterpret_cast<float*>(smem + OFF_FSTATS + wg * FSTATS);
  auto wg_sync = [wg]() {
    if (wg == 0)   // barrier 0 is __syncthreads; one id a consumer warpgroup
      named_bar_sync<1, 128>();
    else
      named_bar_sync<2, 128>();
  };
  float acc[64];
  int it = 0;
  for (int ti = 0; ti < t1; ++ti) {
    const int qbase = q_begin + ti * TQ + wg * 128;
    wg_sync();   // the last tile's scratch is read
    reinterpret_cast<int*>(scratch)[t] = qbase + t < q_end ? labels[qbase + t] : -1;
    it = ring_scores<SF>(acc, base, full0, empty0, wg, tid % 32, nc, it);
    if (ti == t1 - 1) grid_dependents_launch();   // the merge may start: it waits for the end
    tile_partials<16>(acc, scratch, t, qbase, q_end, n0, N, col_valid, inv_tau, k1, part, tiles,
                      tile, M, wg_sync);
  }
}

// Rank-2 bf16 tensor map over a row-major (rows, cols) matrix, boxes of
// 64 columns x box_rows (hopper.cuh: 128-byte swizzled, zero past each edge)
cudaError_t map2d(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  return tensor_map_bf16<2>(map, ptr, dims, strides, box);
}

struct ClusterTag {};
template <bool DQ> struct SmallTag {};
template <int KIND> struct SplitTag {};   // 0 the forward, 1 dQ, 2 dP
struct FwdSmallTag {};
struct FwdRowsTag {};

// A launch of `tiles` x `ranks` blocks of `threads`, in clusters of `ranks`
// blocks along x
cudaLaunchConfig_t cluster_config(int tiles, int ranks, int threads, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(tiles * ranks));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t dp_cluster(const void* q, const void* p, const int* labels, const uint8_t* col_valid,
                   const float* lse, const float* g_lse, const float* g_pos, void* out, int M, int N,
                   int d, int ranks, int rq, float inv_tau, cudaStream_t st) {
  // nothing of the plan depends on d: each rank takes its share of the
  // d-chunks in groups of up to NCH, the last group of a share as it falls
  if (ranks < 1 || ranks > RANKS_MAX || rq % TQ || rq > RQ_MAX || ranks * rq < M ||
      (ranks - 1) * rq >= M)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tp;
  cudaError_t err;
  if ((err = map2d(&tq, q, d, M, KT)) != cudaSuccess ||
      (err = map2d(&tp, p, d, N, PB)) != cudaSuccess)
    return err;
  if ((err = allow_smem_once<ClusterTag>(reinterpret_cast<const void*>(infonce_dp_cluster_kernel),
                                         SMEM_CLUSTER)) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config((N + PB - 1) / PB, ranks, CLUSTER_THREADS, SMEM_CLUSTER, st, attr);
  err = cudaLaunchKernelEx(&cfg, infonce_dp_cluster_kernel, tq, tp, labels, col_valid, lse, g_lse,
                           g_pos, static_cast<__nv_bfloat16*>(out), M, N, d, rq, inv_tau * LOG2E,
                           inv_tau);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// At up to SQ query rows: ranks 1 is the small kernels' block (d up to 64
// NC_MAX), else the split kernels' clusters of 2 to RANKS_MAX ranks, each
// on 1 to NC_MAX of the d-chunks (ops.small_ranks).
bool small_plan_fits(int M, int d, int ranks) {
  const int nc = (d + 63) / 64;
  if (M > SQ) return false;
  if (ranks == 1) return nc <= NC_MAX;
  return ranks >= 2 && ranks <= RANKS_MAX && ranks <= nc && (nc + ranks - 1) / ranks <= NC_MAX;
}

// A split kernel (kind KIND) on each tile of 64 passages in clusters of
// `ranks` blocks; a refused cluster launch returns its error.
template <int KIND, class Kernel, class... Args>
cudaError_t launch_split(Kernel kernel, int N, int d, int ranks, cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem_once<SplitTag<KIND>>(reinterpret_cast<const void*>(kernel),
                                                    split_smem(NC_MAX));
  if (err != cudaSuccess) return err;
  const int nc = (d + 63) / 64;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config((N + PB - 1) / PB, ranks, 128,
                                                split_smem((nc + ranks - 1) / ranks), st, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// dQ or dP at up to SQ query rows: the small kernel (ranks 1) or the split
// kernel in clusters of `ranks` blocks a passage tile. out: dQ's fp32
// partials (tiles, M, d), or dP (N, d) bf16.
template <bool DQ>
cudaError_t small(const void* q, const void* p, const int* labels, const uint8_t* col_valid,
                  const float* lse, const float* g_lse, const float* g_pos, void* out, int M,
                  int N, int d, int ranks, float inv_tau, cudaStream_t st) {
  if (!small_plan_fits(M, d, ranks)) return cudaErrorInvalidValue;
  CUtensorMap tq, tp;
  cudaError_t err;
  if ((err = map2d(&tq, q, d, M, SQ)) != cudaSuccess ||
      (err = map2d(&tp, p, d, N, PB)) != cudaSuccess)
    return err;
  const float k1 = inv_tau * LOG2E;
  if (ranks > 1) {
    if constexpr (DQ)
      return launch_split<1>(infonce_dq_split_kernel, N, d, ranks, st, tq, tp, labels, col_valid,
                             lse, g_lse, g_pos, static_cast<float*>(out), M, N, d, k1, inv_tau);
    else
      return launch_split<2>(infonce_dp_split_kernel, N, d, ranks, st, tq, tp, labels, col_valid,
                             lse, g_lse, g_pos, static_cast<__nv_bfloat16*>(out), M, N, d, k1,
                             inv_tau);
  }
  const auto kernel = infonce_small_kernel<DQ>;
  if ((err = allow_smem_once<SmallTag<DQ>>(reinterpret_cast<const void*>(kernel),
                                           small_smem(NC_MAX))) != cudaSuccess)
    return err;
  const int smem = small_smem((d + 63) / 64);
  infonce_small_kernel<DQ><<<(N + PB - 1) / PB, 128, smem, st>>>(
      tq, tp, labels, col_valid, lse, g_lse, g_pos, out, M, N, d, k1, inv_tau);
  return cudaGetLastError();
}

// The forward's Hopper kernel, then the merge of each row's tile partials
// (part: (3, M, tiles) fp32). M <= SQ: the small kernel (ranks 1) or the
// split kernel (clusters of `ranks`); above, the rows kernel in groups of
// rq rows at any d.
cudaError_t fwd_tiles(const void* q, const void* p, const int* labels, const uint8_t* col_valid,
                      float* lse, float* pos, float* amax, float* part, int M, int N, int d, int rq,
                      int ranks, float inv_tau, cudaStream_t st) {
  if (M <= SQ ? !small_plan_fits(M, d, ranks) : (rq < TQ || rq % TQ)) return cudaErrorInvalidValue;
  CUtensorMap tq, tp;
  cudaError_t err;
  if ((err = map2d(&tq, q, d, M, M <= SQ ? SQ : 64)) != cudaSuccess ||
      (err = map2d(&tp, p, d, N, PB)) != cudaSuccess)
    return err;
  const int tiles = (N + PB - 1) / PB;
  const float k1 = inv_tau * LOG2E;
  if (M <= SQ && ranks > 1) {
    err = launch_split<0>(infonce_fwd_split_kernel, N, d, ranks, st, tq, tp, labels, col_valid,
                          part, M, N, d, inv_tau, k1);
  } else if (M <= SQ) {
    if ((err = allow_smem_once<FwdSmallTag>(reinterpret_cast<const void*>(infonce_fwd_small_kernel),
                                            small_smem(NC_MAX))) != cudaSuccess)
      return err;
    infonce_fwd_small_kernel<<<tiles, 128, small_smem((d + 63) / 64), st>>>(
        tq, tp, labels, col_valid, part, M, N, d, inv_tau, k1);
    err = cudaGetLastError();
  } else {
    if ((err = allow_smem_once<FwdRowsTag>(reinterpret_cast<const void*>(infonce_fwd_rows_kernel),
                                           SMEM_FWD)) != cudaSuccess)
      return err;
    infonce_fwd_rows_kernel<<<tiles * ((M + rq - 1) / rq), CLUSTER_THREADS, SMEM_FWD, st>>>(
        tq, tp, labels, col_valid, part, M, N, d, rq, inv_tau, k1);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return launch_stats_merge(part, lse, pos, amax, M, tiles, st);
}

}  // namespace hp

// ============================================================================
// fp32 dQ and dP on Hopper: 3xTF32 on wgmma (namespace tx)
// ============================================================================
// What bounds them on an H100 SXM: the products. 3xTF32 runs each product
// three times on the TF32 tensor cores (495 TFLOP/s): the scores and the
// gradient product, 3 x 4 M N d operations, 1.26 ms at the xdev bank rows
// (M = 8192, N = 8256, d = 768) against 3.10 ms for fp32 FMAs at 67 TFLOP/s.
// One TF32 pass keeps 10 mantissa bits (a score of ~100 off by ~0.01, a
// coefficient by 1%): not an fp32 result. Each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest), and each product is
// hi hi + hi lo + lo hi: the dropped lo lo and lo's rounding are ~2^-22 of
// |x y| a term.
//
// The split runs once a call, before the products: infonce_tf32_split_kernel
// writes q and p as hi and lo planes (2, rows, d) (it reads 4 and writes 8
// bytes an element: ~50 us at the xdev bank rows). Split per use inside the
// product kernel, every element of the streamed operand would cost a load
// and three conversions per 768 operations of each product: more
// instructions than one warpgroup issues in the products' time.
//
// The two products, both on K-major operands (tf32 wgmma takes no
// transposed operand, so Y is read as it lies by one product and
// transposed into registers for the other):
//   X: the output's rows (dP: passages, dQ: queries), a cluster's tile of 64
//   Y: the contraction rows (dP: queries, dQ: passages), 32 a step
//   S^T (X x Y) = X Y^T     A = X (hi, lo: resident in shared memory),
//                           B = the step's Y (hi, lo: streamed by TMA, two
//                           stages), both as they lie (K = d); m64n32k8
//   C  = the coefficients of S^T, computed in its registers (the file's
//        header; dQ keeps each of a thread's two query rows' lse, g_lse,
//        g_pos and label in registers, dP reads the step's 32 queries' from
//        shared memory), written as hi and lo to shared memory as a K-major
//        B (row x: the step's 32 Y rows)
//   out^T (d x X) += Y^T C  A = Y^T (registers: this warp's d rows of the
//                           step's hi and lo boxes read transposed, 8 loads
//                           a k-step), B = C; m64n64k8
// C never reaches device memory. d is shared across a cluster of `ranks`
// blocks (ops.tf32x3_ranks: 4 at d = 768), rank r on columns [192 r, 192 r +
// 192): PAIRS = 3 M-tiles of 64 columns of out^T and the same columns of X
// (hi + lo, 96 KB resident). The whole d = 768 tile would not fit one SM: X
// alone is 384 KB as hi and lo, and 64 x 768 accumulators fill three
// quarters of the register file. A rank's scores are partial (its 192
// columns of d): the ranks exchange their 64 x 32 partials through
// distributed shared memory each step and sum them in rank order, so every
// rank holds the same scores and C, and two calls give the same bits.
// A block is two consumer warpgroups that share each step: warpgroup w
// takes 3 of the rank's 6 chunks of the scores (their partials meet in C's
// boxes, which no product reads then), then half of the step's Y rows: it
// publishes and gathers that half of the partials, computes that half of C,
// and runs the gradient product over those 16 rows for all 3 M-tiles into
// accumulators of its own (96 registers a thread, over every step of the
// block), added to the other warpgroup's once at the end (one warpgroup a
// block runs every phase in one instruction stream, its waits exposed).
// Thread 0 issues every TMA
// load, refilling a Y stage once both warpgroups have read it, a step
// ahead; a producer warp would have to take part in every cluster barrier
// (one a step) and could run at most a step ahead, so the stages are
// refilled at the same moment either way.
// Accuracy: the tensor cores round each wgmma's sum into its fp32
// accumulator toward zero at the accumulator's size, so a score summed over
// a rank's 72 wgmmas (24 k-steps x 3) in one accumulator loses tens of ulp
// of its size. Each
// half-chunk (2 k-steps) of the scores and each M-tile's step of the
// gradient sum into a fresh accumulator (wgmma's scale-d 0; zeroing it
// instead makes ptxas serialize the products), the small hi lo and lo hi
// terms first, promoted by fp32 adds; the warpgroups' and ranks' sums of
// the partial scores keep their rounding errors (two_sum) up to the
// coefficient's argument. Each landed half-chunk of the scores is moved one
// ulp away from zero first (away_ulp), as in the forward: the truncation
// leaves a fresh half-chunk about an ulp short, and the scores 0.6-1.1 ulp
// short, a bias that adds up over the rows a passage dominates in dP.
// The answers this design gives: (1) tf32 wgmma takes both operands
// K-major, so the gradient product's Y is not transposed in shared memory
// but read transposed into registers (its A operand; 2-way bank conflicts)
// from the same boxes the score product reads by descriptor, and C is
// staged through shared memory as the K-major B (the score accumulator's
// layout is not a tf32 A fragment's); (2) shared memory holds X's 96 KB,
// two 48 KB Y stages, C's 16 KB (also the warpgroups' scratch), two 8 KB
// exchange buffers: 226 KB of the 227; (3) the tensor maps are encoded with
// the device's primary context made current (hopper.cuh), as an autograd
// worker's first call needs; (4) ptxas gives the two kernels about 250
// registers a thread, no spills (chip_smoke.py's build report has the
// numbers); (5) the fp32 forward runs on 3xTF32 too
// (infonce_tf32x3_fwd_kernel, below): its scores are these kernels'
// half-chunk sums, nudged alike, added in order in fp32, so the lse these
// coefficients are taken against shares their arithmetic (the CUDA-core
// forward's lse, of other scores, put the coefficients of the bank rows'
// dP 5.8x the plain version's error against float64 where the 3xTF32
// forward's gives 0.6-0.8x: PERF.md, PR 33).
// Splits: the contraction axis is split only where the output tiles cannot
// fill the card (ops.tf32x3_split_plan: the 32 local queries' dQ, one tile;
// the ring's in-batch dP, one tile of 64 passages): split s writes its fp32
// partial of out, and infonce_grad_reduce_kernel<float> sums them in split
// order. A block whose passages (dP: its X tile; dQ: its Y range) are all
// masked writes zeros and computes nothing.
namespace tx {

using namespace hopper;

constexpr int XT = 64;                 // output rows a cluster: the scores' M, the gradient's N
constexpr int YT = 32;                 // contraction rows a step: the scores' N, the gradient's K
constexpr int XBOX = 64 * 128;         // 64 rows x 32 fp32 columns, 128-byte swizzled (8 KB)
constexpr int YBOX = YT * 128;         // 32 rows x 32 fp32 columns (4 KB)
constexpr int PAIRS = 3;               // 64-column M-tiles of out^T a rank holds
constexpr int NCH = 2 * PAIRS;         // 32-column chunks of d a rank holds (192 columns)
constexpr int STAGE = 2 * NCH * YBOX;  // a step's Y: NCH hi boxes, then NCH lo boxes (48 KB)
constexpr int NSTAGE = 2;
constexpr int EXCH = 128 * 16 * 4;     // a 64 x 32 partial score tile, 16 values a thread (8 KB)
constexpr int OFF_XHI = 0;
constexpr int OFF_XLO = NCH * XBOX;
constexpr int OFF_Y = 2 * NCH * XBOX;
constexpr int OFF_CHI = OFF_Y + NSTAGE * STAGE;   // C: 64 X rows x 32 Y rows, hi then lo
constexpr int OFF_CLO = OFF_CHI + XBOX;
constexpr int OFF_EX = OFF_CLO + XBOX;            // two exchange buffers, steps alternating
constexpr int OFF_YV = OFF_EX + 2 * EXCH;         // dP: a stage's queries' lse, G, H, label
constexpr int OFF_BAR = OFF_YV + NSTAGE * 4 * YT * 4;
constexpr int N_BARS = NSTAGE + 1;                // a full barrier a stage, and X's
constexpr int SMEM = OFF_BAR + 8 * N_BARS + 1024;   // + slack to align the base
constexpr int BLOCK = 256;                        // two consumer warpgroups
constexpr int D_MAX = hp::RANKS_MAX * NCH * 32;   // 1536
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");
static_assert(XBOX % 1024 == 0 && YBOX % 1024 == 0 && OFF_Y % 1024 == 0 && OFF_CHI % 1024 == 0,
              "1 KB aligned boxes");

// hi and lo planes of a fp32 array of n4 float4s: x = hi + lo + O(2^-22 |x|)
__global__ void __launch_bounds__(256)
infonce_tf32_split_kernel(const float4* __restrict__ src, uint4* __restrict__ hi,
                          uint4* __restrict__ lo, size_t n4) {
  for (size_t i = size_t(blockIdx.x) * 256 + threadIdx.x; i < n4; i += size_t(gridDim.x) * 256) {
    const float4 x = src[i];
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// byte offset of element (row, col) of a box of 32 fp32 columns in TMA's
// 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)), which wgmma's
// 128-byte swizzled K-major descriptor reads
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}
template <int N>
__device__ __forceinline__ void add_to(float (&a)[N], const float (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] += b[i];
}
// A landed half-chunk of the scores moved one ulp away from zero, the next
// float of its bit pattern. The tensor cores truncate each wgmma's sum
// toward zero at the accumulator's size, so a fresh half-chunk comes out
// short by about an ulp of its own size on average, and a score summed
// from 48 of them by 0.6-1.1 ulp of the score: a bias that adds up in dP
// over the many rows a passage takes part in (measured on an H100, the
// forward, dQ and dP alike; with the nudge, +0.1-0.3 ulp). Every
// half-chunk of the forward's and the gradients' scores takes it, so the
// forward's lse and the gradients' scores keep one arithmetic. The
// gradients' kernels keep +0 (u + min(u, 1): u + 1 made dQ spill 16 bytes);
// the forward adds u + 1 as it sums (a zero half-chunk, d's padding, adds
// 2^-149; 12% faster than u + min(u, 1) at the xdev bank rows).
template <int N>
__device__ __forceinline__ void away_ulp(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t u = __float_as_uint(a[i]);
    a[i] = __uint_as_float(u + min(u, 1u));
  }
}
template <int N>
__device__ __forceinline__ void add_away(float (&s)[N], const float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] += __uint_as_float(__float_as_uint(a[i]) + 1u);
}
// hi + lo += b, hi the rounded sum and lo the rounding errors so far
// (Knuth's TwoSum: exact whatever the magnitudes)
__device__ __forceinline__ void two_sum(float& hi, float& lo, float b) {
  const float s = hi + b, bp = s - hi;
  lo += (hi - (s - bp)) + (b - bp);
  hi = s;
}

// Half a 32-column chunk of the scores (k-steps 2 kh, 2 kh + 1) into acc,
// afresh: X hi Y lo and X lo Y hi first, then X hi Y hi. The tensor cores
// round each wgmma's sum into the accumulator toward zero at the
// accumulator's size, so the small terms go in while it is small, and a
// fresh accumulator takes only 2 of the large hi hi sums: for two nearly
// parallel rows (the logits that dominate a softmax) the truncations all
// shrink |s|, ~n/4 ulp of s for n hi hi sums an accumulator (at the xdev
// phase's logits of hundreds, n = 4, a whole chunk, is an error that adds
// up over the rows a passage dominates in dP). xh, xl: the
// chunk's X boxes (64 rows, the product's M); yh, yl: its Y boxes (N rows:
// 32 here, 128 in the forward).
template <int N>
__device__ __forceinline__ void score_half(float (&acc)[N / 2], uint32_t xh, uint32_t xl,
                                           uint32_t yh, uint32_t yl, int kh) {
#pragma unroll
  for (int k = 2 * kh; k < 2 * kh + 2; ++k) {
    const uint64_t ah = desc_sw128(xh + 32 * k, 16, 1024), al = desc_sw128(xl + 32 * k, 16, 1024);
    const uint64_t bh = desc_sw128(yh + 32 * k, 16, 1024), bl = desc_sw128(yl + 32 * k, 16, 1024);
    wgmma_tf32_ss<N>(acc, ah, bl, k - 2 * kh);
    wgmma_tf32_ss<N>(acc, al, bh, 1);
  }
#pragma unroll
  for (int k = 2 * kh; k < 2 * kh + 2; ++k)
    wgmma_tf32_ss<N>(acc, desc_sw128(xh + 32 * k, 16, 1024), desc_sw128(yh + 32 * k, 16, 1024), 1);
}

// A fragments of two k-steps (16 Y rows from ks0 on) of out^T = Y^T C from
// the step's hi and lo boxes of this warp's 32 columns of the M-tile (yh,
// yl): k-step k's hi at f[8k..8k+3], lo at f[8k+4..]; d rows 16 (v % 2) + g
// (+8) of the box, Y rows 8 (ks0 + k) + t4 (+4)
__device__ __forceinline__ void grad_frags(uint32_t (&f)[16], const uint8_t* yh, const uint8_t* yl,
                                           int ks0, int v, int g, int t4) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int at = swz(8 * (ks0 + k) + t4 + 4 * (q >> 1), 16 * (v & 1) + g + 8 * (q & 1));
      f[8 * k + q] = *reinterpret_cast<const uint32_t*>(yh + at);
      f[8 * k + 4 + q] = *reinterpret_cast<const uint32_t*>(yl + at);
    }
}

// Two k-steps (from ks0 on) of out^T = Y^T C into acc, afresh: Y hi C lo
// and Y lo C hi first, then Y hi C hi (the small terms while acc is small,
// as in score_half)
__device__ __forceinline__ void grad_mma(float (&acc)[32], const uint32_t (&f)[16], uint32_t chi,
                                         uint32_t clo, int ks0) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint64_t h = desc_sw128(chi + 32 * (ks0 + k), 16, 1024);
    const uint64_t l = desc_sw128(clo + 32 * (ks0 + k), 16, 1024);
    wgmma_tf32_n64(acc, &f[8 * k], l, k);
    wgmma_tf32_n64(acc, &f[8 * k + 4], h, 1);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    wgmma_tf32_n64(acc, &f[8 * k], desc_sw128(chi + 32 * (ks0 + k), 16, 1024), 1);
}

// ---------------------------------------------------------------------------
// Grid: (X tiles x splits) clusters of `ranks` blocks along x; cluster cid on
// X tile cid / splits and Y steps [s per, min(y_steps, (s + 1) per)), s = cid
// % splits. out: (X rows, d) fp32, or with splits > 1 the partials (splits,
// X rows, d). The tensor maps read the hi and lo planes of X (boxes of 64
// rows) and of Y (32 rows), each 32 columns wide.
// ---------------------------------------------------------------------------
template <bool DQ>
__global__ void __launch_bounds__(BLOCK, 1)
infonce_tf32x3_kernel(const __grid_constant__ CUtensorMap xhi, const __grid_constant__ CUtensorMap xlo,
                      const __grid_constant__ CUtensorMap yhi, const __grid_constant__ CUtensorMap ylo,
                      const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
                      const float* __restrict__ lse, const float* __restrict__ g_lse,
                      const float* __restrict__ g_pos, float* __restrict__ out, int M, int N, int d,
                      int splits, int per, float inv_tau) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hp::aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int ranks = int(cluster_nctarank()), rank = int(cluster_ctarank());
  const int cid = int(blockIdx.x) / ranks, split = cid % splits;
  const int x_rows = DQ ? M : N, y_rows = DQ ? N : M;
  const int x0 = (cid / splits) * XT;
  const int t0 = split * per, t1 = min((y_rows + YT - 1) / YT, t0 + per);
  const int c_lo = rank * NCH;   // this rank's first 32-column chunk of d
  // warpgroup w of the block, thread lt in it; warp v of the warpgroup
  const int tid = threadIdx.x, w = tid / 128, lt = tid % 128;
  const int v = lt / 32, g = (lt % 32) / 4, t4 = lt % 4;
  float* dst = out + size_t(split) * x_rows * d;

  // the block's passages: dP its X tile, dQ its Y range; all masked: its
  // columns of the output are 0 (every rank sees the same and leaves here,
  // before any cluster barrier)
  int any = 0;
  if constexpr (DQ) {
    for (int n = t0 * YT + tid; n < min(N, t1 * YT) && !any; n += BLOCK)
      any = col_valid == nullptr || col_valid[n] != 0;
  } else {
    any = tid < XT && hp::passage_valid(col_valid, x0 + tid, N);
  }
  if (!__syncthreads_or(any)) {
    const int col0 = 32 * c_lo, width = (min(d, 32 * (c_lo + NCH)) - col0) / 4;   // d % 4 == 0
    for (int x = tid; x < XT * max(width, 0); x += BLOCK)
      if (x0 + x / width < x_rows)
        *reinterpret_cast<float4*>(dst + size_t(x0 + x / width) * d + col0 + 4 * (x % width)) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  const uint32_t full0 = base + OFF_BAR, xbar = full0 + 8u * NSTAGE;
  // step t's Y (hi and lo boxes of this rank's chunks) into stage (t - t0) % 2
  auto load_step = [&](int t) {
    const uint32_t s = (t - t0) % NSTAGE, st = base + OFF_Y + s * STAGE;
    mbar_expect_tx(full0 + 8u * s, STAGE);
    for (int c = 0; c < NCH; ++c) {
      tma_load_2d(&yhi, st + c * YBOX, full0 + 8u * s, 32 * (c_lo + c), YT * t);
      tma_load_2d(&ylo, st + (NCH + c) * YBOX, full0 + 8u * s, 32 * (c_lo + c), YT * t);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < N_BARS; ++s) mbar_init(full0 + 8u * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    prefetch_tensormap(&xhi);
    prefetch_tensormap(&xlo);
    prefetch_tensormap(&yhi);
    prefetch_tensormap(&ylo);
    mbar_expect_tx(xbar, 2 * NCH * XBOX);
    for (int c = 0; c < NCH; ++c) {   // columns past d are TMA's zeros
      tma_load_2d(&xhi, base + OFF_XHI + c * XBOX, xbar, 32 * (c_lo + c), x0);
      tma_load_2d(&xlo, base + OFF_XLO + c * XBOX, xbar, 32 * (c_lo + c), x0);
    }
    for (int t = t0; t < min(t1, t0 + NSTAGE); ++t) load_step(t);
  }
  // this thread's X rows x0 + 16 v + g + 8 h (the score registers' rows):
  // dP whether the passage is valid; dQ whether the query is below M, and
  // its lse, g_lse inv_tau, g_pos inv_tau and label
  bool xok[2];
  float xl[2], xg[2], xh[2];
  int xlab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + 16 * v + g + 8 * h;
    if constexpr (DQ) {
      xok[h] = x < M;
      xl[h] = xok[h] ? lse[x] : 0.f;
      xg[h] = xok[h] ? g_lse[x] * inv_tau : 0.f;
      xh[h] = xok[h] ? g_pos[x] * inv_tau : 0.f;
      xlab[h] = xok[h] ? labels[x] : -1;
    } else {
      xok[h] = hp::passage_valid(col_valid, x, N);
    }
  }

  float acc[PAIRS][32];   // this warpgroup's half of the contraction, over every step
#pragma unroll
  for (int mt = 0; mt < PAIRS; ++mt) zero(acc[mt]);
  uint32_t fa[16], fb[16];   // A fragments, two sets: one loads while the other's products run
  float c0[16], c1[16];      // chunk accumulators of the scores, alternating
  float f0[32];              // an M-tile's step of out^T, added to acc[mt]
  mbar_wait(xbar, 0);
  static_assert(NCH == 6 && PAIRS == 3, "three chunks and three M-tiles a warpgroup below");
  auto wg_sync = [w]() {   // this warpgroup alone (barrier 0 is the block's)
    if (w == 0)
      named_bar_sync<1, 128>();
    else
      named_bar_sync<2, 128>();
  };

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) % NSTAGE;
    const uint32_t st = base + OFF_Y + s * STAGE;
    const uint8_t* ys = smem + OFF_Y + s * STAGE;
    // dP: the step's queries' values (Y rows are queries), loaded now and
    // stored once the scores are issued, read after the barriers below
    float* yv = reinterpret_cast<float*>(smem + OFF_YV + s * 4 * YT * 4);
    float vl = 0.f, vg = 0.f, vh = 0.f;
    int vlab = -1;
    if (!DQ && tid < YT && YT * t + tid < M) {
      const int y = YT * t + tid;
      vl = lse[y];
      vg = g_lse[y] * inv_tau;
      vh = g_pos[y] * inv_tau;
      vlab = labels[y];
    }
    mbar_wait(full0 + 8u * s, ((t - t0) / NSTAGE) & 1);

    // ---- this warpgroup's partial S^T (X x Y) over its 3 of the rank's 6
    // chunks, half a chunk at a time into c0, c1 alternately (one half's
    // products run while the last is added)
    // half-chunk hc (0..5) of this warpgroup: chunk 3 w + hc / 2, half hc % 2
    auto half = [&](float (&cacc)[16], int hc) {
      const int c = 3 * w + hc / 2;
      fence_regs<16>(cacc);
      wgmma_fence();
      score_half<YT>(cacc, base + OFF_XHI + c * XBOX, base + OFF_XLO + c * XBOX, st + c * YBOX,
                 st + (NCH + c) * YBOX, hc % 2);
      wgmma_commit();
    };
    // The half-chunks' sums add at an eighth of the score's size or less;
    // the sums of the two warpgroups' and of the ranks' partials keep their
    // rounding errors (two_sum): at logits of hundreds an fp32 add rounds at
    // ~6e-5 (half an ulp of 512), and those 4 sums put a coefficient ~1 ulp
    // of its score off.
    float sc[16];
    half(c0, 0);
    half(c1, 1);
    wgmma_wait<1>();
    fence_regs<16>(c0);
    away_ulp(c0);
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = c0[i];
#pragma unroll
    for (int hc = 2; hc < 6; hc += 2) {
      half(c0, hc);
      wgmma_wait<1>();
      fence_regs<16>(c1);
      away_ulp(c1);
      add_to(sc, c1);
      half(c1, hc + 1);
      wgmma_wait<1>();
      fence_regs<16>(c0);
      away_ulp(c0);
      add_to(sc, c0);
    }
    if (!DQ && tid < YT) {
      yv[tid] = vl;
      yv[YT + tid] = vg;
      yv[2 * YT + tid] = vh;
      reinterpret_cast<int*>(yv)[3 * YT + tid] = vlab;
    }
    wgmma_wait<0>();
    fence_regs<16>(c1);
    away_ulp(c1);
    add_to(sc, c1);

    // ---- the rank's partial (warpgroup 0's + 1's, through the C boxes,
    // which no product reads now), then every rank's, summed in rank order:
    // warpgroup w only its half of the step's Y rows (registers 4 i + e, i
    // = 2 w, 2 w + 1: value q = i of a thread at + 2 KB q)
    uint8_t* scratch = smem + OFF_CHI;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(scratch + w * XBOX + 2048 * q + lt * 16) =
          make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2], sc[4 * q + 3]);
    __syncthreads();
    float s2[8], s2e[8];   // this warpgroup's half of the scores, and its rounding errors
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = 2 * w + j;
      const float4 a = *reinterpret_cast<const float4*>(scratch + 2048 * q + lt * 16);
      const float4 b = *reinterpret_cast<const float4*>(scratch + XBOX + 2048 * q + lt * 16);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s2[4 * j + k] = av[k];
        s2e[4 * j + k] = 0.f;
        two_sum(s2[4 * j + k], s2e[4 * j + k], bv[k]);
      }
    }
    if (ranks > 1) {
      const uint32_t ex = OFF_EX + ((t - t0) & 1) * EXCH + lt * 16;
      add_to(s2, s2e);   // the rank's partial, rounded once at a quarter of the score's size
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float4*>(smem + ex + 2048 * (2 * w + j)) =
            make_float4(s2[4 * j], s2[4 * j + 1], s2[4 * j + 2], s2[4 * j + 3]);
      cluster_arrive();   // this rank's partial (and the step's query values) are written
      cluster_wait();     // and every rank's (a buffer is written again two steps on,
                          // after the next barrier: every rank has read it by then)
#pragma unroll
      for (int i = 0; i < 8; ++i) s2[i] = s2e[i] = 0.f;
      for (int r0 = 0; r0 < ranks; r0 += 2) {   // two ranks' loads in flight at once
        uint4 u[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            u[r][j] = r0 + r < ranks ? ld_cluster_v4(base + ex + 2048 * (2 * w + j), r0 + r)
                                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            two_sum(s2[4 * j], s2e[4 * j], __uint_as_float(u[r][j].x));
            two_sum(s2[4 * j + 1], s2e[4 * j + 1], __uint_as_float(u[r][j].y));
            two_sum(s2[4 * j + 2], s2e[4 * j + 2], __uint_as_float(u[r][j].z));
            two_sum(s2[4 * j + 3], s2e[4 * j + 3], __uint_as_float(u[r][j].w));
          }
      }
    } else {
      __syncthreads();   // the scratch is read (C's boxes are written next)
    }

    // ---- coefficients from the score registers (value 4 j + e: X row 16 v
    // + g + 8 (e / 2), Y row 8 (2 w + j) + 2 t4 + e % 2 of the step), as hi
    // and lo into C's boxes: row x, column y (K-major for out^T = Y^T C);
    // each warpgroup writes the Y rows its own products read.
    // exp(s inv_tau - lse) as ex2 of the difference times log2(e): the
    // difference is taken from the score's two parts, s2 + s2e, in full
    // fp32 first (a coefficient that counts has it near 0).
    const int* ylab = reinterpret_cast<const int*>(yv + 3 * YT);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, x = 16 * v + g + 8 * h, y = 8 * (2 * w + j) + 2 * t4 + (e & 1);
        const int yg = YT * t + y;
        const float s_lo = s2e[4 * j + e] * inv_tau;
        float c;
        bool ok;
        if constexpr (DQ) {
          ok = xok[h] && hp::passage_valid(col_valid, yg, N);
          c = fmaf(ex2((fmaf(s2[4 * j + e], inv_tau, -xl[h]) + s_lo) * hp::LOG2E), xg[h],
                   xlab[h] == yg ? xh[h] : 0.f);
        } else {
          ok = xok[h] && yg < M;
          c = fmaf(ex2((fmaf(s2[4 * j + e], inv_tau, -yv[y]) + s_lo) * hp::LOG2E), yv[YT + y],
                   ylab[y] == x0 + x ? yv[2 * YT + y] : 0.f);
        }
        uint32_t hi, lo;
        tf32_split(ok ? c : 0.f, hi, lo);
        *reinterpret_cast<uint32_t*>(smem + OFF_CHI + swz(x, y)) = hi;
        *reinterpret_cast<uint32_t*>(smem + OFF_CLO + swz(x, y)) = lo;
      }
    fence_proxy_async();
    wg_sync();

    // ---- out^T (this rank's 192 columns of d x 64 X rows) += Y^T C over
    // this warpgroup's 16 Y rows (k-steps 2 w, 2 w + 1): each M-tile into a
    // fresh accumulator f0, added to acc[mt] once its products have landed;
    // the next M-tile's fragments load while they run. (Two accumulators
    // alternating, one M-tile's products running while the last is added,
    // make ptxas serialize every wgmma of the kernel, C7515: their live
    // ranges cross the next products'.)
    auto frags = [&](uint32_t (&f)[16], int mt) {
      const int box = 2 * mt + v / 2;   // this warp's 32 columns of the M-tile
      grad_frags(f, ys + box * YBOX, ys + (NCH + box) * YBOX, 2 * w, v, g, t4);
    };
    auto issue = [&](const uint32_t (&f)[16]) {
      fence_regs<32>(f0);
      wgmma_fence();
      grad_mma(f0, f, base + OFF_CHI, base + OFF_CLO, 2 * w);
      wgmma_commit();
    };
    auto land = [&](float (&a)[32]) {
      wgmma_wait<0>();
      fence_regs<16>(fa);
      fence_regs<16>(fb);
      fence_regs<32>(f0);
      add_to(a, f0);
    };
    frags(fa, 0);
    issue(fa);
    frags(fb, 1);
    land(acc[0]);
    issue(fb);
    frags(fa, 2);
    land(acc[1]);
    issue(fa);
    land(acc[2]);
    __syncthreads();   // every warp has read the stage: it takes step t + 2
    if (tid == 0 && t + NSTAGE < t1) load_step(t + NSTAGE);
  }

  // warpgroup 1's accumulators into warpgroup 0's (through the Y stages,
  // which nothing reads now), in that order
  float* other = reinterpret_cast<float*>(smem + OFF_Y);
  if (w == 1)
#pragma unroll
    for (int mt = 0; mt < PAIRS; ++mt) {
      fence_regs<32>(acc[mt]);
#pragma unroll
      for (int i = 0; i < 32; ++i) other[(mt * 32 + i) * 128 + lt] = acc[mt][i];
    }
  __syncthreads();
  // register 4 i + e of acc[mt]: column 32 c_lo + 64 mt + 16 v + g + 8 (e /
  // 2) of d, X row x0 + 8 i + 2 t4 + e % 2
  if (w == 0)
#pragma unroll
    for (int mt = 0; mt < PAIRS; ++mt) {
      fence_regs<32>(acc[mt]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 32 * c_lo + 64 * mt + 16 * v + g + 8 * (e >> 1);
          const int x = x0 + 8 * i + 2 * t4 + (e & 1);
          if (col < d && x < x_rows)
            dst[size_t(x) * d + col] = acc[mt][4 * i + e] + other[(mt * 32 + 4 * i + e) * 128 + lt];
        }
    }
  cluster_arrive();   // no rank leaves while another may read its partial scores
  cluster_wait();
}

// ---------------------------------------------------------------------------
// The fp32 forward on 3xTF32 (ops.path_of's "tf32x3" for the forward). It
// has no d-wide output (three floats a query row), so one block owns a
// tile of FQ query rows x FP passages and streams d, with no cluster:
// warpgroup w takes query rows 64 w .. 64 w + 63 of the tile against all
// FP passages (wgmma m64n128k8: the queries as M from q's boxes, the
// passages as N from p's; both K-major as they lie). A ring of FS stages
// holds 32-column chunks of d (q's hi and lo boxes of 128 rows, then p's:
// 64 KB a stage); each half-chunk of 16 columns goes into a fresh
// accumulator (c0, c1: score_half, the small hi lo and lo hi terms first),
// moved an ulp away from zero and added in fp32 to the running score S
// once it has landed (add_away; the gradients' scores take the same
// nudge). Both halves of
// a chunk are in flight at once, and both have landed before the loop
// goes on: nothing is in flight at a branch. Thread 0 issues every load:
// at the end of chunk c it refills the stage of chunk c - 1 once both
// warpgroups have released it (an empty barrier of 8 arrivals, one a
// warp), so one warpgroup may run up to a chunk behind the other and their
// waits need not coincide. The tile's partials come from the score
// registers: a thread holds two query rows x 32 passages, the 4 threads of
// a row combine their max, sum-exp and pos by two shuffles, and write the
// tile's (max, sum-exp, pos) to part (3, M, tiles) for
// infonce_stats_merge_kernel (the bf16 forward's contract). A tile whose
// passages are all masked computes nothing and writes what computing it
// gives (masked_partials); a warpgroup whose 64 rows all lie past M only
// waits on each stage and releases it.
// ---------------------------------------------------------------------------
constexpr int FQ = 128;            // query rows a block: two warpgroups x wgmma's 64
constexpr int FP = 128;            // passages a block: wgmma's N
constexpr int FBOX = 128 * 128;    // 128 rows x 32 fp32 columns, 128-byte swizzled (16 KB)
constexpr int FSTAGE = 4 * FBOX;   // q hi, q lo, p hi, p lo of a 32-column chunk (64 KB)
constexpr int FS = 3;              // ring stages
constexpr int OFF_FBAR = FS * FSTAGE;
constexpr int FSMEM = OFF_FBAR + 8 * 2 * FS + 1024;   // + slack to align the base
constexpr int FGROUP = 8;          // query tiles a group of blocks takes (L2 reuse)
constexpr int FWD_D_MAX = hp::RANKS_MAX * hp::NC_MAX * 64;   // 8192, as the bf16 forward
static_assert(FSMEM <= 232448, "shared memory over the 227 KB a block may use");
static_assert(FBOX % 1024 == 0 && FSTAGE % 1024 == 0, "1 KB aligned boxes");

// Block b's (query tile, passage tile): groups of FGROUP query tiles, each
// group walking every passage tile with its query tiles innermost, so the
// blocks that run at once share a few tiles of each operand in L2
// (tests/test_torch_fused_infonce.py mirrors it).
__device__ __forceinline__ void fwd_tile(int b, int q_tiles, int p_tiles, int& qt, int& pt) {
  const int per_group = FGROUP * p_tiles, first = b / per_group * FGROUP;
  const int size = min(q_tiles - first, FGROUP), r = b % per_group;
  qt = first + r % size;
  pt = r / size;
}

__global__ void __launch_bounds__(BLOCK, 1)
infonce_tf32x3_fwd_kernel(const __grid_constant__ CUtensorMap qhi,
                          const __grid_constant__ CUtensorMap qlo,
                          const __grid_constant__ CUtensorMap phi,
                          const __grid_constant__ CUtensorMap plo, const int* __restrict__ labels,
                          const uint8_t* __restrict__ col_valid, float* __restrict__ part, int M,
                          int N, int d, float inv_tau) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hp::aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int q_tiles = (M + FQ - 1) / FQ, tiles = (N + FP - 1) / FP;
  int qt, tile;
  fwd_tile(int(blockIdx.x), q_tiles, tiles, qt, tile);
  const int q0 = qt * FQ, n0 = tile * FP;
  // warpgroup w, warp v in it; g = lane / 4, t4 = lane % 4
  const int tid = threadIdx.x, w = tid / 128, v = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  const int any = tid < FP && hp::passage_valid(col_valid, n0 + tid, N);
  if (!__syncthreads_or(any)) {
    hp::masked_partials(part, labels, tiles, tile, n0, N, M, q0, min(M, q0 + FQ), BLOCK, FP);
    return;
  }

  const uint32_t full0 = base + OFF_FBAR, empty0 = full0 + 8u * FS;
  const int nc = (d + 31) / 32;
  auto load = [&](int c) {   // chunk c into its stage; columns past d and rows past M or N are TMA's zeros
    const uint32_t st = base + (c % FS) * FSTAGE, bar = full0 + 8u * (c % FS);
    mbar_expect_tx(bar, FSTAGE);
    tma_load_2d(&qhi, st, bar, 32 * c, q0);
    tma_load_2d(&qlo, st + FBOX, bar, 32 * c, q0);
    tma_load_2d(&phi, st + 2 * FBOX, bar, 32 * c, n0);
    tma_load_2d(&plo, st + 3 * FBOX, bar, 32 * c, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < FS; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, 8);   // one arrival a warp of both warpgroups
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    prefetch_tensormap(&qhi);
    prefetch_tensormap(&qlo);
    prefetch_tensormap(&phi);
    prefetch_tensormap(&plo);
    for (int c = 0; c < min(nc, FS); ++c) load(c);
  }
  // this warp is done with chunk c's stage
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8u * (c % FS));
  };

  if (q0 + 64 * w >= M) {   // no row of this warpgroup: release each stage once it is full
    for (int c = 0; c < nc; ++c) {
      mbar_wait(full0 + 8u * (c % FS), (c / FS) & 1);
      release(c);
    }
    return;
  }

  // register 4 i + 2 h + e of S: query row q0 + 64 w + 16 v + g + 8 h,
  // passage n0 + 8 i + 2 t4 + e (raw: not yet times inv_tau)
  float S[64], c0[64], c1[64];
  zero(S);
  const uint32_t qoff = w * 64 * 128;   // this warpgroup's 64 rows of a q box
  for (int c = 0; c < nc; ++c) {
    const uint32_t st = base + (c % FS) * FSTAGE;
    mbar_wait(full0 + 8u * (c % FS), (c / FS) & 1);
    fence_regs<64>(c0);
    wgmma_fence();
    score_half<FP>(c0, st + qoff, st + FBOX + qoff, st + 2 * FBOX, st + 3 * FBOX, 0);
    wgmma_commit();
    fence_regs<64>(c1);
    wgmma_fence();
    score_half<FP>(c1, st + qoff, st + FBOX + qoff, st + 2 * FBOX, st + 3 * FBOX, 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<64>(c0);
    add_away(S, c0);
    wgmma_wait<0>();
    fence_regs<64>(c1);
    add_away(S, c1);
    release(c);
    if (tid == 0 && c >= 1 && c - 1 + FS < nc) {   // chunk c - 1's stage takes chunk c - 1 + FS
      mbar_wait(empty0 + 8u * ((c - 1) % FS), ((c - 1) / FS) & 1);
      load(c - 1 + FS);
    }
  }
  grid_dependents_launch();   // the merge may start: it waits for this grid's end

  // the statistics of this thread's two rows over the valid passages, each
  // over the row's 4 threads (lanes 4 g .. 4 g + 3): the max of s = raw
  // inv_tau, the sum of exp(s - max), and s at the label (-1e30 on a
  // masked passage)
  uint32_t ok = 0;   // bit 2 i + e: passage n0 + 8 i + 2 t4 + e valid
#pragma unroll
  for (int j = 0; j < 32; ++j)
    ok |= uint32_t(hp::passage_valid(col_valid, n0 + 8 * (j / 2) + 2 * t4 + j % 2, N)) << j;
  const size_t plane = size_t(tiles) * M;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * w + 16 * v + g + 8 * h;
    const int l = r < M ? labels[r] : -1;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx = fmaxf(mx, (ok >> j) & 1 ? S[4 * (j / 2) + 2 * h + j % 2] * inv_tau : NEG_INF);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float se = 0.f, ps = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool valid = (ok >> j) & 1;
      const float s = S[4 * (j / 2) + 2 * h + j % 2] * inv_tau;
      se += valid ? expf(s - mx) : 0.f;
      if (n0 + 8 * (j / 2) + 2 * t4 + j % 2 == l) ps = valid ? s : NEG_INF;
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    }
    if (t4 == 0 && r < M) {
      const size_t at = size_t(r) * tiles + tile;
      part[at] = mx;
      part[plane + at] = se;
      part[2 * plane + at] = l >= n0 && l < min(n0 + FP, N) ? ps : 0.f;
    }
  }
}

// Rank-2 fp32 tensor map over a row-major (rows, cols) plane, boxes of 32
// columns x box_rows (128-byte swizzled, zero past each edge)
cudaError_t map2d_f32(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 4};
  const cuuint32_t box[2] = {32, cuuint32_t(box_rows)};
  return tensor_map<2>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides, box);
}

cudaError_t split(const void* src, float* planes, size_t n, cudaStream_t st) {
  const size_t n4 = n / 4, blocks = (n4 + 255) / 256;
  infonce_tf32_split_kernel<<<unsigned(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(
      static_cast<const float4*>(src), reinterpret_cast<uint4*>(planes),
      reinterpret_cast<uint4*>(planes + n), n4);
  return cudaGetLastError();
}

template <bool DQ> struct Tag {};

// dQ (DQ) or dP of fp32 operands (q (M, d), p (N, d) row-major, 16-byte
// aligned bases, d a multiple of 4 up to D_MAX): q and p split into their hi
// and lo planes (qs (2, M, d), ps (2, N, d) scratch), then clusters of
// `ranks` blocks (ranks x NCH x 32 >= d) on (X tiles x splits); splits > 1
// writes the partials (splits, X rows, d) and sums them into out (X rows, d)
// fp32.
template <bool DQ>
cudaError_t grad(const void* q, const void* p, const int* labels, const uint8_t* col_valid,
                 const float* lse, const float* g_lse, const float* g_pos, float* out,
                 float* partial, float* qs, float* ps, int M, int N, int d, int ranks, int splits,
                 int per, float inv_tau, cudaStream_t st) {
  const int x_rows = DQ ? M : N, y_rows = DQ ? N : M;
  const int y_steps = (y_rows + YT - 1) / YT;
  if (d % 4 || d > D_MAX || ranks < 1 || ranks > hp::RANKS_MAX || ranks * NCH * 32 < d ||
      (ranks - 1) * NCH * 32 >= d || splits < 1 || per < 1 || splits * per < y_steps ||
      (splits - 1) * per >= y_steps)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = split(q, qs, size_t(M) * d, st)) != cudaSuccess ||
      (err = split(p, ps, size_t(N) * d, st)) != cudaSuccess)
    return err;
  const float* xs = DQ ? qs : ps;
  const float* ys = DQ ? ps : qs;
  CUtensorMap mxh, mxl, myh, myl;
  if ((err = map2d_f32(&mxh, xs, d, x_rows, XT)) != cudaSuccess ||
      (err = map2d_f32(&mxl, xs + size_t(x_rows) * d, d, x_rows, XT)) != cudaSuccess ||
      (err = map2d_f32(&myh, ys, d, y_rows, YT)) != cudaSuccess ||
      (err = map2d_f32(&myl, ys + size_t(y_rows) * d, d, y_rows, YT)) != cudaSuccess)
    return err;
  const auto kernel = infonce_tf32x3_kernel<DQ>;
  if ((err = allow_smem_once<Tag<DQ>>(reinterpret_cast<const void*>(kernel), SMEM)) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = hp::cluster_config((x_rows + XT - 1) / XT * splits, ranks, BLOCK,
                                                    SMEM, st, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, mxh, mxl, myh, myl, labels, col_valid, lse, g_lse, g_pos,
                           splits > 1 ? partial : out, M, N, d, splits, per, inv_tau);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const size_t total = size_t(x_rows) * d;
  infonce_grad_reduce_kernel<float><<<reduce_blocks(total), THREADS, 0, st>>>(partial, out, total,
                                                                             splits);
  return cudaGetLastError();
}

// The most clusters of `ranks` blocks of the dQ (DQ) or dP kernel the current
// device runs at once (negative: a CUDA error code).
template <bool DQ>
int max_clusters(int ranks) {
  const auto kernel = infonce_tf32x3_kernel<DQ>;
  cudaError_t err = allow_smem_once<Tag<DQ>>(reinterpret_cast<const void*>(kernel), SMEM);
  if (err != cudaSuccess) return -int(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = hp::cluster_config(1, ranks, BLOCK, SMEM, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? n : -int(err);
}

struct FwdTag {};

// The fp32 forward (q (M, d), p (N, d) row-major, 16-byte aligned bases, d
// a multiple of 4 up to FWD_D_MAX): q and p split into their hi and lo
// planes (qs (2, M, d), ps (2, N, d) scratch), the tiles' partials into
// part (3, M, tiles of FP passages), merged into lse, pos and amax by
// infonce_stats_merge_kernel.
cudaError_t fwd(const void* q, const void* p, const int* labels, const uint8_t* col_valid,
                float* lse, float* pos, float* amax, float* part, float* qs, float* ps, int M,
                int N, int d, float inv_tau, cudaStream_t st) {
  if (d % 4 || d < 4 || d > FWD_D_MAX || M < 1 || N < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = split(q, qs, size_t(M) * d, st)) != cudaSuccess ||
      (err = split(p, ps, size_t(N) * d, st)) != cudaSuccess)
    return err;
  CUtensorMap mqh, mql, mph, mpl;
  if ((err = map2d_f32(&mqh, qs, d, M, FQ)) != cudaSuccess ||
      (err = map2d_f32(&mql, qs + size_t(M) * d, d, M, FQ)) != cudaSuccess ||
      (err = map2d_f32(&mph, ps, d, N, FP)) != cudaSuccess ||
      (err = map2d_f32(&mpl, ps + size_t(N) * d, d, N, FP)) != cudaSuccess)
    return err;
  if ((err = allow_smem_once<FwdTag>(reinterpret_cast<const void*>(infonce_tf32x3_fwd_kernel),
                                     FSMEM)) != cudaSuccess)
    return err;
  const int tiles = (N + FP - 1) / FP;
  infonce_tf32x3_fwd_kernel<<<(M + FQ - 1) / FQ * tiles, BLOCK, FSMEM, st>>>(
      mqh, mql, mph, mpl, labels, col_valid, part, M, N, d, inv_tau);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_stats_merge(part, lse, pos, amax, M, tiles, st);
}

}  // namespace tx

}  // namespace

extern "C" {

int fused_infonce_block_m() { return BM; }
int fused_infonce_block_n() { return BN; }
int fused_infonce_split_tiles() { return SPLIT_TILES; }

// dtype: 0 = fp32, 1 = bf16 (q and p alike). labels: int32 (M,).
// col_valid: uint8 (N,) or null. lse/pos/amax: fp32 (M,).
// part: fp32 (3, M, splits) scratch, unused when splits == 1.
int fused_infonce_fwd_launch(const void* q, const void* p, const void* labels,
                             const void* col_valid, void* lse, void* pos,
                             void* amax, void* part, int M, int N, int d,
                             int splits, int tiles_per_split, float inv_tau,
                             int dtype, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(q, p, labels, col_valid, lse, pos, amax, part, M,
                              N, d, splits, tiles_per_split, inv_tau, vec, st);
  if (dtype == 0)
    return fwd<float>(q, p, labels, col_valid, lse, pos, amax, part, M, N, d,
                      splits, tiles_per_split, inv_tau, vec, st);
  return int(cudaErrorInvalidValue);
}

// The bf16 forward on Hopper (q and p row-major, 16-byte aligned bases, d a
// multiple of 8). M up to 16: ranks 1 takes infonce_fwd_small_kernel (d up
// to 1024), ranks 2-8 infonce_fwd_split_kernel in clusters of `ranks`
// blocks, each on at most 16 of the d-chunks (ops.small_ranks); rq unused.
// Else infonce_fwd_rows_kernel in row groups of rq rows (a multiple of 256;
// ops.fwd_plan) at any d; ranks unused. part: fp32 (3, M, (N + 63) / 64)
// scratch.
int fused_infonce_fwd_hopper_launch(const void* q, const void* p, const void* labels,
                                    const void* col_valid, void* lse, void* pos, void* amax,
                                    void* part, int M, int N, int d, int rq, int ranks,
                                    float inv_tau, void* stream) {
  return int(hp::fwd_tiles(q, p, static_cast<const int*>(labels),
                           static_cast<const uint8_t*>(col_valid), static_cast<float*>(lse),
                           static_cast<float*>(pos), static_cast<float*>(amax),
                           static_cast<float*>(part), M, N, d, rq, ranks, inv_tau,
                           static_cast<cudaStream_t>(stream)));
}

// out: dq (M, d) in the operand type. partial: fp32 (splits, M, d) scratch,
// unused when splits == 1. Splits run over column tiles.
int fused_infonce_dq_launch(const void* q, const void* p, const void* labels,
                            const void* col_valid, const void* lse,
                            const void* g_lse, const void* g_pos, void* out,
                            void* partial, int M, int N, int d, int splits,
                            int tiles_per_split, float inv_tau, int dtype,
                            int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return grad<__nv_bfloat16, false>(q, p, labels, col_valid, lse, g_lse, g_pos,
                                      out, partial, M, N, d, splits,
                                      tiles_per_split, inv_tau, vec, st);
  if (dtype == 0)
    return grad<float, false>(q, p, labels, col_valid, lse, g_lse, g_pos, out,
                              partial, M, N, d, splits, tiles_per_split, inv_tau,
                              vec, st);
  return int(cudaErrorInvalidValue);
}

// out: dp (N, d) in the operand type. partial: fp32 (splits, N, d) scratch,
// unused when splits == 1. Splits run over row tiles.
int fused_infonce_dp_launch(const void* q, const void* p, const void* labels,
                            const void* col_valid, const void* lse,
                            const void* g_lse, const void* g_pos, void* out,
                            void* partial, int M, int N, int d, int splits,
                            int tiles_per_split, float inv_tau, int dtype,
                            int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return grad<__nv_bfloat16, true>(q, p, labels, col_valid, lse, g_lse, g_pos,
                                     out, partial, M, N, d, splits,
                                     tiles_per_split, inv_tau, vec, st);
  if (dtype == 0)
    return grad<float, true>(q, p, labels, col_valid, lse, g_lse, g_pos, out,
                             partial, M, N, d, splits, tiles_per_split, inv_tau,
                             vec, st);
  return int(cudaErrorInvalidValue);
}

// The Hopper dP, bf16 only (q and p row-major, 16-byte aligned bases, d a
// multiple of 8). M up to 16: ranks 1 takes the small kernel (d up to
// 1024; rq unused), ranks 2-8 infonce_dp_split_kernel in clusters of
// `ranks` blocks, each on at most 16 of the d-chunks (ops.small_ranks).
// Else infonce_dp_cluster_kernel in clusters of `ranks` blocks, rank r
// holding the coefficients of query rows [r rq, (r + 1) rq) (rq a multiple
// of TQ (256), at most RQ_MAX (768), ranks at most 8; ops.dp_plan), at any
// d. out: dp (N, d) bf16.
int fused_infonce_dp_hopper_launch(const void* q, const void* p, const void* labels,
                                   const void* col_valid, const void* lse, const void* g_lse,
                                   const void* g_pos, void* out, int M, int N, int d, int ranks,
                                   int rq, float inv_tau, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto lab = static_cast<const int*>(labels);
  const auto valid = static_cast<const uint8_t*>(col_valid);
  const auto l = static_cast<const float*>(lse), gl = static_cast<const float*>(g_lse),
             gp = static_cast<const float*>(g_pos);
  if (M <= hp::SQ)
    return int(hp::small<false>(q, p, lab, valid, l, gl, gp, out, M, N, d, ranks, inv_tau, st));
  return int(hp::dp_cluster(q, p, lab, valid, l, gl, gp, out, M, N, d, ranks, rq, inv_tau, st));
}

// dQ at M up to 16: the small kernel (ranks 1, d up to 1024) or
// infonce_dq_split_kernel (clusters of `ranks` blocks, each rank writing its
// columns; ops.small_ranks) writes one fp32 partial (M, d) per 64 passages
// into `partial` ((N + 63) / 64, M, d), then the reduce kernel sums them in
// block order into out (M, d) bf16.
int fused_infonce_dq_hopper_launch(const void* q, const void* p, const void* labels,
                                   const void* col_valid, const void* lse, const void* g_lse,
                                   const void* g_pos, void* out, void* partial, int M, int N,
                                   int d, int ranks, float inv_tau, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = hp::small<true>(
      q, p, static_cast<const int*>(labels), static_cast<const uint8_t*>(col_valid),
      static_cast<const float*>(lse), static_cast<const float*>(g_lse),
      static_cast<const float*>(g_pos), partial, M, N, d, ranks, inv_tau, st);
  if (err != cudaSuccess) return int(err);
  const size_t total = size_t(M) * d;
  infonce_grad_reduce_kernel<__nv_bfloat16><<<reduce_blocks(total), THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), total,
      (N + hp::PB - 1) / hp::PB);
  return int(cudaGetLastError());
}

// fp32 dQ (dq 1) or dP (dq 0) on the 3xTF32 kernels (q and p row-major fp32,
// 16-byte aligned bases, d a multiple of 4 up to 1536): q and p split into
// hi and lo planes (q_planes (2, M, d), p_planes (2, N, d) fp32 scratch),
// then clusters of `ranks` blocks (ops.tf32x3_ranks) on each tile of 64
// output rows x `splits` ranges of `per` steps of 32 contraction rows
// (ops.tf32x3_split_plan). out: fp32 (M, d) for dQ, (N, d) for dP; partial:
// fp32 (splits, rows, d) scratch, unused when splits == 1.
int fused_infonce_tf32x3_launch(int dq, const void* q, const void* p, const void* labels,
                                const void* col_valid, const void* lse, const void* g_lse,
                                const void* g_pos, void* out, void* partial, void* q_planes,
                                void* p_planes, int M, int N, int d, int ranks, int splits,
                                int per, float inv_tau, void* stream) {
  const auto lab = static_cast<const int*>(labels);
  const auto valid = static_cast<const uint8_t*>(col_valid);
  const auto l = static_cast<const float*>(lse), gl = static_cast<const float*>(g_lse),
             gp = static_cast<const float*>(g_pos);
  const auto o = static_cast<float*>(out), part = static_cast<float*>(partial);
  const auto qs = static_cast<float*>(q_planes), ps = static_cast<float*>(p_planes);
  const auto st = static_cast<cudaStream_t>(stream);
  return int(dq ? tx::grad<true>(q, p, lab, valid, l, gl, gp, o, part, qs, ps, M, N, d, ranks,
                                 splits, per, inv_tau, st)
                : tx::grad<false>(q, p, lab, valid, l, gl, gp, o, part, qs, ps, M, N, d, ranks,
                                  splits, per, inv_tau, st));
}

// The fp32 forward on 3xTF32 (q and p row-major fp32, 16-byte aligned
// bases, d a multiple of 4 up to 8192): q and p split into hi and lo planes
// (q_planes (2, M, d), p_planes (2, N, d) fp32 scratch), then a block per
// tile of 128 query rows x 128 passages writes its rows' partials into
// part (3, M, (N + 127) / 128) fp32 scratch, merged into lse, pos and amax
// (M,) fp32.
int fused_infonce_fwd_tf32x3_launch(const void* q, const void* p, const void* labels,
                                    const void* col_valid, void* lse, void* pos, void* amax,
                                    void* part, void* q_planes, void* p_planes, int M, int N,
                                    int d, float inv_tau, void* stream) {
  return int(tx::fwd(q, p, static_cast<const int*>(labels), static_cast<const uint8_t*>(col_valid),
                     static_cast<float*>(lse), static_cast<float*>(pos), static_cast<float*>(amax),
                     static_cast<float*>(part), static_cast<float*>(q_planes),
                     static_cast<float*>(p_planes), M, N, d, inv_tau,
                     static_cast<cudaStream_t>(stream)));
}

// The 3xTF32 forward's plan: query rows and passages a block, query tiles a
// group of blocks, its dynamic shared memory, the widest row it takes.
int fused_infonce_tf32x3_fwd_rows() { return tx::FQ; }
int fused_infonce_tf32x3_fwd_passages() { return tx::FP; }
int fused_infonce_tf32x3_fwd_group() { return tx::FGROUP; }
int fused_infonce_tf32x3_fwd_smem() { return tx::FSMEM; }
int fused_infonce_tf32x3_fwd_d_max() { return tx::FWD_D_MAX; }

// The most clusters of `ranks` blocks of the 3xTF32 dQ (dq 1) or dP kernel
// the current device runs at once (negative: a CUDA error code).
int fused_infonce_tf32x3_max_clusters(int dq, int ranks) {
  return dq ? tx::max_clusters<true>(ranks) : tx::max_clusters<false>(ranks);
}

// Rows of the 3xTF32 kernels' output tile and of their contraction step,
// and the columns of d one rank holds.
int fused_infonce_tf32x3_tile() { return tx::XT; }
int fused_infonce_tf32x3_step() { return tx::YT; }
int fused_infonce_tf32x3_rank_cols() { return tx::NCH * 32; }
// The dynamic shared memory a 3xTF32 block asks for (ops.tf32x3_smem mirrors it).
int fused_infonce_tf32x3_smem() { return tx::SMEM; }

// The most clusters of `ranks` infonce_dp_cluster_kernel blocks the current
// device runs at once (negative: a CUDA error code).
int fused_infonce_dp_max_clusters(int ranks) {
  cudaError_t err =
      hopper::allow_smem_once<hp::ClusterTag>(
          reinterpret_cast<const void*>(hp::infonce_dp_cluster_kernel), hp::SMEM_CLUSTER);
  if (err != cudaSuccess) return -int(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      hp::cluster_config(1, ranks, hp::CLUSTER_THREADS, hp::SMEM_CLUSTER, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(hp::infonce_dp_cluster_kernel), &cfg);
  return err == cudaSuccess ? n : -int(err);
}

// Registers a thread and local memory a thread (stack frame and spills) of
// kernel `which`, in ops.KERNELS' order.
int fused_infonce_kernel_attributes(int which, int* regs, int* local) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(infonce_fwd_kernel<__nv_bfloat16>),
      reinterpret_cast<const void*>(infonce_fwd_kernel<float>),
      reinterpret_cast<const void*>(infonce_stats_merge_kernel),
      reinterpret_cast<const void*>(infonce_dq_kernel<__nv_bfloat16>),
      reinterpret_cast<const void*>(infonce_dq_kernel<float>),
      reinterpret_cast<const void*>(infonce_dp_kernel<__nv_bfloat16>),
      reinterpret_cast<const void*>(infonce_dp_kernel<float>),
      reinterpret_cast<const void*>(infonce_grad_reduce_kernel<__nv_bfloat16>),
      reinterpret_cast<const void*>(infonce_grad_reduce_kernel<float>),
      reinterpret_cast<const void*>(hp::infonce_dp_cluster_kernel),
      reinterpret_cast<const void*>(hp::infonce_small_kernel<true>),
      reinterpret_cast<const void*>(hp::infonce_small_kernel<false>),
      reinterpret_cast<const void*>(hp::infonce_fwd_small_kernel),
      reinterpret_cast<const void*>(hp::infonce_fwd_rows_kernel),
      reinterpret_cast<const void*>(tx::infonce_tf32x3_kernel<true>),
      reinterpret_cast<const void*>(tx::infonce_tf32x3_kernel<false>),
      reinterpret_cast<const void*>(tx::infonce_tf32_split_kernel),
      reinterpret_cast<const void*>(tx::infonce_tf32x3_fwd_kernel),
      reinterpret_cast<const void*>(hp::infonce_dp_split_kernel),
      reinterpret_cast<const void*>(hp::infonce_fwd_split_kernel),
      reinterpret_cast<const void*>(hp::infonce_dq_split_kernel),
  };
  if (which < 0 || which >= int(sizeof(kernels) / sizeof(kernels[0])))
    return int(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernels[which]);
  if (err != cudaSuccess) return int(err);
  *regs = a.numRegs;
  *local = int(a.localSizeBytes);
  return 0;
}

const char* fused_infonce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
