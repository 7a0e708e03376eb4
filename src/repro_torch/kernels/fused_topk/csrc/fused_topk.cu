// Fused QK^T + exact top-k for Hopper (sm_90a): the search kernel of the
// retriever.
//
// Replaces the TPU kernel src/repro/kernels/fused_topk/fused_topk.py
// (_topk_kernel, reached through fused_topk / ops.fused_topk_scores). Same
// contract: for each query row, the k best of s = (q . p_n) * inv_tau over
// the valid columns n, scores fp32 (products accumulated in fp32), ids int32,
// order (score descending, id ascending) so ties go to the lowest id, and
// slots with no valid candidate come back as (-1e30, -1).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), bf16, d=768,
// N=2^20 index rows:
//   eval_topk  (Q=2048): 2*Q*N*d = 3.3e12 FLOP -> ~3.3 ms, compute-bound;
//   serve_topk (Q=32):   the 1.5 GiB index is read once -> ~0.48 ms,
//                        bandwidth-bound (0.05e12 FLOP is ~0.05 ms).
// The design reads every index row once from device memory and never writes
// the (Q, N) score matrix: each block computes its 64 x 128 score tiles on the
// tensor cores (wmma, bf16 in, fp32 accumulate; fp32 inputs take a CUDA-core
// FMA loop so that they are not rounded to TF32) and folds each tile into a
// per-row top-k held in shared memory. The next d-chunk's loads are issued
// into registers before the current chunk is multiplied, so memory latency
// overlaps tensor-core work. What it does not do yet: a multi-stage
// cp.async/TMA ring, wgmma, or more than one block per SM (the row states
// take 128 KB), so it sits well above both bounds.
//
// Two passes, because blocks run in parallel and carry nothing between them
// (the Pallas kernel carries its running top-k along a sequential grid axis):
//   1. topk_split_kernel, grid (query tiles x column splits): each block keeps
//      the best kp entries per row of its column range and writes the first
//      k to a (Q, splits, k) candidate buffer.
//   2. topk_merge_kernel, one warp per row: folds the row's splits sorted
//      lists into the final k, reading each list only while it still wins.
// Both keep a row's state as 2*kp (score, id) pairs: the sorted best kp,
// then an unsorted buffer of offers that beat the current k-th best. A full
// buffer is merged by a bitonic sort of all 2*kp pairs. The order is total,
// so the result does not depend on the split or on the order in which
// candidates arrive.
//
// k <= KPAD (128) keeps kp = KPAD and the states in shared memory. Any
// larger k (up to N and past it, as the Pallas kernel takes) takes kp = the
// next power of two >= k, and the same two passes keep the states in a
// global scratch buffer that ops.py allocates: each split block owns BQ row
// states of 2*kp pairs, and the merge pass reuses the first Q of them. The
// states stay hot in L1/L2 (each is touched by one warp). Up to kp =
// STAGE_KP a full buffer is sorted in a per-warp staging area of shared
// memory (8 warps x 2*kp pairs, 128 KB at kp = 1024) and the sorted best kp
// written back; past it the bitonic stages run on the global state itself.
// The k <= 128 path is unchanged.
//
// Plain C interface for ctypes: every pointer and the stream are void*, the
// launch returns cudaGetLastError(). The kernels allocate nothing and do not
// synchronise; ops.py allocates outputs and scratch with torch.empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KPAD = 128;          // largest k held in shared memory
constexpr int STAGE_KP = 1024;     // largest kp sorted in shared staging
constexpr int BQ = 64;             // query rows per block
constexpr int BN = 128;            // index rows (score columns) per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLD = BN + 4;        // score tile row stride, floats

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 64;      // d-chunk; d=768 does not fit whole
  static constexpr int LD = BK + 8;  // row stride: 16-byte rows, skewed banks
};
template <> struct Tile<float> {
  static constexpr int BK = 32;
  static constexpr int LD = BK + 1;  // odd stride: conflict-free column reads
};

// KPF: kp fixed at compile time (KPAD: states in shared memory), or 0 (kp
// given at run time: states in global scratch).
template <typename T, int KPF>
constexpr size_t split_smem_bytes() {
  return size_t(BQ + BN) * Tile<T>::LD * sizeof(T)   // q and p chunks
         + size_t(BQ) * SLD * sizeof(float)           // score tile
         + size_t(BQ) * 2 * KPF * (sizeof(float) + sizeof(int))  // row states
         + size_t(BQ) * sizeof(int);                  // buffer counts
}

// The per-warp sort staging of the global-state path: 2*kp pairs a warp,
// scores then ids; none past STAGE_KP.
__host__ __device__ constexpr size_t stage_bytes(int kp) {
  return kp <= STAGE_KP ? size_t(WARPS) * 2 * kp * (sizeof(float) + sizeof(int)) : 0;
}

__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Bitonic sort of one row's 2*kp pairs, best first, by one warp. The
// helpers below take kp = KPF, or kp_rt when KPF is 0.
template <int KPF>
__device__ void warp_sort_row(float* rs, int* ri, int lane, int kp_rt) {
  const int kp = KPF ? KPF : kp_rt;
  for (int size = 2; size <= 2 * kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < kp; t += 32) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const float si = rs[i], sj = rs[j];
        const int ii = ri[i], ij = ri[j];
        const bool swap = (i & size) == 0 ? better(sj, ij, si, ii)
                                          : better(si, ii, sj, ij);
        if (swap) {
          rs[i] = sj; rs[j] = si;
          ri[i] = ij; ri[j] = ii;
        }
      }
      __syncwarp();
    }
  }
}

// Folds the cnt buffered offers into the sorted best. A global row state
// with a staging area (sort_s/sort_i, this warp's 2*kp pairs of shared
// memory) is sorted there and its best kp written back; the buffer behind
// them is refilled from 0, so it is not.
template <int KPF>
__device__ void warp_merge(float* rs, int* ri, int cnt, int lane, int kp_rt,
                           float* sort_s, int* sort_i) {
  const int kp = KPF ? KPF : kp_rt;
  if (KPF == 0 && sort_s != nullptr) {
    for (int t = lane; t < 2 * kp; t += 32) {
      const bool live = t < kp + cnt;
      sort_s[t] = live ? rs[t] : NEG_INF;
      sort_i[t] = live ? ri[t] : -1;
    }
    __syncwarp();
    warp_sort_row<KPF>(sort_s, sort_i, lane, kp);
    for (int t = lane; t < kp; t += 32) {
      rs[t] = sort_s[t];
      ri[t] = sort_i[t];
    }
    __syncwarp();
    return;
  }
  for (int t = kp + cnt + lane; t < 2 * kp; t += 32) {
    rs[t] = NEG_INF;
    ri[t] = -1;
  }
  __syncwarp();
  warp_sort_row<KPF>(rs, ri, lane, kp);
}

// Each lane offers one candidate to the row; those that beat the current
// k-th best enter the buffer. Returns the new (warp-uniform) buffer count;
// `taken` says whether this lane's candidate entered.
template <int KPF>
__device__ int warp_offer(float* rs, int* ri, int cnt, int k, float s, int id,
                          bool ok, int lane, bool& taken, int kp_rt,
                          float* sort_s, int* sort_i) {
  const int kp = KPF ? KPF : kp_rt;
  bool want = ok && better(s, id, rs[k - 1], ri[k - 1]);
  unsigned m = __ballot_sync(0xffffffffu, want);
  taken = want;
  if (m == 0) return cnt;
  if (cnt + __popc(m) > kp) {
    warp_merge<KPF>(rs, ri, cnt, lane, kp, sort_s, sort_i);
    cnt = 0;
    want = ok && better(s, id, rs[k - 1], ri[k - 1]);
    m = __ballot_sync(0xffffffffu, want);
    taken = want;
  }
  if (want) {
    const int pos = kp + cnt + __popc(m & ((1u << lane) - 1u));
    rs[pos] = s;
    ri[pos] = id;
  }
  __syncwarp();
  return cnt + __popc(m);
}

// One d-chunk (ROWS x BK) of a row-major (rows_total, d) matrix in registers,
// 16 bytes a load, zero past either edge. Needs d a multiple of 16 bytes'
// worth of T and a 16-byte aligned base. fetch() issues the loads; store()
// writes them to shared memory, so a chunk's loads can be in flight while
// the tensor cores work on the previous one.
template <typename T, int ROWS>
struct Stage {
  static constexpr int BK = Tile<T>::BK, LD = Tile<T>::LD;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = BK / VEC;
  static constexpr int COUNT = ROWS * PER_ROW / THREADS;
  static_assert(ROWS * PER_ROW % THREADS == 0, "chunk must split evenly");
  uint4 v[COUNT];

  __device__ __forceinline__ void fetch(const T* __restrict__ src,
                                        int rows_total, int row0, int d,
                                        int k0) {
#pragma unroll
    for (int x = 0; x < COUNT; ++x) {
      const int t = threadIdx.x + x * THREADS;
      const int gr = row0 + t / PER_ROW, gc = k0 + (t % PER_ROW) * VEC;
      v[x] = (gr < rows_total && gc < d)
                 ? __ldg(reinterpret_cast<const uint4*>(src + size_t(gr) * d + gc))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int x = 0; x < COUNT; ++x) {
      const int t = threadIdx.x + x * THREADS;
      const int r = t / PER_ROW, c = (t % PER_ROW) * VEC;
      if constexpr ((LD * sizeof(T)) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst + r * LD + c) = v[x];
      } else {
        const T* e = reinterpret_cast<const T*>(&v[x]);
#pragma unroll
        for (int y = 0; y < VEC; ++y) dst[r * LD + c + y] = e[y];
      }
    }
  }
};

// The same chunk copied element by element, for any d and alignment.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, T* dst,
                                           int rows_total, int row0, int nrows,
                                           int d, int k0) {
  constexpr int BK = Tile<T>::BK, LD = Tile<T>::LD;
  for (int t = threadIdx.x; t < nrows * BK; t += THREADS) {
    const int r = t / BK, c = t % BK;
    const int gr = row0 + r, gc = k0 + c;
    dst[r * LD + c] = (gr < rows_total && gc < d) ? src[size_t(gr) * d + gc]
                                                  : zero_val<T>();
  }
}

// Score accumulator of a BQ x BN tile. bf16: tensor cores, 2 x 4 warps of
// 32 x 32, fp32 accumulate. fp32: CUDA-core FMAs (the tensor cores would
// round the inputs to TF32); each of 16 x 16 threads owns rows ty + 16i,
// columns tx + 16j.
template <typename T> struct Acc;

template <> struct Acc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int BK = Tile<T>::BK, LD = Tile<T>::LD;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(f[i][j], 0.f);
  }

  __device__ __forceinline__ void mma(const T* q_s, const T* p_s) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, wr = warp / 4, wc = warp % 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], q_s + (wr * 32 + i * 16) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], p_s + (wc * 32 + j * 16) * LD + kk, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(f[i][j], a[i], b[j], f[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* score_s) const {
    const int warp = threadIdx.x >> 5, wr = warp / 4, wc = warp % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(
            score_s + (wr * 32 + i * 16) * SLD + wc * 32 + j * 16, f[i][j], SLD,
            nvcuda::wmma::mem_row_major);
  }
};

template <> struct Acc<float> {
  static constexpr int BK = Tile<float>::BK, LD = Tile<float>::LD;
  float a[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* q_s, const float* p_s) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = q_s[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = p_s[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* score_s) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) score_s[(ty + 16 * i) * SLD + tx + 16 * j] = a[i][j];
  }
};

// Score tile (BQ x BN, fp32, unscaled) of query rows q0.. against index rows
// n0.., left in score_s. Opens and closes with a block barrier.
template <typename T>
__device__ void score_tile(const T* __restrict__ q, const T* __restrict__ p,
                           T* q_s, T* p_s, float* score_s, int Q, int N, int d,
                           int q0, int n0, bool vec) {
  constexpr int BK = Tile<T>::BK;
  Acc<T> acc;
  acc.zero();
  if (vec) {
    Stage<T, BQ> sq;
    Stage<T, BN> sp;
    sq.fetch(q, Q, q0, d, 0);
    sp.fetch(p, N, n0, d, 0);
    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();
      sq.store(q_s);
      sp.store(p_s);
      __syncthreads();
      if (k0 + BK < d) {  // next chunk's loads fly while this one multiplies
        sq.fetch(q, Q, q0, d, k0 + BK);
        sp.fetch(p, N, n0, d, k0 + BK);
      }
      acc.mma(q_s, p_s);
    }
  } else {
    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();
      load_chunk(q, q_s, Q, q0, BQ, d, k0);
      load_chunk(p, p_s, N, n0, BN, d, k0);
      __syncthreads();
      acc.mma(q_s, p_s);
    }
  }
  acc.store(score_s);
  __syncthreads();
}

template <typename T, int KPF>
__global__ void __launch_bounds__(THREADS)
topk_split_kernel(const T* __restrict__ q, const T* __restrict__ p,
                  const uint8_t* __restrict__ col_valid,
                  float* __restrict__ cand_s, int* __restrict__ cand_i, int Q,
                  int N, int d, int k, int cols_per_split, float inv_tau,
                  int vec, float* __restrict__ state_s,
                  int* __restrict__ state_i, int kp_rt) {
  constexpr int LD = Tile<T>::LD;
  const int kp = KPF ? KPF : kp_rt;
  const size_t row_len = 2 * size_t(kp);
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* p_s = q_s + BQ * LD;
  float* score_s = reinterpret_cast<float*>(p_s + BN * LD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* row_s;
  int* row_i;
  int* row_cnt;
  float* sort_s = nullptr;
  int* sort_i = nullptr;
  if constexpr (KPF != 0) {
    row_s = score_s + BQ * SLD;
    row_i = reinterpret_cast<int*>(row_s + BQ * row_len);
    row_cnt = row_i + BQ * row_len;
  } else {  // this block's BQ row states in the global scratch
    const size_t base =
        (size_t(blockIdx.x) * gridDim.y + blockIdx.y) * BQ * row_len;
    row_s = state_s + base;
    row_i = state_i + base;
    row_cnt = reinterpret_cast<int*>(score_s + BQ * SLD);
    if (kp <= STAGE_KP) {  // after the counts: WARPS x 2*kp scores, then ids
      float* stage = reinterpret_cast<float*>(row_cnt + BQ);
      sort_s = stage + warp * row_len;
      sort_i = reinterpret_cast<int*>(stage + WARPS * row_len) + warp * row_len;
    }
  }

  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_begin = split * cols_per_split;
  const int n_end = min(N, n_begin + cols_per_split);

  for (size_t t = threadIdx.x; t < BQ * row_len; t += THREADS) {
    row_s[t] = NEG_INF;
    row_i[t] = -1;
  }
  for (int t = threadIdx.x; t < BQ; t += THREADS) row_cnt[t] = 0;
  // score_tile opens with __syncthreads(), which orders this initialisation

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    score_tile(q, p, q_s, p_s, score_s, Q, N, d, q0, n0, vec != 0);
    for (int r = warp; r < BQ && q0 + r < Q; r += WARPS) {
      float* rs = row_s + r * row_len;
      int* ri = row_i + r * row_len;
      int cnt = row_cnt[r];
      for (int c = lane; c < BN; c += 32) {
        const int n = n0 + c;
        const bool ok = n < n_end && (col_valid == nullptr || col_valid[n] != 0);
        bool taken;
        cnt = warp_offer<KPF>(rs, ri, cnt, k, score_s[r * SLD + c] * inv_tau, n,
                              ok, lane, taken, kp, sort_s, sort_i);
      }
      __syncwarp();
      if (lane == 0) row_cnt[r] = cnt;
    }
  }
  __syncthreads();

  for (int r = warp; r < BQ && q0 + r < Q; r += WARPS) {
    float* rs = row_s + r * row_len;
    int* ri = row_i + r * row_len;
    const int cnt = row_cnt[r];
    if (cnt > 0) warp_merge<KPF>(rs, ri, cnt, lane, kp, sort_s, sort_i);
    const size_t base = (size_t(q0 + r) * gridDim.y + split) * k;
    for (int t = lane; t < k; t += 32) {
      cand_s[base + t] = rs[t];
      cand_i[base + t] = ri[t];
    }
  }
}

// One warp per query row: folds its splits sorted lists of k candidates
// into k. A list is read only while its candidates still enter: each list is
// best first and the bar only rises, so after one is refused, the rest of
// its list would be too. With KPF = 0 the row's state is the first 2*kp
// pairs of row r in the global scratch (the split pass is done with it),
// sorted in the warp's dynamic shared staging up to STAGE_KP.
template <int KPF>
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const float* __restrict__ cand_s,
                  const int* __restrict__ cand_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int Q, int splits, int k,
                  float* __restrict__ state_s, int* __restrict__ state_i,
                  int kp_rt) {
  constexpr int SROW = KPF ? 2 * KPF : 1;
  __shared__ float row_s[WARPS][SROW];
  __shared__ int row_i[WARPS][SROW];
  const int kp = KPF ? KPF : kp_rt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= Q) return;  // the whole warp leaves; no block barrier follows
  float* rs = KPF ? row_s[warp] : state_s + size_t(r) * 2 * kp;
  int* ri = KPF ? row_i[warp] : state_i + size_t(r) * 2 * kp;
  extern __shared__ __align__(16) unsigned char stage_smem[];
  float* sort_s = nullptr;
  int* sort_i = nullptr;
  if (KPF == 0 && kp <= STAGE_KP) {
    float* stage = reinterpret_cast<float*>(stage_smem);
    sort_s = stage + warp * 2 * kp;
    sort_i = reinterpret_cast<int*>(stage + WARPS * 2 * kp) + warp * 2 * kp;
  }
  for (int t = lane; t < 2 * kp; t += 32) {
    rs[t] = NEG_INF;
    ri[t] = -1;
  }
  __syncwarp();
  int cnt = 0;
  for (int sp = 0; sp < splits; ++sp) {
    const float* cs = cand_s + (size_t(r) * splits + sp) * k;
    const int* ci = cand_i + (size_t(r) * splits + sp) * k;
    for (int base = 0; base < k; base += 32) {
      const int t = base + lane;
      const bool ok = t < k;
      bool taken;
      cnt = warp_offer<KPF>(rs, ri, cnt, k, ok ? cs[t] : NEG_INF,
                            ok ? ci[t] : -1, ok, lane, taken, kp, sort_s,
                            sort_i);
      if (__ballot_sync(0xffffffffu, ok && !taken) != 0) break;
    }
  }
  if (cnt > 0) warp_merge<KPF>(rs, ri, cnt, lane, kp, sort_s, sort_i);
  for (int t = lane; t < k; t += 32) {
    const float s = rs[t];
    out_s[size_t(r) * k + t] = s;
    out_i[size_t(r) * k + t] = s > NEG_INF * 0.5f ? ri[t] : -1;
  }
}

template <typename T, int KPF>
cudaError_t launch(const void* q, const void* p, const void* col_valid,
                   void* cand_s, void* cand_i, void* out_s, void* out_i,
                   void* state_s, void* state_i, int Q, int N, int d, int k,
                   int kp, int splits, int cols_per_split, float inv_tau,
                   int vec, cudaStream_t stream) {
  const size_t stage = KPF ? 0 : stage_bytes(kp);
  const size_t smem = split_smem_bytes<T, KPF>() + stage;
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel<T, KPF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  if (stage > 0) {
    err = cudaFuncSetAttribute(topk_merge_kernel<KPF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(stage));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + BQ - 1) / BQ, splits);
  topk_split_kernel<T, KPF><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(p),
      static_cast<const uint8_t*>(col_valid), static_cast<float*>(cand_s),
      static_cast<int*>(cand_i), Q, N, d, k, cols_per_split, inv_tau, vec,
      static_cast<float*>(state_s), static_cast<int*>(state_i), kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<KPF><<<(Q + WARPS - 1) / WARPS, THREADS, stage, stream>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), Q, splits, k,
      static_cast<float*>(state_s), static_cast<int*>(state_i), kp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any_k(const void* q, const void* p, const void* col_valid,
                         void* cand_s, void* cand_i, void* out_s, void* out_i,
                         void* state_s, void* state_i, int Q, int N, int d,
                         int k, int kp, int splits, int cols_per_split,
                         float inv_tau, int vec, cudaStream_t stream) {
  if (kp == KPAD && k <= KPAD)
    return launch<T, KPAD>(q, p, col_valid, cand_s, cand_i, out_s, out_i,
                           nullptr, nullptr, Q, N, d, k, kp, splits,
                           cols_per_split, inv_tau, vec, stream);
  // a power of two >= k and > KPAD, with its scratch
  if (kp <= KPAD || (kp & (kp - 1)) != 0 || kp < k || state_s == nullptr ||
      state_i == nullptr)
    return cudaErrorInvalidValue;
  return launch<T, 0>(q, p, col_valid, cand_s, cand_i, out_s, out_i, state_s,
                      state_i, Q, N, d, k, kp, splits, cols_per_split, inv_tau,
                      vec, stream);
}

}  // namespace

extern "C" {

int fused_topk_kpad() { return KPAD; }
int fused_topk_block_q() { return BQ; }
int fused_topk_block_n() { return BN; }

// dtype: 0 = fp32, 1 = bf16 (q and p alike). col_valid: uint8 (N,) or null.
// cand_s/cand_i: (Q, splits, k) scratch; out_s/out_i: (Q, k). kp: KPAD for
// k <= KPAD (state_s/state_i null), else a power of two >= k with
// state_s/state_i (ceil(Q / BQ) * splits * BQ * 2 * kp) scratch.
int fused_topk_launch(const void* q, const void* p, const void* col_valid,
                      void* cand_s, void* cand_i, void* out_s, void* out_i,
                      void* state_s, void* state_i, int Q, int N, int d, int k,
                      int kp, int splits, int cols_per_split, float inv_tau,
                      int dtype, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_any_k<__nv_bfloat16>(q, p, col_valid, cand_s, cand_i, out_s,
                                       out_i, state_s, state_i, Q, N, d, k, kp,
                                       splits, cols_per_split, inv_tau, vec,
                                       st);
  if (dtype == 0)
    return launch_any_k<float>(q, p, col_valid, cand_s, cand_i, out_s, out_i,
                               state_s, state_i, Q, N, d, k, kp, splits,
                               cols_per_split, inv_tau, vec, st);
  return int(cudaErrorInvalidValue);
}

const char* fused_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
