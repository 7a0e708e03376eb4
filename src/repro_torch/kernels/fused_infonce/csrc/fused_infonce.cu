// Blocked InfoNCE for Hopper (sm_90a): the forward row statistics and the
// two backward products of the contrastive loss, without the (M, N) score
// matrix ever reaching device memory.
//
// Replaces the TPU kernels of src/repro/kernels/fused_infonce/fused_infonce.py:
//   forward  _fwd_kernel -> infonce_fwd_kernel (+ infonce_stats_merge_kernel)
//   dQ       _dq_kernel  -> infonce_dq_kernel  (+ infonce_grad_reduce_kernel)
//   dP       _dp_kernel  -> infonce_dp_kernel  (+ infonce_grad_reduce_kernel)
// Same contract. s = (q . p_n) * inv_tau, products accumulated in fp32; an
// invalid column (col_valid[n] == 0) has s = -1e30 (finite, never -inf), so
// a fully masked row gets lse ~ -1e30 and no NaN. Per row: lse over the
// columns, pos = s at labels[i] (0 when the label is outside [0, N), -1e30
// when it points at a masked column), amax = the running max. Backward:
// coeff = exp(s - lse) * g_lse + onehot(label) * g_pos, zero on masked
// columns, times inv_tau, rounded to the operand type BEFORE its product (as
// the TPU kernel's coeff.astype(p.dtype)); dQ = coeff . P and dP = coeff^T . Q
// accumulate in fp32 and are cast to the operand type at the end.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), bf16, d=768,
// at the shapes of a contaccum_bf16 chunk (N = 8 + 8 + 2048 = 2064 columns):
//   local queries, M=8:     fwd ~1.0 us, dQ ~1.0 us, dP ~1.9 us, all set by
//                           the bytes of P (3.2 MB); the products are tiny.
//   query-bank rows, M=2048: fwd 2*M*N*d = 6.5 GFLOP ~6.6 us and dP
//                           4*M*N*d = 13 GFLOP ~13 us, set by the tensor cores.
// At M=8 a single row tile would give one block on 132 SMs, so the long axis
// is split: (row tile x column split) blocks for fwd and dQ, (column tile x
// row split) blocks for dP, each walking up to SPLIT_TILES tiles inside the
// block (the Pallas kernels carry their sums along a sequential grid axis;
// blocks here run in parallel and carry nothing). A second pass merges the
// splits: the forward's (max, sum-exp) pairs by the online-softmax combine,
// the gradients by an fp32 sum of per-split partials held in scratch that
// the wrapper allocates. No atomics, so results are deterministic. With one
// split a block writes its result directly and the second pass is skipped.
//
// Each block computes 64 x 64 score tiles on the tensor cores (wmma bf16
// 16x16x16, fp32 accumulate), looping over d in chunks of 64; fp32 inputs
// take a CUDA-core FMA loop so they are not rounded to TF32. The backward
// kernels first compute the block's whole coefficient strip (64 x up to 512)
// into shared memory in the operand type, then take the product with the
// other operand one d-chunk at a time, so the fp32 accumulator is only
// 64 x 64 and never leaves registers until it is written out. What it does
// not do yet: wgmma, TMA or a multi-stage pipeline; loads are synchronous.
//
// Plain C interface for ctypes: pointers and the stream are void*, each
// launch returns cudaGetLastError(). Nothing is allocated or synchronised
// here; ops.py allocates outputs and scratch with torch.empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = q_s[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = p_s[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
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

// One thread per row: the online-softmax combine of the splits' (max,
// sum-exp) pairs; pos is the owning split's value (the others hold 0).
__global__ void __launch_bounds__(THREADS)
infonce_stats_merge_kernel(const float* __restrict__ part, float* __restrict__ lse,
                           float* __restrict__ pos, float* __restrict__ amax,
                           int M, int splits) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= M) return;
  const float* pm = part + size_t(r) * splits;
  const float* pl = pm + size_t(M) * splits;
  const float* pp = pl + size_t(M) * splits;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, ps = 0.f;
  for (int s = 0; s < splits; ++s) {
    l += pl[s] * expf(pm[s] - m);
    ps += pp[s];
  }
  lse[r] = m + logf(l);
  pos[r] = ps;
  amax[r] = m;
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
  infonce_stats_merge_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0, st>>>(
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

const char* fused_infonce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
