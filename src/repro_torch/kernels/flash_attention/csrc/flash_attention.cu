// Flash attention forward for Hopper (sm_90a): softmax(q k^T * scale) v
// over BSHD tensors without the (Sq, Skv) score matrix reaching device
// memory.
//
// Replaces the TPU kernel _fwd_kernel of
// src/repro/kernels/flash_attention/flash_attention.py (via
// flash_attention_fwd). Same contract. q (B, Sq, H, D), k and v (B, Skv, Hk,
// D); query head h reads kv head h / (H / Hk). s = (q . k) * scale with the
// products accumulated in fp32; s = -1e30 (finite, never -inf) where the key
// is after the query row (causal, rows and columns both counted from 0) or
// where kv_mask is 0 (a null kv_mask: every key visible). A running max (starting at -1e30), sum-exp and fp32
// accumulator carry across the KV tiles; p = exp(s - m) is rounded to v's
// type before the p . v product, as _fwd_kernel does with p.astype(v.dtype),
// while the sum-exp adds the unrounded p. Output: acc / max(l, 1e-30) in q's
// type. A row with no visible key therefore averages every value, as the
// plain version's softmax over -1e30 logits does.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), bf16:
//   BERT passage pass, B=8, S=256, H=12, D=64: 4*B*H*S^2*D = 1.6 GFLOP, 1.6 us
//     of tensor-core time; q, k, v and o are 12.6 MB, 3.8 us of HBM time:
//     bound by bytes. The query pass (S=32) is smaller and bound by bytes too.
//   internlm2-1.8b prefill, B=1, S=4096, H=16, Hk=8, D=128, causal: 69 GFLOP
//     of the lower triangle, 69 us; 50 MB, 15 us: bound by the products.
// What the design does about the bytes: each block reads its q tile once
// and each of its KV tiles once, keeps the scores, probabilities and the
// fp32 accumulator in shared memory, and writes o once; GQA reads the shared
// kv head in place (no repeated K/V in memory); q, k and v are read through
// their batch, row and head strides, so the split heads of one fused qkv
// projection need no copy. For causal rows, KV tiles wholly after the tile's
// last row are skipped once every row of the tile has seen a visible key
// (their -1e30 logits then add exactly 0); a row with no visible key yet
// walks every tile, as the plain version averages over every column.
//
// One block per (64-row q tile, head, batch), 4 warps, walking 64-column KV
// tiles: bf16 inputs on the tensor cores (wmma 16x16x16, fp32 accumulate),
// each warp owning 16 query rows; fp32 inputs on a CUDA-core FMA path (no
// TF32 rounding). D is any multiple of 16 up to 128; q, k, v, scores,
// probabilities and the accumulator of one tile take up to 150 KB of
// dynamic shared memory (fp32, D=128; 113 KB for bf16). Tiles arrive by
// cp.async one step ahead: the next k tile loads behind the softmax, the
// next v tile behind the value product's end. Ragged tile edges are masked
// here: rows past Sq are computed on zeros and not stored, columns past Skv
// get p = 0 exactly. What it does not do yet: wgmma, TMA or a deeper
// pipeline, or the scores and accumulator in registers (each tile's go
// through shared memory, and 4 warps a block leave the tensor cores idle
// while a warp does its softmax).
//
// Plain C interface for ctypes: pointers and the stream are void*, strides
// are in elements, the launch returns cudaGetLastError(). Nothing is
// allocated or synchronised here; ops.py allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 128;    // 4 warps, 16 query rows each
constexpr int SLD = BK + 4;     // score tile row stride, floats
constexpr int PLD = BK + 8;     // bf16 probability tile row stride
enum : uint8_t { PAST = 0, MASKED = 1, LIVE = 2 };   // KV column states

// q, k, v tile row stride, elements: 16-byte rows (cp.async), skewed banks
template <typename T>
__host__ __device__ constexpr int tile_ld(int d) { return d + 16 / int(sizeof(T)); }

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory, in order: q, k, v tiles (64 rows x tile_ld), the fp32
// scores (BQ x SLD; the fp32 path writes p over them), the bf16 path's p
// (BQ x PLD), the fp32 accumulator (BQ x (D + 4)), m, l, corr per row, and
// the KV tile's column states.
struct Layout {
  size_t k, v, s, p, o, m, l, c, cols, total;
};

template <typename T>
__host__ __device__ Layout layout(int d) {
  Layout L;
  const size_t tile = align128(size_t(BQ) * tile_ld<T>(d) * sizeof(T));
  L.k = tile;
  L.v = L.k + tile;
  L.s = L.v + tile;
  L.p = L.s + align128(size_t(BQ) * SLD * sizeof(float));
  L.o = L.p + (sizeof(T) == 2 ? align128(size_t(BQ) * PLD * sizeof(T)) : 0);
  L.m = L.o + align128(size_t(BQ) * (d + 4) * sizeof(float));
  L.l = L.m + align128(BQ * sizeof(float));
  L.c = L.l + align128(BQ * sizeof(float));
  L.cols = L.c + align128(BQ * sizeof(float));
  L.total = L.cols + align128(BK);
  return L;
}

template <typename T> __device__ __forceinline__ T to_t(float x);
template <> __device__ __forceinline__ float to_t<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of 64 rows x D of a strided (rows, D) slice into shared
// memory (row stride ld), zero from row `valid` on. vec: asynchronous 16-byte
// copies (base and row stride 16-byte aligned), complete after the
// cp_async_wait that covers their group and a barrier; otherwise plain loads.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long long row_stride,
                                          int valid, int d, int ld, T* dst, bool vec) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    const int per_row = d / VEC;
    for (int t = threadIdx.x; t < 64 * per_row; t += THREADS) {
      const int r = t / per_row, c = (t - r * per_row) * VEC;
      if (r < valid)
        cp_async16(dst + r * ld + c, src + r * row_stride + c);
      else
        *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int t = threadIdx.x; t < 64 * d; t += THREADS) {
      const int r = t / d, c = t - r * d;
      dst[r * ld + c] = r < valid ? src[r * row_stride + c] : to_t<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Scores S (BQ x BK, fp32, unscaled) = Q K^T into s_s; and O = O * corr + P V.
// bf16: warp w owns rows 16w..16w+15 (tensor cores). fp32: thread (ty, tx) =
// (t / 16, t % 16) owns rows ty + 8i and columns tx + 16j.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void scores(const __nv_bfloat16* q_s, const __nv_bfloat16* k_s,
                                       float* s_s, int d, int ld) {
  using namespace nvcuda;
  const int w = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < d; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, q_s + w * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, k_s + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(s_s + w * 16 * SLD + j * 16, acc[j], SLD, wmma::mem_row_major);
}

__device__ __forceinline__ void scores(const float* q_s, const float* k_s, float* s_s,
                                       int d, int ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4] = {};
  for (int kk = 0; kk < d; ++kk) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = q_s[(ty + 8 * i) * ld + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * ld + kk];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s_s[(ty + 8 * i) * SLD + tx + 16 * j] = acc[i][j];
}

__device__ __forceinline__ void accumulate(const __nv_bfloat16* p_s, const __nv_bfloat16* v_s,
                                           float* o_s, const float* c_s, int d, int ld) {
  using namespace nvcuda;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int old = d + 4;
  for (int r = w * 16; r < w * 16 + 16; ++r) {
    const float corr = c_s[r];
    for (int c = lane; c < d; c += 32) o_s[r * old + c] *= corr;
  }
  __syncwarp();
  for (int n = 0; n < d; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o_s + w * 16 * old + n, old, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p_s + w * 16 * PLD + kk, PLD);
      wmma::load_matrix_sync(b, v_s + kk * ld + n, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_s + w * 16 * old + n, acc, old, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void accumulate(const float* p_s, const float* v_s, float* o_s,
                                           const float* c_s, int d, int ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int old = d + 4;
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    const float corr = c_s[r];
    for (int c = tx; c < d; c += 16) {
      float acc = o_s[r * old + c] * corr;
      for (int kk = 0; kk < BK; ++kk) acc = fmaf(p_s[r * SLD + kk], v_s[kk * ld + c], acc);
      o_s[r * old + c] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, T* __restrict__ o, int Sq, int Skv,
                 int H, int group, int d, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                 long long vsh, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int ld = tile_ld<T>(d), old = d + 4;
  const Layout L = layout<T>(d);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  // the fp32 path keeps p in the score tile
  T* p_s = reinterpret_cast<T*>(sizeof(T) == 2 ? smem + L.p : smem + L.s);
  float* o_s = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* c_s = reinterpret_cast<float*>(smem + L.c);
  uint8_t* cols_s = smem + L.cols;   // per KV column: PAST the edge, MASKED or LIVE

  const int q_rows = min(BQ, Sq - row0);
  const int last_row = row0 + q_rows - 1;
  const int n_tiles = (Skv + BK - 1) / BK;
  for (int x = threadIdx.x; x < BQ * old; x += THREADS) o_s[x] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const uint8_t* mask = kv_mask ? kv_mask + size_t(b) * Skv : nullptr;
  const T* k_b = k + b * ksb + hk * ksh;
  const T* v_b = v + b * vsb + hk * vsh;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Copies run one step ahead: q and the first k tile in one group, each v
  // tile in the next; the next k tile loads during this tile's softmax and
  // value product, the next v tile during the next tile's scores and
  // softmax, so every wait below leaves exactly the newest group in flight
  // (groups are committed even when empty).
  load_tile<T>(q + b * qsb + row0 * qss + h * qsh, qss, q_rows, d, ld, q_s, vec);
  load_tile<T>(k_b, kss, min(BK, Skv), d, ld, k_s, vec);
  cp_async_commit();
  load_tile<T>(v_b, vss, min(BK, Skv), d, ld, v_s, vec);
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BK, next = kv0 + BK;
    cp_async_wait<1>();  // q and this tile's k have landed
    __syncthreads();
    if (threadIdx.x < BK) {
      const int col = kv0 + threadIdx.x;
      cols_s[threadIdx.x] = col >= Skv ? PAST : (!mask || mask[col]) ? LIVE : MASKED;
    }
    scores(q_s, k_s, s_s, d, ld);
    __syncthreads();     // k_s is free
    if (next < Skv) load_tile<T>(k_b + next * kss, kss, min(BK, Skv - next), d, ld, k_s, vec);
    cp_async_commit();

    // online softmax: lanes 2i and 2i+1 of warp w share row 16w + i, each
    // taking every other column
    {
      const int r = w * 16 + (lane >> 1), row = row0 + r, half = lane & 1;
      float s[BK / 2];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = 2 * i + half, state = cols_s[c];
        if (state == PAST)
          s[i] = -INFINITY;  // past the edge: p = 0 exactly
        else if (state == MASKED || (causal && kv0 + c > row))
          s[i] = NEG_INF;
        else
          s[i] = s_s[r * SLD + c] * scale;
        mx = fmaxf(mx, s[i]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = expf(s[i] - m_new);
        sum += p;
        if constexpr (sizeof(T) == 2)
          p_s[r * PLD + 2 * i + half] = to_t<T>(p);
        else
          s_s[r * SLD + 2 * i + half] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    cp_async_wait<1>();  // this tile's v has landed
    __syncthreads();
    accumulate(p_s, v_s, o_s, c_s, d, ld);
    __syncthreads();     // v_s and p_s are free
    if (next < Skv) load_tile<T>(v_b + next * vss, vss, min(BK, Skv - next), d, ld, v_s, vec);
    cp_async_commit();
    if (causal && next > last_row) {
      // every later tile is after every row of this one: its logits are all
      // -1e30 and add exactly 0 to a row that has seen a visible key
      bool seen = true;
      for (int r = threadIdx.x; r < q_rows; r += THREADS) seen = seen && m_s[r] > NEG_INF;
      if (__syncthreads_and(seen)) break;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int r = w; r < q_rows; r += THREADS / 32) {
    const float l = fmaxf(l_s[r], 1e-30f);
    T* dst = o + ((size_t(b) * Sq + row0 + r) * H + h) * d;
    for (int c = lane; c < d; c += 32) dst[c] = to_t<T>(o_s[r * old + c] / l);
  }
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
                int B, int Sq, int Skv, int H, int Hk, int d, const long long* qs,
                const long long* ks, const long long* vs, float scale, int causal, int vec,
                cudaStream_t st) {
  const Layout L = layout<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, L.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<T*>(o), Sq, Skv, H, H / Hk, d,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike). kv_mask: uint8 (B, Skv),
// contiguous, or null (every key visible). o: contiguous (B, Sq, H, D). Strides of q, k, v in elements:
// batch, row, head (the last dimension is contiguous). vec: 16-byte loads
// are safe (aligned bases and strides).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               const void* kv_mask, void* o, int B, int Sq, int Skv,
                               int H, int Hk, int d, long long qsb, long long qss,
                               long long qsh, long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh, float scale,
                               int causal, int dtype, int vec, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 128 || Hk < 1 || H % Hk != 0)
    return int(cudaErrorInvalidValue);
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(q, k, v, kv_mask, o, B, Sq, Skv, H, Hk, d, qs, ks, vs, scale,
                              causal, vec, st);
  if (dtype == 0)
    return fwd<float>(q, k, v, kv_mask, o, B, Sq, Skv, H, Hk, d, qs, ks, vs, scale, causal,
                      vec, st);
  return int(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
