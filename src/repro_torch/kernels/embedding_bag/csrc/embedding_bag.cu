// Embedding bag for Hopper (sm_90a): out[b] = sum of table[indices[i]] over
// the lookups i with bag_ids[i] == b, for a (V, D) table in fp32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py
// (_kernel, reached through embedding_bag_fwd and ops.embedding_bag). Same
// contract: bag_ids sorted non-decreasing (the caller's promise, not
// checked here), each bag summed in the table's dtype one lookup at a time
// in lookup order (bf16 rounds after every add, as the TPU kernel's output
// block does), and bags with no lookups written as 0 (ops._zero_empty).
//
// Bound on an H100 SXM (3.35 TB/s HBM): by bytes. A lookup is one table row
// (64 bytes at D=16 fp32) and two 4-byte ids, and it adds D values: well
// under one operation per byte. The least traffic reads each distinct row
// once, the ids once and writes the output once.
//
// The Pallas kernel walks the lookups as a sequential grid, one row a step,
// and relies on revisits of an output block being consecutive. Blocks here
// run in parallel, so the design turns it around: a group of G lanes owns a
// bag. The bag's lookups are found from CSR offsets (pass 1 below), and each
// lane owns a slice of the row's columns, loaded as one 16-, 8-, 4- or
// 2-byte word a lookup (the widest word that divides the row and the
// table's alignment; any D works), and walks the bag's lookups in order,
// with four row loads in flight ahead of the adds so that the gathers
// overlap. Neighbouring lanes read neighbouring words of a row, each
// lookup is read by one group only, and each output row is written once,
// without atomics. G is the smallest power of two >= the words of a row, at
// most 32, so a warp holds 32 / G bags; a lane loops over further words
// when a row has more than 32. Row offsets are 64-bit: the stacked Criteo
// table of dcn-v2 has 3.0e9 elements.
//
//   1. bag_offsets_kernel: offsets[b] = the first lookup of bag b (or of
//      the next bag that has one), offsets[n_bags] = the end: each lookup
//      writes the offsets of the bags that start at it. Bag ids outside
//      [0, n_bags) are left out of every bag.
//   2. bag_sum_kernel: one lane group a bag, as above. An index outside
//      [0, V) adds nothing (the plain version raises there).
//
// Plain C interface for ctypes: every pointer and the stream are void*, the
// launch returns cudaGetLastError(). The kernels allocate nothing and do not
// synchronise; ops.py allocates the output and the offsets with torch.empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // row loads in flight per lane

__global__ void __launch_bounds__(THREADS)
bag_offsets_kernel(const int* __restrict__ bag_ids, int* __restrict__ offsets,
                   long long n_lookups, int n_bags) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i > n_lookups) return;
  // bags prev+1 .. cur start at lookup i (the end, i == n_lookups, closes
  // every bag after the last one seen)
  const int prev = i == 0 ? -1 : min(max(bag_ids[i - 1], -1), n_bags);
  const int cur = i == n_lookups ? n_bags : min(max(bag_ids[i], -1), n_bags);
  for (int b = prev + 1; b <= cur; ++b) offsets[b] = int(i);
}

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

// Sums in the table's dtype: fp32 adds; bf16 adds in fp32 and rounds to
// bf16 (nearest even) after every add, holding the running sum as a float
// that bf16 represents exactly.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float add(float acc, float x) { return acc + x; }
  static __device__ __forceinline__ float store(float acc) { return acc; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float add(float acc, float x) {
    return __bfloat162float(__float2bfloat16_rn(acc + x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float acc) {
    return __float2bfloat16_rn(acc);
  }
};

template <typename T, int BYTES>
__global__ void __launch_bounds__(THREADS)
bag_sum_kernel(const T* __restrict__ table, const int* __restrict__ indices,
               const int* __restrict__ offsets, T* __restrict__ out,
               long long n_lookups, int n_bags, int n_rows, int d, int group) {
  using W = typename Word<BYTES>::type;
  constexpr int VEC = BYTES / sizeof(T);
  const int words = d / VEC;  // words a row
  const long long bag =
      (blockIdx.x * (long long)THREADS + threadIdx.x) / group;
  if (bag >= n_bags) return;  // no barrier follows
  const int sub = threadIdx.x & (group - 1);
  // offsets come from pass 1; clamped so that ids that broke the sorted
  // contract can give a wrong sum but never a read out of bounds
  const long long lo = min(max((long long)offsets[bag], 0LL), n_lookups);
  const long long hi = min(max((long long)offsets[bag + 1], lo), n_lookups);
  for (int w = sub; w < words; w += group) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    long long i = lo;
    for (; i + UNROLL <= hi; i += UNROLL) {
      W x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = __ldg(indices + i + u);
        x[u] = (row >= 0 && row < n_rows)
                   ? __ldg(reinterpret_cast<const W*>(table + size_t(row) * d) + w)
                   : W();  // zero bits: +0 in either dtype
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // in lookup order
        const T* e = reinterpret_cast<const T*>(&x[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = Elem<T>::add(acc[j], Elem<T>::load(e[j]));
      }
    }
    for (; i < hi; ++i) {
      const int row = __ldg(indices + i);
      if (row < 0 || row >= n_rows) continue;
      const W x = __ldg(reinterpret_cast<const W*>(table + size_t(row) * d) + w);
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = Elem<T>::add(acc[j], Elem<T>::load(e[j]));
    }
    W o;
    T* e = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = Elem<T>::store(acc[j]);
    reinterpret_cast<W*>(out + size_t(bag) * d)[w] = o;
  }
}

template <typename T, int BYTES>
cudaError_t launch(const void* table, const void* indices, const void* offsets,
                   void* out, long long n_lookups, int n_bags, int n_rows,
                   int d, cudaStream_t stream) {
  constexpr int VEC = BYTES / sizeof(T);
  if (d % VEC) return cudaErrorInvalidValue;
  const int words = d / VEC;
  int group = 1;
  while (group < words && group < 32) group <<= 1;
  const long long threads = (long long)n_bags * group;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks == 0) return cudaSuccess;
  bag_sum_kernel<T, BYTES><<<dim3(unsigned(blocks)), THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(indices),
      static_cast<const int*>(offsets), static_cast<T*>(out), n_lookups,
      n_bags, n_rows, d, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_words(const void* table, const void* indices,
                         const void* offsets, void* out, long long n_lookups,
                         int n_bags, int n_rows, int d, int word_bytes,
                         cudaStream_t stream) {
  switch (word_bytes) {
    case 16:
      return launch<T, 16>(table, indices, offsets, out, n_lookups, n_bags,
                           n_rows, d, stream);
    case 8:
      return launch<T, 8>(table, indices, offsets, out, n_lookups, n_bags,
                          n_rows, d, stream);
    case 4:
      return launch<T, 4>(table, indices, offsets, out, n_lookups, n_bags,
                          n_rows, d, stream);
    default:
      if constexpr (sizeof(T) == 2) {
        if (word_bytes == 2)
          return launch<T, 2>(table, indices, offsets, out, n_lookups, n_bags,
                              n_rows, d, stream);
      }
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. table (n_rows, d); indices and bag_ids
// (n_lookups,) int32; offsets (n_bags + 1,) int32 scratch; out (n_bags, d).
// word_bytes: the load width, a multiple of the element size that divides a
// row's bytes and the table's and output's alignment.
int embedding_bag_launch(const void* table, const void* indices,
                         const void* bag_ids, void* offsets, void* out,
                         long long n_lookups, int n_bags, int n_rows, int d,
                         int dtype, int word_bytes, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n_bags < 0 || n_lookups < 0 || n_lookups > 0x7fffffffLL || d < 1)
    return int(cudaErrorInvalidValue);
  const long long blocks = (n_lookups + 1 + THREADS - 1) / THREADS;
  bag_offsets_kernel<<<dim3(unsigned(blocks)), THREADS, 0, st>>>(
      static_cast<const int*>(bag_ids), static_cast<int*>(offsets), n_lookups,
      n_bags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (dtype == 0)
    return int(launch_words<float>(table, indices, offsets, out, n_lookups,
                                   n_bags, n_rows, d, word_bytes, st));
  if (dtype == 1)
    return int(launch_words<__nv_bfloat16>(table, indices, offsets, out,
                                           n_lookups, n_bags, n_rows, d,
                                           word_bytes, st));
  return int(cudaErrorInvalidValue);
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
