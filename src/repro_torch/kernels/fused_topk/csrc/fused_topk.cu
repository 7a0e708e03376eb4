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
// Neither pass writes the (Q, N) score matrix, and both bf16 passes read
// every index row once from device memory (each query tile of 64 rows reads
// its column split; the query tiles of one split run side by side and share
// it through L2).
//
// ---- bf16 (topk_scan_kernel + topk_select_kernel) -------------------------
// Two passes, because blocks run in parallel and carry nothing between them
// (the Pallas kernel carries its running top-k along a sequential grid axis).
//
// 1. topk_scan_kernel, grid (query tiles of 64 rows x column splits), one
//    block a SM: one producer warp and two consumer warpgroups. Lane 0 of
//    the producer loads the block's 64 x d query tile once by TMA (d / 64
//    chunks of 64 rows x 128 bytes, 128-byte swizzled, zero past Q and past
//    d). Consumer w takes the split's index tiles w, w + 2, ... (128 rows
//    each) through its own ring of up to 4 chunks of 16 KB (128 rows x 64
//    columns), which producer lane w keeps full; each stage has a full
//    barrier (TMA bytes) and an empty barrier (one arrival a consumer warp).
//    A consumer computes S = Q P^T for 64 query rows x 128 index rows with
//    wgmma (m64n128k16, both operands K-major in shared memory, fp32
//    accumulators in registers): 4 k-steps a chunk, the chunk's stage
//    released as soon as its products have retired. While one consumer
//    selects, the other's products run. TMA zero-fills past N and past d, so
//    ragged N and d need no scalar path. A query tile of at most 32 rows (a
//    served batch) is spread: rows 8v..8v+7 go to the first 8 accumulator
//    rows of warp v, so all four warps of a consumer select, and it takes
//    half the shared memory (q_chunk), which goes to the rings.
//
//    Selection from registers: each warp owns 16 rows of its consumer's
//    accumulator, a thread rows lane/4 and lane/4 + 8 and 32 columns of
//    each (hopper.cuh's wgmma layout), so no block barrier is needed. Each
//    row keeps, in the registers of the four lanes that hold it, its bar
//    ((-1e30, -1) until its pool is first cut, then the k-th best it has
//    kept), the bar as a raw score (raw_bar: no accumulator below it can
//    scale to the bar) and the count of its pool. One unrolled pass compares
//    the 64 raw accumulators with the two raw bars; only the hits are scaled
//    by inv_tau, compared with the bar exactly in the total order, and, when
//    they beat it, appended to the row's pool at positions taken by a prefix
//    sum over the quad. A full pool is cut back to its k best by the warp
//    that owns the row: a radix select of the k-th best key below the keys'
//    common prefix (8 bits a pass, in a 256-bin histogram of the warp's
//    shared memory), then an in-place compaction of the keys at or above
//    it; the k-th best becomes the new bar. Nothing is sorted during the
//    scan, no score tile is stored, and no row state is read per candidate.
//    A (score, id) pair is one 64-bit key, larger = better: the score's
//    order-preserving bits above (-0 taken as +0), 2^32 - 1 - id below, so
//    key order is the contract's total order. Rows past Q keep no state. At
//    the end each consumer cuts its pools to k, the two pools of each row are
//    joined and cut to k, and the split's list (padded with (-1e30, -1)) is
//    written, unsorted, to the (Q, splits, k) candidate buffer.
//
//    Pools: 2 kp keys a row and consumer (kp the next power of two >= k, at
//    least 128, so a cut frees at least kp slots) in global scratch;
//    appends are single 8-byte stores that stay in L2. A pool of up to 512
//    keys (k <= 256) is cut in its warp's shared staging area (one read and
//    one write of the pool); a larger one in place. Measured on an H100
//    (bench.py): pools held in shared memory left room for only 3 ring
//    stages beside the query tile, and the scan starved for loads (1.455 ms
//    at serve_topk and 22.27 ms at eval_topk, k = 100); one consumer
//    warpgroup left the tensor cores idle while it selected (13.6 ms at
//    eval_topk, 9.3 ms with two).
//
//    Shared-memory plan of a block (227 KB = 232,448 bytes at most):
//      query tile   ceil(d/64) x 8 KB, half when spread   (d = 768: 96 KB)
//      rings        2 x stages x 16 KB                    (2-4 stages each)
//      staging      8 warps x stage_keys x 8 bytes        (k <= 256)
//      histograms   8 warps x 256 x 4 bytes               (8 KB)
//      pool counts  2 x 64 x 4 bytes
//      barriers     (1 + 2 x 2 x 4) x 8 bytes, then 1 KB to align the base
//    ops.scan_plan picks the stages (as many as fit, up to 4 a ring) and the
//    staging from d, k and Q, and mirrors this layout (ops.scan_smem_bytes);
//    the kernel refuses a plan over the limit. d = 768, k = 100: eval_topk
//    3 stages a ring, 222,856 bytes; serve_topk (spread) 4, 206,472 bytes.
//
//    Streamed layout (topk_stream_kernel, the same code with STREAM set):
//    rows too wide for a resident tile (d > 1216 at 64 query rows; at up to
//    32, once the spread tile leaves no two stages a ring; the full tile
//    alone is ceil(d/64) x 8 KB, 256 KB at the LM retriever's d = 2048)
//    keep no query tile. Each ring stage holds an index chunk and then the
//    query tile's chunk of the same 64 columns (128 + 64 rows x 128 bytes =
//    24 KB), both loaded by the producer lane of that ring on the stage's
//    full barrier, as fused_infonce's ring_load stages a P chunk and then a
//    Q chunk; the consumer's wgmma reads A from the stage instead of the
//    tile. Nothing else changes: scores, selection
//    and pools as above, and nothing in the plan depends on d. Each index
//    tile then costs half as many bytes again of queries from L2 (64 rows
//    beside 128), which the resident tile saves; at d = 2048 the query tile
//    of a block is 256 KB and L2 holds every query tile of a call. Plan:
//      rings        2 x stages x 24 KB                    (3-4 stages each)
//      the rest     as above, no query tile
//    k <= 128: 4 stages, 222,856 bytes; k <= 256: 3, 190,088; k > 256
//    (pools cut in global memory): 4, 206,472.
//
// 2. topk_select_kernel, one block a query row (1024 threads, 256 when the
//    row has fewer than 8192 candidates): the k best of the row's splits x
//    k candidates by the same radix select (a block-wide histogram), the
//    keys above the k-th gathered and the k-th repeated up to k, then a
//    bitonic sort of the k (padded to kp) in shared memory up to kp = 4096,
//    in global scratch past it; ids of slots scoring -1e30 come back as -1.
//
// What it does not do yet: overlap a consumer's selection with its own next
// products (a second accumulator), share an index tile between two query
// tiles (clusters, TMA multicast), publish a split's bar to the other
// splits of its row, or (streamed) share a query chunk between the two
// consumers' rings.
//
// ---- fp32 (topk_split_kernel + topk_merge_kernel) -------------------------
// The CUDA-core path, unchanged (no TF32 rounding): 64 x 128 score tiles by
// FMA in a 16 x 16 thread grid, the next d-chunk's loads issued into
// registers before the current one multiplies, the score tile through
// shared memory, each row's state 2*kp (score, id) pairs (the sorted best
// kp, then an unsorted buffer of offers that beat the k-th best; a full
// buffer is merged by a bitonic sort of all 2*kp pairs), in shared memory
// for k <= KPAD (128), in global scratch past it (sorted in a per-warp
// shared staging area up to kp = STAGE_KP); the merge pass is one warp a
// row over the splits' sorted lists.
//
// Plain C interface for ctypes: every pointer and the stream are void*, the
// launches return cudaGetLastError(). The kernels allocate nothing and do
// not synchronise; ops.py allocates outputs and scratch with torch.empty and
// makes the 16-byte aligned copies TMA needs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ============================================================================
// bf16: TMA ring, wgmma scores, selection from registers
// ============================================================================

constexpr int HQ = 64;                   // query rows a block (wgmma M)
constexpr int HN = 128;                  // index rows a tile (wgmma N)
constexpr int CHUNK_Q = HQ * 128;        // bytes of a 64-column chunk of the query tile
constexpr int CHUNK_P = HN * 128;        // bytes of a ring stage
constexpr int CONSUMERS = 2;             // consumer warpgroups, each with its own ring
constexpr int MAX_STAGES = 4;            // stages of each ring
constexpr int SCAN_THREADS = 128 * CONSUMERS + 32;   // then the producer warp
constexpr int BINS = 256;                // radix-select histogram
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may use
constexpr int ALIGN_SLACK = 1024;        // the 128-byte swizzle repeats every 1024 bytes
constexpr int STAGE_KEYS_MAX = 512;      // largest pool cut in a warp's shared staging
constexpr int SELECT_THREADS = 1024;
constexpr int SORT_SMEM_KEYS = 4096;     // largest kp the select pass sorts in shared memory

// The query tile's layouts: resident (all of it, loaded once), spread (a
// resident tile of at most 32 rows, 8 a warp: see q_chunk) and streamed
// (none resident: each ring stage carries the query chunk beside its index
// chunk, for rows too wide for a resident tile)
constexpr int RESIDENT = 0, SPREAD = 1, STREAMED = 2;

struct ScanLayout {
  int off_ring, off_stage, off_hist, off_count, off_bar, total;
};

// layout: RESIDENT, SPREAD or STREAMED; stages: of each consumer's ring;
// stage_keys: keys of a warp's staging area (0: pools are cut in global
// memory)
__host__ __device__ constexpr ScanLayout scan_layout(int d, int layout, int stages,
                                                     int stage_keys) {
  const int nc = (d + 63) / 64;
  const int q_bytes = layout == STREAMED ? 0 : layout == SPREAD ? (nc + 1) / 2 * CHUNK_Q
                                                                 : nc * CHUNK_Q;
  const int stage = layout == STREAMED ? CHUNK_P + CHUNK_Q : CHUNK_P;
  const int off_stage = q_bytes + CONSUMERS * stages * stage;
  const int off_hist = off_stage + 4 * CONSUMERS * stage_keys * 8;
  const int off_count = off_hist + 4 * CONSUMERS * BINS * 4;
  const int off_bar = off_count + CONSUMERS * HQ * 4;
  return {q_bytes, off_stage, off_hist, off_count, off_bar,
          off_bar + 8 * (1 + 2 * CONSUMERS * MAX_STAGES) + ALIGN_SLACK};
}

// Byte offset of 64-column chunk c of the query tile, as wgmma reads it:
// rows in 8-row groups of 1024 bytes (128-byte swizzle). A full tile keeps
// 64 rows a chunk. A spread tile (Q <= 32) puts query rows 8w..8w+7 in group
// 2w, the first rows of warp w, so all four warps hold rows; its odd groups
// hold the neighbouring chunk's rows (chunks 2m and 2m+1 interleave in one 8
// KB block), which wgmma multiplies into rows nobody reads.
__device__ __forceinline__ uint32_t q_chunk(int c, bool spread) {
  return spread ? uint32_t(c / 2) * CHUNK_Q + uint32_t(c % 2) * 1024u : uint32_t(c) * CHUNK_Q;
}

// ---- keys: (score, id) as one 64-bit integer, larger = better ---------------
__device__ __forceinline__ uint32_t ord_bits(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ uint64_t make_key(float s, uint32_t id) {
  return (uint64_t(ord_bits(s)) << 32) | uint64_t(0xffffffffu - id);
}
__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t o = uint32_t(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ uint32_t key_id(uint64_t key) { return 0xffffffffu - uint32_t(key); }
// an empty slot: (-1e30, -1), below every real candidate
__device__ __forceinline__ uint64_t empty_key() { return make_key(NEG_INF, 0xffffffffu); }

// s = a * inv_tau in fp32, -0 taken as +0 (so that key order agrees with
// float comparison)
__device__ __forceinline__ float scaled(float a, float inv_tau) {
  return __fadd_rn(__fmul_rn(a, inv_tau), 0.0f);
}
// (s, n) beats the bar (ts, ti) in the total order
__device__ __forceinline__ bool beats(float s, uint32_t n, float ts, uint32_t ti) {
  return s > ts || (s == ts && n < ti);
}

// v[x] for a run-time x < 64, by a tree of 63 selects (no local memory)
__device__ __forceinline__ float pick(const float (&v)[64], int x) {
  float a[32], b[16], c[8], d[4];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = (x & 1) ? v[2 * i + 1] : v[2 * i];
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = (x & 2) ? a[2 * i + 1] : a[2 * i];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = (x & 4) ? b[2 * i + 1] : b[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = (x & 8) ? c[2 * i + 1] : c[2 * i];
  const float e0 = (x & 16) ? d[1] : d[0], e1 = (x & 16) ? d[3] : d[2];
  return (x & 32) ? e1 : e0;
}

// Row h's score in column x of this thread's accumulators (hopper.cuh's
// wgmma layout), scaled
__device__ __forceinline__ float row_score(const float (&acc)[64], int h, int x, float inv_tau) {
  return __fmul_rn(pick(acc, 4 * (x >> 1) + 2 * h + (x & 1)), inv_tau);
}

// A raw score below which no accumulator a can scale to the bar bs:
// fl(a * inv_tau) >= bs implies a >= this (bs / inv_tau rounds within 2^-24
// and the product within 2^-24 of its value; 2^-16 of |bs / inv_tau| and
// 1e-30 more cover both). -inf while the bar is empty or inv_tau is not a
// positive finite number (every column then takes the exact comparison).
__device__ __forceinline__ float raw_bar(float bs, float inv_tau) {
  if (!(inv_tau > 0.f && inv_tau <= 3.0e38f) || bs <= NEG_INF) return -INFINITY;
  const float r = bs / inv_tau;
  return r - fabsf(r) * 0x1p-16f - 1e-30f;
}

// The k-th largest of keys[0, n) (1 <= k <= n, duplicates counted), by one
// warp: a most-significant-digit-first radix select below the keys' common
// prefix (one pass for their minimum and maximum), 8 bits a pass, counted in
// `hist` (this warp's BINS counters). When every key of the chosen digit is
// among the k largest, the k-th is their minimum, found in one more pass.
__device__ uint64_t warp_kth_largest(const uint64_t* keys, int n, int k, uint32_t* hist,
                                     int lane) {
  unsigned long long lo = ~0ull, hi = 0;
  for (int i = lane; i < n; i += 32) {
    const unsigned long long key = keys[i];
    lo = min(lo, key);
    hi = max(hi, key);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, o));
    hi = max(hi, __shfl_xor_sync(FULL, hi, o));
  }
  if (lo == hi || n == k) return lo;
  const int top = 63 - __clzll(lo ^ hi);   // the highest bit that differs
  uint64_t mask = top == 63 ? 0 : ~((uint64_t(2) << top) - 1);
  uint64_t prefix = hi & mask;
  int want = k;
  for (int shift = max(top - 7, 0);; shift = max(shift - 8, 0)) {
#pragma unroll
    for (int b = 0; b < 8; ++b) hist[8 * lane + b] = 0;
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const uint64_t key = keys[i];
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncwarp();
    // lane L counts digits 255 - 8L - j, j = 0..7: the largest digits first
    uint32_t c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[255 - 8 * lane - j];
      sum += c[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t x = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += x;
    }
    const uint32_t excl = incl - sum;
    const bool mine = excl < uint32_t(want) && uint32_t(want) <= incl;
    int bin = 0;
    uint32_t above = 0, cnt = 0;
    if (mine) {
      uint32_t run = excl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cnt == 0 && run + c[j] >= uint32_t(want)) {
          bin = 255 - 8 * lane - j;
          above = run;
          cnt = c[j];
        }
        run += c[j];
      }
    }
    const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
    bin = __shfl_sync(FULL, bin, src);
    above = __shfl_sync(FULL, above, src);
    cnt = __shfl_sync(FULL, cnt, src);
    want -= int(above);
    prefix |= uint64_t(bin) << shift;   // a digit that overlaps fixed bits repeats them
    mask |= uint64_t(255) << shift;
    __syncwarp();   // every lane has read the bins before the next pass clears them
    if (int(cnt) == want) {
      unsigned long long m = ~0ull;
      for (int i = lane; i < n; i += 32) {
        const unsigned long long key = keys[i];
        if ((key & mask) == prefix) m = min(m, key);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(FULL, m, o));
      return m;
    }
    if (shift == 0) return prefix;
  }
}

// Keeps the k largest of pool[0, n) (distinct keys, n >= k) in pool[0, k),
// in no order, by one warp; returns the k-th largest.
__device__ uint64_t warp_keep_k(uint64_t* pool, int n, int k, uint32_t* hist, int lane) {
  const uint64_t kth = warp_kth_largest(pool, n, k, hist, lane);
  int w = 0;
  for (int base = 0; base < n && w < k; base += 32) {
    const int i = base + lane;
    const uint64_t key = i < n ? pool[i] : 0;
    const bool keep = i < n && key >= kth;
    const unsigned m = __ballot_sync(FULL, keep);   // every lane has read its key
    if (keep) pool[w + __popc(m & ((1u << lane) - 1u))] = key;
    w += __popc(m);
  }
  __syncwarp();
  return kth;
}

// warp_keep_k on a row's pool in global memory, through the warp's shared
// staging area when the pool fits it (one read and one write of the pool
// instead of a pass over global memory for every digit).
__device__ uint64_t warp_cut(uint64_t* pool, int n, int k, uint64_t* stage, int stage_keys,
                             uint32_t* hist, int lane) {
  if (n > stage_keys) return warp_keep_k(pool, n, k, hist, lane);
  for (int i = lane; i < n; i += 32) stage[i] = pool[i];
  __syncwarp();
  const uint64_t kth = warp_keep_k(stage, n, k, hist, lane);
  for (int i = lane; i < k; i += 32) pool[i] = stage[i];
  __syncwarp();
  return kth;
}

// The scan block (see the file's header). STREAM: the streamed layout (no
// resident query tile: producer lane w loads each stage's query chunk, rows
// q0.. of the tile, beside its index chunk, and the consumer multiplies the
// two chunks of the stage); else the resident or spread layout (`spread`).
template <bool STREAM>
__device__ __forceinline__ void scan_block(const CUtensorMap* tq, const CUtensorMap* tp,
                                           const uint8_t* __restrict__ col_valid,
                                           uint64_t* __restrict__ cand,
                                           uint64_t* __restrict__ pools, int Q, int N, int d,
                                           int k, int kp, int cols_per_split, float inv_tau,
                                           int spread, int stages, int stage_keys) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const ScanLayout L = scan_layout(d, STREAM ? STREAMED : spread, stages, stage_keys);
  // bytes of a ring stage: an index chunk, then (streamed) its query chunk
  constexpr uint32_t STAGE = STREAM ? CHUNK_P + CHUNK_Q : CHUNK_P;
  const uint32_t q_s = smem_u32(smem), bar_q = q_s + L.off_bar;
  // consumer w's ring: its stages, and a full and an empty barrier each
  auto ring = [&](int w) { return q_s + L.off_ring + uint32_t(w * stages) * STAGE; };
  auto full = [&](int w, int s) { return bar_q + 8u * (1 + w * MAX_STAGES + s); };
  auto empty = [&](int w, int s) { return bar_q + 8u * (1 + (CONSUMERS + w) * MAX_STAGES + s); };

  const int q0 = blockIdx.x * HQ;
  const int n_begin = blockIdx.y * cols_per_split;
  const int n_end = min(N, n_begin + cols_per_split);
  const int n_tiles = (n_end - n_begin + HN - 1) / HN;
  const int nc = (d + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int w = 0; w < CONSUMERS; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);   // one arrival a consumer warp
      }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * CONSUMERS) {
    // ---- producer: lane w fills consumer w's ring with the index chunks of
    // tiles w, w + 2, ... of the split (each lane waits only on its own
    // ring); lane 0 first loads the query tile (streamed: each lane loads
    // the query chunks into its ring's stages)
    if (lane == 0) {
      prefetch_tensormap(tq);
      prefetch_tensormap(tp);
      if (!STREAM && spread) {   // boxes of 8 rows: rows 8w.. to group 2w of each chunk
        mbar_expect_tx(bar_q, nc * 4 * 1024);
        for (int c = 0; c < nc; ++c)
          for (int w = 0; w < 4; ++w)
            tma_load_2d(tq, q_s + q_chunk(c, true) + 2048u * w, bar_q, 64 * c, 8 * w);
      } else if (!STREAM) {
        mbar_expect_tx(bar_q, nc * CHUNK_Q);
        for (int c = 0; c < nc; ++c) tma_load_2d(tq, q_s + q_chunk(c, false), bar_q, 64 * c, q0);
      }
    }
    if (lane < CONSUMERS) {
      int it = 0;
      for (int j = lane; j < n_tiles; j += CONSUMERS)
        for (int c = 0; c < nc; ++c, ++it) {
          const int s = it % stages;
          mbar_wait(empty(lane, s), ((it / stages) & 1) ^ 1);   // the first round passes at once
          mbar_expect_tx(full(lane, s), STAGE);
          tma_load_2d(tp, ring(lane) + s * STAGE, full(lane, s), 64 * c, n_begin + j * HN);
          if (STREAM) tma_load_2d(tq, ring(lane) + s * STAGE + CHUNK_P, full(lane, s), 64 * c, q0);
        }
    }
    return;   // no block barrier follows
  }

  // ---- consumer warpgroup wg: the split's tiles wg, wg + 2, ...; its warp
  // v's accumulator rows are rbase + g and rbase + g + 8. Each consumer keeps
  // its own pools; they are joined into one candidate list at the end.
  const int wg = warp / 4, v = warp % 4;
  const int g = lane / 4, t = lane % 4, rbase = 16 * v;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + L.off_hist) + warp * BINS;
  uint64_t* stage = reinterpret_cast<uint64_t*>(smem + L.off_stage) + warp * stage_keys;
  const int cap = 2 * kp;
  uint64_t* block_pools =
      pools + ((size_t(blockIdx.x) * gridDim.y + blockIdx.y) * CONSUMERS + wg) * HQ * cap;
  auto pool_row = [&](int r) { return block_pools + size_t(r) * cap; };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(wg, s));
  };
  // the query row of accumulator row rbase + gg + 8h (Q or more: none)
  auto query_row = [&](int gg, int h) {
    return spread ? (h == 0 ? 8 * v + gg : Q) : q0 + rbase + gg + 8 * h;
  };

  // each of the thread's two rows (accumulator rows rbase + g + 8h): its
  // bar (no key below it can enter) and the keys in its pool
  float ts0 = NEG_INF, ts1 = NEG_INF;
  uint32_t ti0 = 0xffffffffu, ti1 = 0xffffffffu;
  int cnt0 = 0, cnt1 = 0;
  float lb0 = -INFINITY, lb1 = -INFINITY;   // each bar as a raw score (raw_bar)
  const bool live0 = query_row(g, 0) < Q, live1 = query_row(g, 1) < Q;

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  if (!STREAM) mbar_wait(bar_q, 0);
  int it = 0;
  for (int j = wg; j < n_tiles; j += CONSUMERS) {
    const int n0 = n_begin + j * HN;
    // S = Q P^T: nc chunks of 4 k-steps, each chunk's stage released as
    // soon as its products have retired. (Keeping one chunk's products in
    // flight while the next is issued ran 10% slower at eval_topk on an
    // H100: a stage then waits for the next chunk's data to be released.)
    for (int c = 0; c < nc; ++c, ++it) {
      const int s = it % stages;
      const uint32_t a = STREAM ? ring(wg) + s * STAGE + CHUNK_P : q_s + q_chunk(c, spread != 0);
      mbar_wait(full(wg, s), (it / stages) & 1);
      fence_regs<64>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(acc, desc_sw128(a + kk * 32, 16, 1024),
                      desc_sw128(ring(wg) + s * STAGE + kk * 32, 16, 1024), (c | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(acc);
      release(s);
    }

    // the columns this thread holds that may enter: bit x for column n0 +
    // col(x) (all of a whole tile without a mask; a mask is read two bytes
    // a load where it is aligned)
    auto col = [&](int x) { return uint32_t(n0 + 8 * (x >> 1) + 2 * t + (x & 1)); };
    uint32_t vmask = FULL;
    const bool whole = n0 + HN <= n_end;
    if (whole && col_valid != nullptr && (reinterpret_cast<uintptr_t>(col_valid) & 1) == 0) {
      vmask = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t two = __ldg(reinterpret_cast<const unsigned short*>(col_valid + col(2 * i)));
        vmask |= (uint32_t((two & 0xffu) != 0) | (uint32_t((two >> 8) != 0) << 1)) << (2 * i);
      }
    } else if (!whole || col_valid != nullptr) {
      vmask = 0;
      for (int x = 0; x < 32; ++x) {
        const int n = int(col(x));
        if (n < n_end && (col_valid == nullptr || __ldg(col_valid + n) != 0)) vmask |= 1u << x;
      }
    }
    // Prefilter, both rows in one pass over the raw accumulators: bit x of
    // hit0 / hit1 when column col(x) reaches the row's raw bar. Exact
    // comparisons, key building and appends run on the hits only.
    uint32_t hit0 = 0, hit1 = 0;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      hit0 |= uint32_t(acc[4 * (x >> 1) + (x & 1)] >= lb0) << x;
      hit1 |= uint32_t(acc[4 * (x >> 1) + 2 + (x & 1)] >= lb1) << x;
    }
    hit0 &= live0 ? vmask : 0u;
    hit1 &= live1 ? vmask : 0u;
    if (!__any_sync(FULL, (hit0 | hit1) != 0)) continue;

    // The two rows in turn through one copy of the code, so the tile's
    // instructions stay in cache; hits are walked bit by bit (pick).
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      if (!__any_sync(FULL, (h ? hit1 : hit0) != 0)) continue;
      float bs = h ? ts1 : ts0;
      uint32_t bi = h ? ti1 : ti0;
      int c_h = h ? cnt1 : cnt0;
      uint32_t pass = 0;
      for (uint32_t rest = h ? hit1 : hit0; rest != 0; rest &= rest - 1) {
        const int x = __ffs(rest) - 1;
        if (beats(row_score(acc, h, x, inv_tau), col(x), bs, bi)) pass |= 1u << x;
      }
      while (__any_sync(FULL, pass != 0)) {
        // append what fits, at positions from a prefix sum over the quad
        const int mine = __popc(pass);
        int incl = mine;
        int y = __shfl_up_sync(FULL, incl, 1, 4);
        if (t >= 1) incl += y;
        y = __shfl_up_sync(FULL, incl, 2, 4);
        if (t >= 2) incl += y;
        const int total = __shfl_sync(FULL, incl, 3, 4);
        int pos = c_h + incl - mine;
        uint64_t* pool = pool_row(rbase + g + 8 * h);
        for (uint32_t rest = pass; rest != 0 && pos < cap; rest &= rest - 1) {
          const int x = __ffs(rest) - 1;
          pool[pos++] = make_key(__fadd_rn(row_score(acc, h, x, inv_tau), 0.0f), col(x));   // -0 as +0
          pass &= ~(1u << x);
        }
        c_h = min(cap, c_h + total);
        __syncwarp();
        // every full pool of the warp is cut back to its k best
        unsigned need = __ballot_sync(FULL, t == 0 && c_h == cap);
        while (need != 0) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          const uint64_t kth =
              warp_cut(pool_row(rbase + src / 4 + 8 * h), cap, k, stage, stage_keys, hist, lane);
          if (g == src / 4) {
            bs = key_score(kth);
            bi = key_id(kth);
            c_h = k;
          }
        }
        // what did not fit faces the raised bar
        for (uint32_t rest = pass; rest != 0; rest &= rest - 1) {
          const int x = __ffs(rest) - 1;
          if (!beats(row_score(acc, h, x, inv_tau), col(x), bs, bi)) pass &= ~(1u << x);
        }
      }
      if (h) {
        ts1 = bs, ti1 = bi, cnt1 = c_h, lb1 = raw_bar(bs, inv_tau);
      } else {
        ts0 = bs, ti0 = bi, cnt0 = c_h, lb0 = raw_bar(bs, inv_tau);
      }
    }
  }

  // The split's list: each consumer cuts its live rows' pools to at most k
  // and counts them in shared memory; then each row's two pools are joined
  // in the first consumer's (at most 2k <= 2 kp keys), cut to k, padded
  // with empty slots and written to the candidate buffer (unsorted), the
  // 64 rows shared among all 8 consumer warps.
  int* counts = reinterpret_cast<int*>(smem + L.off_count);   // [CONSUMERS][HQ]
#pragma unroll
  for (int h = 0; h < 2; ++h)
    for (int gg = 0; gg < 8; ++gg) {
      const int r = rbase + gg + 8 * h;
      int c = __shfl_sync(FULL, h ? cnt1 : cnt0, 4 * gg);
      if (c > k) {
        warp_cut(pool_row(r), c, k, stage, stage_keys, hist, lane);
        c = k;
      }
      if (lane == 0) counts[wg * HQ + r] = c;
    }
  named_bar_sync<1, 128 * CONSUMERS>();   // the producer warp has left
  const uint64_t empty_slot = empty_key();
  uint64_t* pools0 = pools + (size_t(blockIdx.x) * gridDim.y + blockIdx.y) * CONSUMERS * HQ * cap;
  for (int r = warp; r < HQ; r += 4 * CONSUMERS) {
    const int rem = r % 16, row = spread ? (rem < 8 ? 8 * (r / 16) + rem : Q) : q0 + r;
    if (row >= Q) continue;
    uint64_t* pool = pools0 + size_t(r) * cap;
    int c = counts[r];
    for (int w = 1; w < CONSUMERS; ++w) {
      const uint64_t* other = pools0 + (size_t(w) * HQ + r) * cap;
      const int co = counts[w * HQ + r];
      for (int x = lane; x < co; x += 32) pool[c + x] = other[x];
      c += co;
    }
    __syncwarp();
    if (c > k) {
      warp_cut(pool, c, k, stage, stage_keys, hist, lane);
      c = k;
    }
    uint64_t* out = cand + (size_t(row) * gridDim.y + blockIdx.y) * k;
    for (int x = lane; x < k; x += 32) out[x] = x < c ? pool[x] : empty_slot;
  }
}

// The scan with a resident query tile (spread: at most 32 rows, 8 a warp)
__global__ void __launch_bounds__(SCAN_THREADS, 1)
topk_scan_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tp,
                 const uint8_t* __restrict__ col_valid, uint64_t* __restrict__ cand,
                 uint64_t* __restrict__ pools, int Q, int N, int d, int k, int kp,
                 int cols_per_split, float inv_tau, int spread, int stages, int stage_keys) {
  scan_block<false>(&tq, &tp, col_valid, cand, pools, Q, N, d, k, kp, cols_per_split, inv_tau,
                    spread, stages, stage_keys);
}

// The scan with the query chunks streamed through the rings (rows too wide
// for a resident tile)
__global__ void __launch_bounds__(SCAN_THREADS, 1)
topk_stream_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tp,
                   const uint8_t* __restrict__ col_valid, uint64_t* __restrict__ cand,
                   uint64_t* __restrict__ pools, int Q, int N, int d, int k, int kp,
                   int cols_per_split, float inv_tau, int stages, int stage_keys) {
  scan_block<true>(&tq, &tp, col_valid, cand, pools, Q, N, d, k, kp, cols_per_split, inv_tau, 0,
                   stages, stage_keys);
}

// One block a query row (SELECT_THREADS threads, or BINS when the row has
// few candidates): the k best of its splits x k candidate keys, sorted,
// decoded into (score, id).
__global__ void __launch_bounds__(SELECT_THREADS)
topk_select_kernel(const uint64_t* __restrict__ cand, float* __restrict__ out_s,
                   int* __restrict__ out_i, uint64_t* __restrict__ scratch, int splits, int k,
                   int kp) {
  __shared__ uint32_t hist[BINS];
  __shared__ uint32_t wsum[BINS / 32];
  __shared__ int pick_bin;
  __shared__ uint32_t pick_above, pick_cnt;
  __shared__ unsigned long long kmin, kmax;
  __shared__ int count;
  extern __shared__ __align__(16) uint64_t sort_smem[];
  static_assert(SELECT_THREADS % BINS == 0 && BINS == 256, "threads 0..255 own a bin each");

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nt = blockDim.x;
  const int row = blockIdx.x;
  const long long n = (long long)splits * k;
  const uint64_t* keys = cand + size_t(row) * size_t(n);
  uint64_t* buf = kp <= SORT_SMEM_KEYS ? sort_smem : scratch + size_t(row) * kp;

  // the k-th largest key, as warp_kth_largest, block-wide
  auto reduce_min_max = [&](uint64_t mask, uint64_t prefix, bool both) {
    unsigned long long lo = ~0ull, hi = 0;
#pragma unroll 4
    for (long long i = tid; i < n; i += nt) {
      const unsigned long long key = keys[i];
      if ((key & mask) == prefix) {
        lo = min(lo, key);
        hi = max(hi, key);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, o));
      hi = max(hi, __shfl_xor_sync(FULL, hi, o));
    }
    if (tid == 0) {
      kmin = ~0ull;
      kmax = 0;
    }
    __syncthreads();
    if (lane == 0) {
      atomicMin(&kmin, lo);
      if (both) atomicMax(&kmax, hi);
    }
    __syncthreads();
  };
  uint64_t kth;
  if (splits == 1) {
    for (int x = tid; x < k; x += nt) buf[x] = keys[x];
  } else {
    reduce_min_max(0, 0, true);
    const uint64_t lo = kmin, hi = kmax;
    if (lo == hi) {
      kth = lo;
    } else {
      const int top = 63 - __clzll(lo ^ hi);
      uint64_t mask = top == 63 ? 0 : ~((uint64_t(2) << top) - 1);
      uint64_t prefix = hi & mask;
      int want = k;
      for (int shift = max(top - 7, 0);; shift = max(shift - 8, 0)) {
        if (tid < BINS) hist[tid] = 0;
        __syncthreads();
#pragma unroll 4
        for (long long i = tid; i < n; i += nt) {
          const uint64_t key = keys[i];
          if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
        }
        __syncthreads();
        // threads 0..255: thread t counts digit 255 - t (the largest first)
        const uint32_t c = tid < BINS ? hist[255 - tid] : 0;
        uint32_t incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t x = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += x;
        }
        if (tid < BINS && lane == 31) wsum[warp] = incl;
        __syncthreads();
        for (int w = 0; w < warp && tid < BINS; ++w) incl += wsum[w];
        const uint32_t excl = incl - c;
        if (tid < BINS && excl < uint32_t(want) && uint32_t(want) <= incl) {
          pick_bin = 255 - tid;
          pick_above = excl;
          pick_cnt = c;
        }
        __syncthreads();
        want -= int(pick_above);
        prefix |= uint64_t(pick_bin) << shift;
        mask |= uint64_t(255) << shift;
        const bool all_in = int(pick_cnt) == want;
        __syncthreads();   // pick_* and the bins are read before they change
        if (all_in) {
          reduce_min_max(mask, prefix, false);
          kth = kmin;
          break;
        }
        if (shift == 0) {
          kth = prefix;
          break;
        }
      }
    }
    // every key above the k-th, then the k-th up to k (only the empty slot
    // can repeat)
    if (tid == 0) count = 0;
    __syncthreads();
#pragma unroll 4
    for (long long i = tid; i < n; i += nt) {
      const uint64_t key = keys[i];
      if (key > kth) buf[atomicAdd(&count, 1)] = key;
    }
    __syncthreads();
    for (int x = count + tid; x < k; x += nt) buf[x] = kth;
  }
  for (int x = k + tid; x < kp; x += nt) buf[x] = 0;   // below every key
  __syncthreads();
  // bitonic sort, largest first
  for (int size = 2; size <= kp; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int x = tid; x < kp / 2; x += nt) {
        const int i = 2 * stride * (x / stride) + (x % stride), j = i + stride;
        const uint64_t a = buf[i], b = buf[j];
        if ((i & size) == 0 ? b > a : a > b) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  for (int x = tid; x < k; x += nt) {
    const uint64_t key = buf[x];
    const float s = key_score(key);
    out_s[size_t(row) * k + x] = s;
    out_i[size_t(row) * k + x] = s > NEG_INF * 0.5f ? int(key_id(key)) : -1;
  }
}

struct ScanTag {};
struct StreamTag {};

cudaError_t launch_bf16(const void* q, const void* p, const void* col_valid, void* cand,
                        void* out_s, void* out_i, void* pools, void* scratch, int Q, int N, int d,
                        int k, int kp, int splits, int cols_per_split, float inv_tau, int stages,
                        int stage_keys, int layout, cudaStream_t st) {
  // a resident tile is spread exactly when it has at most 32 rows
  if (d < 8 || d % 8 != 0 || stages < 2 || stages > MAX_STAGES || k < 1 || kp < k || kp < 128 ||
      (kp & (kp - 1)) != 0 || pools == nullptr || stage_keys < 0 ||
      (stage_keys != 0 && (stage_keys < 2 * kp || stage_keys > STAGE_KEYS_MAX)) ||
      (kp > SORT_SMEM_KEYS && scratch == nullptr) ||
      splits < 1 || cols_per_split % HN != 0 ||
      (layout != STREAMED && layout != (Q <= HQ / 2 ? SPREAD : RESIDENT)))
    return cudaErrorInvalidValue;
  const int spread = layout == SPREAD;
  const ScanLayout L = scan_layout(d, layout, stages, stage_keys);
  if (L.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap tq, tp;
  const cuuint64_t q_dims[2] = {cuuint64_t(d), cuuint64_t(Q)};
  const cuuint64_t p_dims[2] = {cuuint64_t(d), cuuint64_t(N)};
  const cuuint64_t row_bytes[1] = {cuuint64_t(d) * 2};
  const cuuint32_t q_box[2] = {64, cuuint32_t(spread ? 8 : HQ)}, p_box[2] = {64, HN};
  cudaError_t err;
  if ((err = tensor_map_bf16<2>(&tq, q, q_dims, row_bytes, q_box)) != cudaSuccess ||
      (err = tensor_map_bf16<2>(&tp, p, p_dims, row_bytes, p_box)) != cudaSuccess)
    return err;
  const dim3 grid((Q + HQ - 1) / HQ, splits);
  const auto valid = static_cast<const uint8_t*>(col_valid);
  const auto keys = static_cast<uint64_t*>(cand), pool = static_cast<uint64_t*>(pools);
  if (layout == STREAMED) {
    if ((err = allow_smem_once<StreamTag>(reinterpret_cast<const void*>(topk_stream_kernel),
                                          SMEM_LIMIT)) != cudaSuccess)
      return err;
    topk_stream_kernel<<<grid, SCAN_THREADS, L.total, st>>>(
        tq, tp, valid, keys, pool, Q, N, d, k, kp, cols_per_split, inv_tau, stages, stage_keys);
  } else {
    if ((err = allow_smem_once<ScanTag>(reinterpret_cast<const void*>(topk_scan_kernel),
                                        SMEM_LIMIT)) != cudaSuccess)
      return err;
    topk_scan_kernel<<<grid, SCAN_THREADS, L.total, st>>>(
        tq, tp, valid, keys, pool, Q, N, d, k, kp, cols_per_split, inv_tau, spread, stages,
        stage_keys);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t sort_bytes = kp <= SORT_SMEM_KEYS ? size_t(kp) * 8 : 0;   // <= 32 KB
  // a row of few candidates takes a block of BINS threads (fewer to sync)
  const int threads = (long long)splits * k >= 8 * SELECT_THREADS ? SELECT_THREADS : BINS;
  topk_select_kernel<<<Q, threads, sort_bytes, st>>>(
      static_cast<const uint64_t*>(cand), static_cast<float*>(out_s), static_cast<int*>(out_i),
      static_cast<uint64_t*>(scratch), splits, k, kp);
  return cudaGetLastError();
}

// ============================================================================
// fp32: CUDA-core FMAs (no TF32), score tiles and row states in shared memory
// ============================================================================

constexpr int KPAD = 128;          // largest k held in shared memory
constexpr int STAGE_KP = 1024;     // largest kp sorted in shared staging
constexpr int BQ = 64;             // query rows per block
constexpr int BN = 128;            // index rows (score columns) per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLD = BN + 4;        // score tile row stride, floats
constexpr int BK = 32;             // d-chunk
constexpr int LD = BK + 1;         // odd stride: conflict-free column reads

// KPF: kp fixed at compile time (KPAD: states in shared memory), or 0 (kp
// given at run time: states in global scratch).
template <int KPF>
constexpr size_t split_smem_bytes() {
  return size_t(BQ + BN) * LD * sizeof(float)                  // q and p chunks
         + size_t(BQ) * SLD * sizeof(float)                    // score tile
         + size_t(BQ) * 2 * KPF * (sizeof(float) + sizeof(int))  // row states
         + size_t(BQ) * sizeof(int);                           // buffer counts
}

// The per-warp sort staging of the global-state path: 2*kp pairs a warp,
// scores then ids; none past STAGE_KP.
__host__ __device__ constexpr size_t stage_bytes(int kp) {
  return kp <= STAGE_KP ? size_t(WARPS) * 2 * kp * (sizeof(float) + sizeof(int)) : 0;
}

__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
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
  unsigned m = __ballot_sync(FULL, want);
  taken = want;
  if (m == 0) return cnt;
  if (cnt + __popc(m) > kp) {
    warp_merge<KPF>(rs, ri, cnt, lane, kp, sort_s, sort_i);
    cnt = 0;
    want = ok && better(s, id, rs[k - 1], ri[k - 1]);
    m = __ballot_sync(FULL, want);
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
// 16 bytes a load, zero past either edge. Needs d a multiple of 4 and a
// 16-byte aligned base. fetch() issues the loads; store() writes them to
// shared memory, so a chunk's loads can be in flight while the FMAs work on
// the previous one.
template <int ROWS>
struct Stage {
  static constexpr int PER_ROW = BK / 4;
  static constexpr int COUNT = ROWS * PER_ROW / THREADS;
  static_assert(ROWS * PER_ROW % THREADS == 0, "chunk must split evenly");
  uint4 v[COUNT];

  __device__ __forceinline__ void fetch(const float* __restrict__ src, int rows_total, int row0,
                                        int d, int k0) {
#pragma unroll
    for (int x = 0; x < COUNT; ++x) {
      const int t = threadIdx.x + x * THREADS;
      const int gr = row0 + t / PER_ROW, gc = k0 + (t % PER_ROW) * 4;
      v[x] = (gr < rows_total && gc < d)
                 ? __ldg(reinterpret_cast<const uint4*>(src + size_t(gr) * d + gc))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int x = 0; x < COUNT; ++x) {
      const int t = threadIdx.x + x * THREADS;
      const int r = t / PER_ROW, c = (t % PER_ROW) * 4;
      const float* e = reinterpret_cast<const float*>(&v[x]);
#pragma unroll
      for (int y = 0; y < 4; ++y) dst[r * LD + c + y] = e[y];
    }
  }
};

// The same chunk copied element by element, for any d and alignment.
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, float* dst,
                                           int rows_total, int row0, int nrows, int d, int k0) {
  for (int t = threadIdx.x; t < nrows * BK; t += THREADS) {
    const int r = t / BK, c = t % BK;
    const int gr = row0 + r, gc = k0 + c;
    dst[r * LD + c] = (gr < rows_total && gc < d) ? src[size_t(gr) * d + gc] : 0.f;
  }
}

// Score accumulator of a BQ x BN tile by CUDA-core FMAs (the tensor cores
// would round the inputs to TF32); each of 16 x 16 threads owns rows
// ty + 16i, columns tx + 16j.
struct Acc {
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
__device__ void score_tile(const float* __restrict__ q, const float* __restrict__ p, float* q_s,
                           float* p_s, float* score_s, int Q, int N, int d, int q0, int n0,
                           bool vec) {
  Acc acc;
  acc.zero();
  if (vec) {
    Stage<BQ> sq;
    Stage<BN> sp;
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

template <int KPF>
__global__ void __launch_bounds__(THREADS)
topk_split_kernel(const float* __restrict__ q, const float* __restrict__ p,
                  const uint8_t* __restrict__ col_valid,
                  float* __restrict__ cand_s, int* __restrict__ cand_i, int Q,
                  int N, int d, int k, int cols_per_split, float inv_tau,
                  int vec, float* __restrict__ state_s,
                  int* __restrict__ state_i, int kp_rt) {
  const int kp = KPF ? KPF : kp_rt;
  const size_t row_len = 2 * size_t(kp);
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + BQ * LD;
  float* score_s = p_s + BN * LD;
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

// One warp per row: folds its splits sorted lists of k candidates
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
      if (__ballot_sync(FULL, ok && !taken) != 0) break;
    }
  }
  if (cnt > 0) warp_merge<KPF>(rs, ri, cnt, lane, kp, sort_s, sort_i);
  for (int t = lane; t < k; t += 32) {
    const float s = rs[t];
    out_s[size_t(r) * k + t] = s;
    out_i[size_t(r) * k + t] = s > NEG_INF * 0.5f ? ri[t] : -1;
  }
}

template <int KPF>
cudaError_t launch_fp32(const void* q, const void* p, const void* col_valid, void* cand_s,
                        void* cand_i, void* out_s, void* out_i, void* state_s, void* state_i,
                        int Q, int N, int d, int k, int kp, int splits, int cols_per_split,
                        float inv_tau, int vec, cudaStream_t stream) {
  const size_t stage = KPF ? 0 : stage_bytes(kp);
  const size_t smem = split_smem_bytes<KPF>() + stage;
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel<KPF>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (stage > 0) {
    err = cudaFuncSetAttribute(topk_merge_kernel<KPF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(stage));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + BQ - 1) / BQ, splits);
  topk_split_kernel<KPF><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(p),
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

// Every kernel of the library, for kernel_attributes (ops.KERNELS, same order)
const void* const KERNELS[] = {
    reinterpret_cast<const void*>(topk_scan_kernel),
    reinterpret_cast<const void*>(topk_select_kernel),
    reinterpret_cast<const void*>(topk_split_kernel<KPAD>),
    reinterpret_cast<const void*>(topk_split_kernel<0>),
    reinterpret_cast<const void*>(topk_merge_kernel<KPAD>),
    reinterpret_cast<const void*>(topk_merge_kernel<0>),
    reinterpret_cast<const void*>(topk_stream_kernel),
};

}  // namespace

extern "C" {

int fused_topk_kpad() { return KPAD; }
int fused_topk_block_q() { return BQ; }
int fused_topk_block_n() { return BN; }

// bf16 q (Q, d) and p (N, d), row-major, d a multiple of 8, 16-byte aligned
// bases. col_valid: uint8 (N,) or null. cand: (Q, splits, k) uint64 keys;
// out_s/out_i: (Q, k).
// kp: the next power of two >= k, at least 128. pools: ceil(Q / 64) *
// splits * 2 * 64 * 2 * kp keys. scratch: Q * kp keys when kp > 4096, else
// null. stages: 2-4 a ring; stage_keys: 0 or at least 2 * kp; layout: 0
// resident (Q > 32) or 1 spread (Q <= 32), topk_scan_kernel, or 2 streamed,
// topk_stream_kernel; the plan's shared memory (fused_topk_scan_smem_bytes)
// must fit.
int fused_topk_bf16_launch(const void* q, const void* p, const void* col_valid, void* cand,
                           void* out_s, void* out_i, void* pools, void* scratch, int Q, int N,
                           int d, int k, int kp, int splits, int cols_per_split, float inv_tau,
                           int stages, int stage_keys, int layout, void* stream) {
  return int(launch_bf16(q, p, col_valid, cand, out_s, out_i, pools, scratch, Q, N, d, k, kp,
                         splits, cols_per_split, inv_tau, stages, stage_keys, layout,
                         static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a scan block under a plan (layout: 0 resident, 1
// spread (Q <= 32), 2 streamed); ops.scan_smem_bytes computes the same.
int fused_topk_scan_smem_bytes(int d, int layout, int stages, int stage_keys) {
  return scan_layout(d, layout, stages, stage_keys).total;
}

// fp32 q and p. cand_s/cand_i: (Q, splits, k) scratch; out_s/out_i: (Q, k).
// kp: KPAD for k <= KPAD (state_s/state_i null), else a power of two >= k
// with state_s/state_i (ceil(Q / BQ) * splits * BQ * 2 * kp) scratch. vec:
// d a multiple of 4 and 16-byte aligned bases (16-byte loads).
int fused_topk_fp32_launch(const void* q, const void* p, const void* col_valid, void* cand_s,
                           void* cand_i, void* out_s, void* out_i, void* state_s, void* state_i,
                           int Q, int N, int d, int k, int kp, int splits, int cols_per_split,
                           float inv_tau, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (kp == KPAD && k <= KPAD)
    return int(launch_fp32<KPAD>(q, p, col_valid, cand_s, cand_i, out_s, out_i, nullptr,
                                 nullptr, Q, N, d, k, kp, splits, cols_per_split, inv_tau, vec,
                                 st));
  // a power of two >= k and > KPAD, with its scratch
  if (kp <= KPAD || (kp & (kp - 1)) != 0 || kp < k || state_s == nullptr || state_i == nullptr)
    return int(cudaErrorInvalidValue);
  return int(launch_fp32<0>(q, p, col_valid, cand_s, cand_i, out_s, out_i, state_s, state_i, Q,
                            N, d, k, kp, splits, cols_per_split, inv_tau, vec, st));
}

// Registers a thread and local memory a thread (stack frame and spills) of
// kernel `which` (ops.KERNELS' order), as cudaFuncGetAttributes reports them
// on the current device.
int fused_topk_kernel_attributes(int which, int* regs, int* local_bytes) {
  if (which < 0 || which >= int(sizeof(KERNELS) / sizeof(KERNELS[0])))
    return int(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, KERNELS[which]);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return 0;
}

const char* fused_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
