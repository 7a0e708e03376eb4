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
//
// bf16 design (flash_fwd_kernel_wgmma<Plan<BQ, BK, D>>): one block per
// (BQ-row q tile, head, batch) with BQ / 64 consumer warpgroups of 64 query
// rows and one producer warpgroup; ops.tile_plan picks BQ and BK (64 or 128
// each) from the shape. One producer thread loads the q tile once and the K
// and V tiles into a ring of two stages by TMA (rank-4 tensor maps over (D,
// H, S, B) with the tensors' own strides, so the split heads of one fused
// qkv projection are read in place; GQA picks kv head h / (H / Hk)). Each
// stage has full barriers for K and V (TMA bytes) and empty barriers for K
// and V (one arrival per consumer warp): a K tile is released as soon as its
// scores have landed, so the next one loads behind the softmax and the value
// product. Tiles land 128-byte swizzled, 64 columns (128 bytes) a chunk; TMA
// zero-fills past D (D = 80 lands as two chunks, the second mostly zeros).
// Each consumer warpgroup computes S = Q K^T with wgmma (both operands in
// shared memory, K-major, D / 16 k-steps), runs the online softmax in
// registers with scale * log2(e) folded into the logits and ex2 (a row's max
// over the 4 lanes that hold it by __shfl_xor_sync; the sum-exp is reduced
// once, at the end), rounds p to bf16 in registers and feeds them as wgmma's
// register A operand to O += P V (V the MN-major B operand, N = D). S, P and
// O never leave registers inside the KV loop; O is rescaled there. The
// per-element masks run only on tiles that need them: causal tiles that
// reach past the warpgroup's first row, and tiles with masked (kv_mask) or
// past-the-edge columns (p = 0 exactly there); the others only scale. For
// causal rows, KV tiles wholly after the q tile's last row are not loaded
// once every row of the tile has a visible key at or before it (their -1e30
// logits then add exactly 0; a row with no visible key walks every tile, as
// the plain version averages over every column), and a warpgroup skips the
// products of tiles wholly after its own last row. Causal q tiles are issued
// longest first. The epilogue divides by max(l, 1e-30), stages the
// warpgroup's rows in its part of the q tile and writes them out in 16-byte
// stores (rows past Sq are not stored).
//
// Registers: a consumer thread holds S (BK / 2 fp32), P (BK / 4 bf16 pairs)
// and O (D / 2 fp32) with its row statistics; the producer warpgroup holds
// little. ptxas fits every plan without spilling (chip_smoke.py reports the
// registers and spills of each instantiation and fails on a spill). 128 x
// 128 tiles at D = 128 fit only because a warpgroup's two products run one
// after the other. What it does not do yet: overlap one tile's softmax with
// the next tile's score product inside a warpgroup (S, P and O of a 128-key
// tile live together need about 190 registers and spill; the two
// warpgroups of BQ = 128, or two blocks of BQ = 64 on one SM, interleave
// only as the scheduler finds them), move registers from the producer to
// the consumers (setmaxnreg), a persistent grid, or a TMA store of O.
//
// fp32 inputs (flash_fwd_kernel_fp32) keep a CUDA-core FMA path without TF32
// rounding: one block of 4 warps per 64-row q tile, 64-column KV tiles by
// cp.async one step ahead, scores, probabilities and the accumulator in
// shared memory.
//
// Plain C interface for ctypes: pointers and the stream are void*, strides
// are in elements, the launch returns cudaGetLastError(). Nothing is
// allocated or synchronised here; ops.py allocates the output and makes the
// 16-byte aligned copies TMA needs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;

// ============================================================================
// bf16: TMA ring, wgmma, register tiles
// ============================================================================

template <int BQ_, int BK_, int D_>
struct Plan {
  static constexpr int BQ = BQ_, BK = BK_, D = D_;
  static constexpr int NWG = BQ / 64;              // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);  // and the producer warpgroup
  static constexpr int NC = (D + 63) / 64;         // 64-column (128-byte) chunks
  static constexpr int NKS = D / 16;               // k-steps of the score product
  static constexpr int STAGES = 2;
  static constexpr int CHUNK_Q = BQ * 128, CHUNK_KV = BK * 128;   // bytes
  static constexpr int Q_BYTES = NC * CHUNK_Q, KV_BYTES = NC * CHUNK_KV;
  static constexpr int OFF_KV = Q_BYTES;   // stage s: K at OFF_KV + 2 s KV_BYTES, V after it
  static constexpr int OFF_BAR = OFF_KV + 2 * STAGES * KV_BYTES;
  // q; then a stage's K full, V full, K empty, V empty
  static constexpr int N_BARS = 1 + 4 * STAGES;
  static constexpr int SMEM = OFF_BAR + 8 * N_BARS + 1024;   // + slack to align the base
  // Blocks a SM: two of one consumer warpgroup where their shared memory
  // fits (228 KB a SM, 1 KB of it reserved a block), else one. Two holds
  // ptxas to 128 registers a thread. Measured on an H100 (bench.py, 700 W):
  // with a minimum of one block instead, the 64 x 128 plan at D = 64 takes
  // 133 registers, only one block fits a SM, and the BERT passage pass (B =
  // 8, S = 256, H = 12) runs in 0.0266 ms instead of 0.0199 ms.
  static constexpr int MIN_BLOCKS = NWG == 1 && 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(BQ == 64 || BQ == 128, "BQ is 64 or 128");
  static_assert(BK == 64 || BK == 128, "BK is 64 or 128");
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "D is a multiple of 16 up to 128");
  static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");
};

// Shared-memory addresses of one block's tiles and barriers.
template <class P>
struct Smem {
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const { return base + P::OFF_KV + 2u * s * P::KV_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + P::KV_BYTES; }
  __device__ uint32_t bar_q() const { return base + P::OFF_BAR; }
  __device__ uint32_t full_k(int s) const { return bar_q() + 8u * (1 + s); }
  __device__ uint32_t full_v(int s) const { return bar_q() + 8u * (1 + P::STAGES + s); }
  __device__ uint32_t empty_k(int s) const { return bar_q() + 8u * (1 + 2 * P::STAGES + s); }
  __device__ uint32_t empty_v(int s) const { return bar_q() + 8u * (1 + 3 * P::STAGES + s); }
};

// S = Q K^T for this warpgroup's 64 rows and the BK keys of one stage: D / 16
// k-steps of wgmma, both operands K-major in shared memory (issued, not
// waited for).
template <class P>
__device__ __forceinline__ void issue_scores(float* sacc, uint32_t q_s, uint32_t k_s) {
#pragma unroll
  for (int kst = 0; kst < P::NKS; ++kst) {
    const uint32_t chunk = kst / 4, off = (kst % 4) * 32u;   // 16 elements into the 128-byte row
    wgmma_ss<P::BK>(sacc, desc_sw128(q_s + chunk * P::CHUNK_Q + off, 16, 1024),
                    desc_sw128(k_s + chunk * P::CHUNK_KV + off, 16, 1024), kst > 0);
  }
}

// O += P V: P in registers (bf16, the score tile's layout), V the MN-major
// B operand, D columns (issued, not waited for)
template <class P>
__device__ __forceinline__ void issue_values(float* oacc, const uint32_t* pk, uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < P::BK / 16; ++kk)
    wgmma_rs<P::D>(oacc, &pk[4 * kk], desc_sw128(v_s + kk * 2048u, P::CHUNK_KV, 1024));
}

// The online softmax of one score tile in registers, in the log2 domain:
// masks where the tile needs them, the new running max of rows a and b
// (reduced over the 4 lanes that hold a row), p = 2^(s - m) in place of
// the scores, l = l * corr + this thread's sum of p, and corr, the factor
// the accumulator is rescaled by.
template <class P>
__device__ __forceinline__ void softmax_tile(float* sacc, float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& corr_a, float& corr_b, int kv0,
                                             int Skv, const uint8_t* mask, int causal, int ra,
                                             int rb, int rw0, int t, float scale_log2) {
  constexpr int BK = P::BK;
  constexpr uint32_t FULL = BK / 4 == 32 ? 0xffffffffu : (1u << (BK / 4)) - 1u;
  // column states: bit 2i + e for column kv0 + 8i + 2t + e
  uint32_t live = FULL;
  if (mask || kv0 + BK > Skv) {
    live = 0;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + 8 * i + 2 * t + e;
        if (col < Skv && (!mask || mask[col])) live |= 1u << (2 * i + e);
      }
  }
  // per element only on a tile with masked or past columns, or with a
  // causal column after this warpgroup's first row
  const bool per_element =
      (causal && kv0 + BK - 1 > rw0) || !__all_sync(0xffffffffu, live == FULL);
  if (per_element) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * i + 2 * t + (e & 1);
        const int row = (e & 2) ? rb : ra;
        const bool vis = ((live >> (2 * i + (e & 1))) & 1u) && !(causal && col > row);
        // past the edge: p = 0 exactly; masked: the finite sentinel
        sacc[4 * i + e] = col >= Skv ? -INFINITY : vis ? sacc[4 * i + e] * scale_log2 : NEG_INF;
      }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] *= scale_log2;
  }
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  corr_a = ex2(m_a - mx_a);
  corr_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    sacc[4 * i] = ex2(sacc[4 * i] - mx_a);
    sacc[4 * i + 1] = ex2(sacc[4 * i + 1] - mx_a);
    sacc[4 * i + 2] = ex2(sacc[4 * i + 2] - mx_b);
    sacc[4 * i + 3] = ex2(sacc[4 * i + 3] - mx_b);
    sum_a += sacc[4 * i] + sacc[4 * i + 1];
    sum_b += sacc[4 * i + 2] + sacc[4 * i + 3];
  }
  l_a = l_a * corr_a + sum_a;   // this thread's columns; the 4 lanes add up at the end
  l_b = l_b * corr_b + sum_b;
}

// The accumulator rescaled by corr, and p rounded to bf16 and packed as the
// register A operand of the next value product.
template <class P>
__device__ __forceinline__ void rescale_and_pack(float* oacc, uint32_t* pk, const float* sacc,
                                                 float corr_a, float corr_b) {
#pragma unroll
  for (int i = 0; i < P::D / 8; ++i) {
    oacc[4 * i] *= corr_a;
    oacc[4 * i + 1] *= corr_a;
    oacc[4 * i + 2] *= corr_b;
    oacc[4 * i + 3] *= corr_b;
  }
#pragma unroll
  for (int i = 0; i < P::BK / 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(sacc[2 * i], sacc[2 * i + 1]);
    pk[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ kv_mask,
                       __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int group,
                       float scale_log2, int causal) {
  constexpr int BQ = P::BQ, BK = P::BK, D = P::D, STAGES = P::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const Smem<P> sm{smem_u32(smem)};

  const int h = blockIdx.x % H, b = blockIdx.x / H, hk = h / group;
  const int qt = causal ? int(gridDim.y) - 1 - int(blockIdx.y) : int(blockIdx.y);
  const int row0 = qt * BQ;
  const int last_row = min(row0 + BQ, Sq) - 1;
  const uint8_t* mask = kv_mask ? kv_mask + size_t(b) * Skv : nullptr;

  // Causal: every row of the tile has a visible key at or before it when
  // one lies at or before row0; then no tile wholly after last_row is needed.
  int seen = 1;
  if (causal && mask) {
    int found = 0;
    for (int c = threadIdx.x; c <= min(row0, Skv - 1); c += P::THREADS) found |= mask[c];
    seen = __syncthreads_or(found);
  }
  int n_tiles = (Skv + BK - 1) / BK;
  if (causal && seen) n_tiles = min(n_tiles, last_row / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_q(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
      mbar_init(sm.empty_k(s), 4 * P::NWG);   // one arrival a consumer warp
      mbar_init(sm.empty_v(s), 4 * P::NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == P::NWG) {
    // ---- producer warpgroup: one thread issues every load, K of a tile
    // as soon as its slot's K is released, then V as soon as V's is
    if (threadIdx.x == P::NWG * 128) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      mbar_expect_tx(sm.bar_q(), P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < P::NC; ++c)
        tma_load_4d(&tq, sm.q() + c * P::CHUNK_Q, sm.bar_q(), 64 * c, h, row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;   // the first round passes at once
        mbar_wait(sm.empty_k(s), free_parity);
        mbar_expect_tx(sm.full_k(s), P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < P::NC; ++c)
          tma_load_4d(&tk, sm.k(s) + c * P::CHUNK_KV, sm.full_k(s), 64 * c, hk, j * BK, b);
        mbar_wait(sm.empty_v(s), free_parity);
        mbar_expect_tx(sm.full_v(s), P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < P::NC; ++c)
          tma_load_4d(&tv, sm.v(s) + c * P::CHUNK_KV, sm.full_v(s), 64 * c, hk, j * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows rw0 .. rw0 + 63
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rw0 = row0 + 64 * wg;
    const int rw_last = min(rw0 + 63, Sq - 1);
    const int ra = rw0 + 16 * warp + g, rb = ra + 8;   // this thread's two rows
    const uint32_t q_s = sm.q() + 64u * wg * 128u;   // this warpgroup's rows of each q chunk
    auto parity = [](int j) { return uint32_t((j / STAGES) & 1); };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // The tiles this warpgroup computes are a prefix of the block's: none
    // when it has no real row; under causal, once every row has a visible
    // key, not those wholly after its last row (they add exactly 0).
    int n_comp = n_tiles;
    if (rw_last < rw0)
      n_comp = 0;
    else if (causal && seen)
      n_comp = min(n_tiles, rw_last / BK + 1);

    float sacc[BK / 2], oacc[D / 2];
    uint32_t pk[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f, corr_a = 1.f, corr_b = 1.f;

    mbar_wait(sm.bar_q(), 0);
    for (int j = 0; j < n_comp; ++j) {
      const int s = j % STAGES;
      // S = Q K^T; K's slot is free again once the product has landed
      mbar_wait(sm.full_k(s), parity(j));
      fence_regs<BK / 2>(sacc);
      wgmma_fence();
      issue_scores<P>(sacc, q_s, sm.k(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sacc);
      release(sm.empty_k(s));
      softmax_tile<P>(sacc, m_a, m_b, l_a, l_b, corr_a, corr_b, j * BK, Skv, mask, causal, ra, rb,
                      rw0, t, scale_log2);
      rescale_and_pack<P>(oacc, pk, sacc, corr_a, corr_b);
      // O += P V
      mbar_wait(sm.full_v(s), parity(j));
      fence_regs<D / 2>(oacc);
      fence_regs<BK / 4>(pk);
      wgmma_fence();
      issue_values<P>(oacc, pk, sm.v(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(oacc);
      fence_regs<BK / 4>(pk);
      release(sm.empty_v(s));
    }
    // the block's other tiles: released as they land
    for (int j = n_comp; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(sm.full_k(s), parity(j));
      release(sm.empty_k(s));
      mbar_wait(sm.full_v(s), parity(j));
      release(sm.empty_v(s));
    }

    // ---- epilogue: O / max(l, 1e-30), staged in this warpgroup's rows of
    // the q tile (swizzled as TMA laid q out), then 16-byte stores
    if (rw0 < Sq) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
      uint8_t* stage = smem + 64 * wg * 128;
      const int r_a = 16 * warp + g;   // local rows r_a and r_a + 8; both are g modulo 8
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int chunk = i / 8, grp = (i % 8) ^ g;
        uint8_t* at = stage + chunk * P::CHUNK_Q + r_a * 128 + grp * 16 + t * 4;
        const __nv_bfloat162 va = __floats2bfloat162_rn(oacc[4 * i] / den_a, oacc[4 * i + 1] / den_a);
        const __nv_bfloat162 vb =
            __floats2bfloat162_rn(oacc[4 * i + 2] / den_b, oacc[4 * i + 3] / den_b);
        *reinterpret_cast<__nv_bfloat162*>(at) = va;
        *reinterpret_cast<__nv_bfloat162*>(at + 8 * 128) = vb;
      }
      if (wg == 0)   // barrier 0 is __syncthreads; one id a consumer warpgroup
        named_bar_sync<1, 128>();
      else
        named_bar_sync<2, 128>();
      constexpr int GROUPS = D / 8;   // 16-byte groups of an output row
      for (int x = tid; x < 64 * GROUPS; x += 128) {
        const int r = x / GROUPS, c = (x % GROUPS) * 8, row = rw0 + r;
        if (row < Sq) {
          const uint8_t* src =
              stage + (c / 64) * P::CHUNK_Q + r * 128 + ((((c % 64) / 8) ^ (r & 7)) * 16);
          *reinterpret_cast<uint4*>(o + ((size_t(b) * Sq + row) * H + h) * D + c) =
              *reinterpret_cast<const uint4*>(src);
        }
      }
    }
  }
}

// Rank-4 bf16 tensor map over (D, H, S, B) with element strides of the
// head, row and batch dims; boxes of 64 x 1 x rows x 1 (hopper.cuh: 128-byte
// swizzled, zero past each edge).
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int d, int heads, int rows, int batch,
                       long long sh, long long ss, long long sb, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(box_rows), 1};
  return tensor_map_bf16<4>(map, ptr, dims, strides, box);
}

template <class P>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
                     int B, int Sq, int Skv, int H, int Hk, const long long* qs,
                     const long long* ks, const long long* vs, float scale, int causal,
                     cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = tensor_map(&tq, q, P::D, H, Sq, B, qs[2], qs[1], qs[0], P::BQ)) != cudaSuccess ||
      (err = tensor_map(&tk, k, P::D, Hk, Skv, B, ks[2], ks[1], ks[0], P::BK)) != cudaSuccess ||
      (err = tensor_map(&tv, v, P::D, Hk, Skv, B, vs[2], vs[1], vs[0], P::BK)) != cudaSuccess)
    return err;
  const auto kernel = flash_fwd_kernel_wgmma<P>;
  if ((err = allow_smem_once<P>(reinterpret_cast<const void*>(kernel), P::SMEM)) != cudaSuccess)
    return err;
  const dim3 grid(unsigned(H) * unsigned(B), unsigned((Sq + P::BQ - 1) / P::BQ));
  constexpr float LOG2E = 1.4426950408889634f;
  flash_fwd_kernel_wgmma<P><<<grid, P::THREADS, P::SMEM, st>>>(
      tq, tk, tv, static_cast<const uint8_t*>(kv_mask), static_cast<__nv_bfloat16*>(o), Sq, Skv,
      H, H / Hk, scale * LOG2E, causal);
  return cudaGetLastError();
}

// Calls f(Plan<BQ, BK, D>{}) for a run-time (BQ, BK, D); false when the
// kernel has no such plan.
template <int BQ, int BK, class F>
bool with_d(int d, F& f) {
  switch (d) {
    case 16: f(Plan<BQ, BK, 16>{}); return true;
    case 32: f(Plan<BQ, BK, 32>{}); return true;
    case 48: f(Plan<BQ, BK, 48>{}); return true;
    case 64: f(Plan<BQ, BK, 64>{}); return true;
    case 80: f(Plan<BQ, BK, 80>{}); return true;
    case 96: f(Plan<BQ, BK, 96>{}); return true;
    case 112: f(Plan<BQ, BK, 112>{}); return true;
    case 128: f(Plan<BQ, BK, 128>{}); return true;
  }
  return false;
}

template <class F>
bool with_plan(int bq, int bk, int d, F&& f) {
  if (bq == 64 && bk == 64) return with_d<64, 64>(d, f);
  if (bq == 64 && bk == 128) return with_d<64, 128>(d, f);
  if (bq == 128 && bk == 64) return with_d<128, 64>(d, f);
  if (bq == 128 && bk == 128) return with_d<128, 128>(d, f);
  return false;
}

// ============================================================================
// fp32: CUDA-core FMAs (no TF32), tiles in shared memory
// ============================================================================

constexpr int FBQ = 64;          // query rows per block
constexpr int FBK = 64;          // keys per KV tile
constexpr int FTHREADS = 128;    // thread (ty, tx) = (t / 16, t % 16): rows ty + 8i, columns tx + 16j
constexpr int SLD = FBK + 4;     // score tile row stride, floats
enum : uint8_t { PAST = 0, MASKED = 1, LIVE = 2 };   // KV column states
struct Fp32Tag {};   // allow_smem_once's tag of the fp32 kernel

// q, k, v tile row stride, floats: 16-byte rows (cp.async), skewed banks
__host__ __device__ constexpr int tile_ld(int d) { return d + 4; }

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory, in order: q, k, v tiles (64 rows x tile_ld), the scores
// (p written over them), the accumulator (FBQ x (D + 4)), m, l, corr per
// row, and the KV tile's column states.
struct Layout {
  size_t k, v, s, o, m, l, c, cols, total;
};

__host__ __device__ Layout layout_fp32(int d) {
  Layout L;
  const size_t tile = align128(size_t(FBQ) * tile_ld(d) * sizeof(float));
  L.k = tile;
  L.v = L.k + tile;
  L.s = L.v + tile;
  L.o = L.s + align128(size_t(FBQ) * SLD * sizeof(float));
  L.m = L.o + align128(size_t(FBQ) * (d + 4) * sizeof(float));
  L.l = L.m + align128(FBQ * sizeof(float));
  L.c = L.l + align128(FBQ * sizeof(float));
  L.cols = L.c + align128(FBQ * sizeof(float));
  L.total = L.cols + align128(FBK);
  return L;
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
// memory (row stride ld), zero from row `valid` on: asynchronous 16-byte
// copies (ops.py makes base and strides 16-byte aligned), complete after
// the cp_async_wait that covers their group and a barrier.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, long long row_stride,
                                          int valid, int d, int ld, float* dst) {
  const int per_row = d / 4;
  for (int t = threadIdx.x; t < 64 * per_row; t += FTHREADS) {
    const int r = t / per_row, c = (t - r * per_row) * 4;
    if (r < valid)
      cp_async16(dst + r * ld + c, src + r * row_stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// S (FBQ x FBK, unscaled) = Q K^T into s_s
__device__ __forceinline__ void scores(const float* q_s, const float* k_s, float* s_s, int d,
                                       int ld) {
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

// O = O * corr + P V
__device__ __forceinline__ void accumulate(const float* p_s, const float* v_s, float* o_s,
                                           const float* c_s, int d, int ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int old = d + 4;
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    const float corr = c_s[r];
    for (int c = tx; c < d; c += 16) {
      float acc = o_s[r * old + c] * corr;
      for (int kk = 0; kk < FBK; ++kk) acc = fmaf(p_s[r * SLD + kk], v_s[kk * ld + c], acc);
      o_s[r * old + c] = acc;
    }
  }
}

__global__ void __launch_bounds__(FTHREADS)
flash_fwd_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                      float* __restrict__ o, int Sq, int Skv, int H, int group, int d,
                      long long qsb, long long qss, long long qsh, long long ksb, long long kss,
                      long long ksh, long long vsb, long long vss, long long vsh, float scale,
                      int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * FBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int ld = tile_ld(d), old = d + 4;
  const Layout L = layout_fp32(d);
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);   // scores, then p over them
  float* o_s = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* c_s = reinterpret_cast<float*>(smem + L.c);
  uint8_t* cols_s = smem + L.cols;   // per KV column: PAST the edge, MASKED or LIVE

  const int q_rows = min(FBQ, Sq - row0);
  const int last_row = row0 + q_rows - 1;
  const int n_tiles = (Skv + FBK - 1) / FBK;
  for (int x = threadIdx.x; x < FBQ * old; x += FTHREADS) o_s[x] = 0.f;
  for (int r = threadIdx.x; r < FBQ; r += FTHREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const uint8_t* mask = kv_mask ? kv_mask + size_t(b) * Skv : nullptr;
  const float* k_b = k + b * ksb + hk * ksh;
  const float* v_b = v + b * vsb + hk * vsh;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Copies run one step ahead: q and the first k tile in one group, each v
  // tile in the next; the next k tile loads during this tile's softmax and
  // value product, the next v tile during the next tile's scores and
  // softmax, so every wait below leaves exactly the newest group in flight
  // (groups are committed even when empty).
  load_tile(q + b * qsb + row0 * qss + h * qsh, qss, q_rows, d, ld, q_s);
  load_tile(k_b, kss, min(FBK, Skv), d, ld, k_s);
  cp_async_commit();
  load_tile(v_b, vss, min(FBK, Skv), d, ld, v_s);
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * FBK, next = kv0 + FBK;
    cp_async_wait<1>();  // q and this tile's k have landed
    __syncthreads();
    if (threadIdx.x < FBK) {
      const int col = kv0 + threadIdx.x;
      cols_s[threadIdx.x] = col >= Skv ? PAST : (!mask || mask[col]) ? LIVE : MASKED;
    }
    scores(q_s, k_s, s_s, d, ld);
    __syncthreads();     // k_s is free
    if (next < Skv) load_tile(k_b + next * kss, kss, min(FBK, Skv - next), d, ld, k_s);
    cp_async_commit();

    // online softmax: lanes 2i and 2i+1 of warp w share row 16w + i, each
    // taking every other column
    {
      const int r = w * 16 + (lane >> 1), row = row0 + r, half = lane & 1;
      float s[FBK / 2];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < FBK / 2; ++i) {
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
      for (int i = 0; i < FBK / 2; ++i) {
        const float p = expf(s[i] - m_new);
        sum += p;
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
    accumulate(s_s, v_s, o_s, c_s, d, ld);
    __syncthreads();     // v_s and s_s are free
    if (next < Skv) load_tile(v_b + next * vss, vss, min(FBK, Skv - next), d, ld, v_s);
    cp_async_commit();
    if (causal && next > last_row) {
      // every later tile is after every row of this one: its logits are all
      // -1e30 and add exactly 0 to a row that has seen a visible key
      bool seen = true;
      for (int r = threadIdx.x; r < q_rows; r += FTHREADS) seen = seen && m_s[r] > NEG_INF;
      if (__syncthreads_and(seen)) break;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int r = w; r < q_rows; r += FTHREADS / 32) {
    const float l = fmaxf(l_s[r], 1e-30f);
    float* dst = o + ((size_t(b) * Sq + row0 + r) * H + h) * d;
    for (int c = lane; c < d; c += 32) dst[c] = o_s[r * old + c] / l;
  }
}

cudaError_t fwd_fp32(const void* q, const void* k, const void* v, const void* kv_mask, void* o,
                     int B, int Sq, int Skv, int H, int Hk, int d, const long long* qs,
                     const long long* ks, const long long* vs, float scale, int causal,
                     cudaStream_t st) {
  const Layout L = layout_fp32(d);
  // the limit once, at the largest layout (D = 128)
  const cudaError_t err = allow_smem_once<Fp32Tag>(
      reinterpret_cast<const void*>(flash_fwd_kernel_fp32), int(layout_fp32(128).total));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FBQ - 1) / FBQ, H, B);
  flash_fwd_kernel_fp32<<<grid, FTHREADS, L.total, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<float*>(o), Sq, Skv, H, H / Hk, d,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike). kv_mask: uint8 (B, Skv),
// contiguous, or null (every key visible). o: contiguous (B, Sq, H, D).
// Strides of q, k, v in elements: batch, row, head (the last dimension is
// contiguous); bases and strides 16-byte aligned. block_q, block_k: the
// bf16 tile plan (64 or 128 each; ops.tile_plan); fp32 takes 64 and 64.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               const void* kv_mask, void* o, int B, int Sq, int Skv,
                               int H, int Hk, int d, long long qsb, long long qss,
                               long long qsh, long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh, float scale,
                               int causal, int dtype, int block_q, int block_k, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 128 || Hk < 1 || H % Hk != 0)
    return int(cudaErrorInvalidValue);
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cudaError_t err = cudaErrorInvalidValue;
    with_plan(block_q, block_k, d, [&](auto plan) {
      err = fwd_bf16<decltype(plan)>(q, k, v, kv_mask, o, B, Sq, Skv, H, Hk, qs, ks, vs, scale,
                                     causal, st);
    });
    return int(err);
  }
  if (dtype == 0 && block_q == FBQ && block_k == FBK)
    return fwd_fp32(q, k, v, kv_mask, o, B, Sq, Skv, H, Hk, d, qs, ks, vs, scale, causal, st);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory one block asks for under a plan (0: no such plan);
// ops.smem_bytes_mirror computes the same from the shape.
int flash_attention_smem_bytes(int dtype, int block_q, int block_k, int d) {
  if (dtype == 0)
    return block_q == FBQ && block_k == FBK && d % 16 == 0 && d >= 16 && d <= 128
               ? int(layout_fp32(d).total)
               : 0;
  int bytes = 0;
  if (dtype == 1) with_plan(block_q, block_k, d, [&](auto plan) { bytes = decltype(plan)::SMEM; });
  return bytes;
}

// Registers a thread and local memory a thread (stack frame and spills) of
// the kernel a plan launches, as cudaFuncGetAttributes reports them on the
// current device, whether or not this process built the library.
int flash_attention_kernel_attributes(int dtype, int block_q, int block_k, int d, int* regs,
                                      int* local_bytes) {
  if (flash_attention_smem_bytes(dtype, block_q, block_k, d) == 0)
    return int(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(flash_fwd_kernel_fp32);
  if (dtype == 1)
    with_plan(block_q, block_k, d, [&](auto plan) {
      kernel = reinterpret_cast<const void*>(flash_fwd_kernel_wgmma<decltype(plan)>);
    });
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  return 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
