#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
it still starts on the card.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one JSON line each:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA
               versions; TF32 matmuls are switched off and the state stated.
  2. build   - every CUDA kernel of the port, built from the checkout's
               sources (one nvcc per kernel, all started together).
  3. kernels - each kernel against its plain PyTorch version on the card:
               fused_topk at the eval_topk shape (Q=2048, N=2^20-37 ragged,
               d=768, bf16, k=100, some columns masked) and the serve_topk
               shape (Q=32, N=2^20), plus a tie case and a k > n_valid case,
               and k = 129, 256 and 1000 at both shapes plus a k > n_valid
               case there; each bf16 call at those shapes must report the
               Hopper kernel (ops.fused_topk.paths); the lm phase's eval
               search (Q=256, N=4096, k=20) and Q=2048, k=100 at d=2048
               bf16 must report the Hopper path too (the query chunks
               streamed through the rings: rows past a resident tile),
               each timed beside the route it took before (fp32_widened:
               the rows widened to the fp32 kernel); every fused_topk
               kernel's registers and local memory are held to ptxas's log
               (a bf16 one that spills fails the run);
               the fused_infonce forward, dQ and dP kernels at the two
               shapes of a contaccum_bf16 chunk (M=8 local queries with
               some labels out of range, and M=2048 query-bank rows, against
               N=2064 columns of which the last 1000 are masked; d=768,
               bf16), M=2048 again with every column valid, the same three
               at a contaccum_mined chunk's N=2096 (4 mined columns a
               query), the lm phase's chunk at d=2048 (M=8 and M=2048,
               N=2064, 1000 masked and all valid, bf16: the forward and
               dP must take the Hopper path, the split kernels at M=8, the
               many-row forward and the cluster dP at M=2048, and dQ at
               M=8 its split kernel; each timed in turns with the wmma
               kernels it took before and held to the plain version on
               both routes, failing unless faster, the M=8 dQ also unless
               faster than the dense backend), an fp32 case
               and a small ragged case; kernel, plain,
               library and bound times, forward and backward apart; the
               forward and dP at every M=2048 case and all three at every
               M=8 case must take the Hopper
               kernels (ops.fused_infonce_fwd.paths, .dq.paths, .dp.paths),
               and every fused_infonce kernel's registers and
               local memory are held to ptxas's log (a bf16 one that
               spills, or a Hopper one with local memory, fails the run); the
               flash_attention kernel at the BERT query and passage passes
               (B=8, S=32 and 256, H=12, D=64, bf16, ragged key masks, q, k
               and v the strided splits of one fused qkv tensor), a row with
               every key masked, an fp32 case, the LM prefill shapes no
               path runs yet (internlm2-1.8b: S=4096, H=16, Hk=8, D=128;
               stablelm-3b: S=2048, H=Hk=32, D=80; causal, bf16), the
               lm phase's passes (B=8, S=32 and 256, H=16, Hk=8, D=128,
               causal, bf16), the lm_train phase's (B=8, S=4096, H=16,
               Hk=8, D=128, causal, bf16) and the moe_train phase's (B=8,
               S=4096, H=Hk=16, D=128; the lm_serve and moe_serve phases
               check and time S=32768); kernel
               (also with the host's enqueue), plain, library
               (scaled_dot_product_attention) and bound times, TFLOP/s and
               the tile plan at each shape, and the registers, shared
               memory, local memory and spills of every flash_attention
               kernel, from the card and from ptxas's log (a bf16 kernel
               with local memory or spills fails the run);
               the embedding_bag kernel at the full dcn-v2 stacked table
               (187,767,808 x 16 fp32, 12.0 GB, past 2^31 elements) with
               65536 x 26 bags of the MLPerf DLRM-DCNv2 multi-hot sizes,
               at D=128 (dlrm-mlperf's width, rows cut to 2^24) in fp32
               and bf16, with empty bags, and its backward at a cut size;
               kernel, plain, library (F.embedding_bag) and bound times.
  4. serve   - the port's main path at the full width of dpr-bert-base, in
               the serve_topk cell (configs/dpr_bert_base.py): a seeded
               Retriever (bf16_banks, top_k=100) encodes 32768 passages of
               the synthetic corpus, the index is filled up to the cell's
               2^20 rows with seeded random rows, and a BatchingServer
               (max_batch=32, the cell's batch) answers single-query
               requests from client threads. The kernel's launch count must
               equal the number of coalesced batches, each through the
               Hopper kernel (its path count); every answer is
               checked, and one batch is held against the plain search on
               the same query reps.
  5. train   - the port's training path at the full width of dpr-bert-base,
               in the contaccum_bf16 cell: a seeded encoder (remat="full",
               bf16_banks), ContAccum with K=16 chunks of 8 and two banks of
               2048, the fused loss kernels, AdamW with warmup and linear
               decay, a ShardedLoader over the synthetic corpus and a Trainer
               checkpointing to a temporary directory, for TRAIN_STEPS
               steps (the banks wrap). Checks: finite losses, full banks and
               2063 negatives at the end, launches of exactly 2, 1 and 2 x
               16 x steps (forward, dQ, dP), every forward, dQ and dP
               launch on the Hopper path, one step on the dense backend
               against the fused one from the same state and batch, a second
               Trainer resuming from the saved step, and a Top@k eval through
               the fused search kernel (every search through the Hopper
               kernel).
  6. mine    - the contaccum_mined cell at its full shape (16 chunks of 8,
               dual banks of 2048, 1 hard + 4 mined columns a query: 2096
               columns a chunk) with contaccum_bf16's precision and loss
               kernels, and a HardNegativeMiner over 32768 passages (top 32
               through fused_topk, band [1, 32), a refresh every 4 steps):
               an async turn (the loop on a high-priority stream, the
               refresh on the miner's stream, its encodes as CUDA graphs),
               checkpointed and resumed with a new miner, then a sync turn,
               from the same seeded state with the train phase's full banks,
               MINE_STEPS steps each. Each turn's train_s (until its last refresh
               lands), step times and which steps had a refresh in flight,
               each refresh's encode, search and filter times, losses,
               launches by path, peak memory. Checks: finite losses, full
               banks and 2095 negatives at every step, every fused_infonce
               launch and every miner search (128 a refresh) on the Hopper
               path, gold never mined, the two turns' first tables (mined
               from the same params) identical, one mined step on the dense
               backend against the fused one from the same state and batch,
               the resumed miner holding a table the run published, one of
               the miner's searches against ref.py (scores, and ids at the
               clear slots) and its shape on seeded random rows; that
               search shape (Q=256, N=32768, k=32) timed alone with plain,
               library and bound beside it; the overlap: train_s saved
               against the sync turn's refresh time, in all and per
               refresh the async turn did, and the steps with a refresh in
               flight against the others (MINE_SAVED_SHARE,
               MINE_STEP_RATIO).
  7. flash   - the same towers with attention_impl="pallas" (the attention
               of every layer through the flash_attention kernel): their
               passage reps are held against the plain-attention towers on
               the same params, the serve phase runs again on them (12
               launches per encode batch and per coalesced batch, none on
               the plain towers' run; the phase line pairs the two runs'
               qps, p50 and p99); then contaccum_bf16 trains for
               FLASH_TRAIN_STEPS steps (finite losses, exactly 16 chunks x 3
               tower passes x 12 layers x 2 (remat) launches a step), and
               one step with flash towers is held against plain towers from
               the same state and batch; a profiled step must show the
               kernel's time and launches.
  8. lm      - the LM retriever: internlm2-1.8b dual encoders at full width
               (d_model 2048, 16 heads, 8 KV heads of 128, d_ff 8192, vocab
               92544) cut to LM_LAYERS of their 24 layers, shared=True,
               bf16_banks, attention through the flash kernel (causal,
               GQA), remat="full", trained LM_STEPS steps in the
               contaccum_bf16 cell by a Trainer, then a Top@k eval through
               the fused search. Checks: finite losses; flash_attention
               launches of exactly 16 chunks x 3 tower passes x LM_LAYERS x
               2 (remat) a step, all on the Hopper path; fused_infonce
               launches of exactly 2, 1 and 2 x 16 x steps (forward, dQ,
               dP), all on the Hopper path, and no wmma loss kernel in the
               profiled step (its loss kernels' ms by name);
               every eval search on the Hopper path; one step with
               attention_impl="chunked" and one on the dense loss backend
               against the flash, fused step from the same state and batch.
               Peak memory, step times, a profiled step's busy share and the
               phase's seconds.
  9. lm_train - causal-LM training: internlm2-1.8b's train_4k cell
               (launch/steps.py's train program; 256 sequences of 4096
               tokens a step) at full width, cut to LM_LAYERS of 24 layers,
               LM_TRAIN_MICRO_BATCHES microbatches of 8 sequences (the
               config's 4 would not fit one card), attention through the
               flash kernel (causal GQA at S=4096), remat="full", seeded
               weights and uniform seeded tokens, LM_TRAIN_STEPS steps.
               Checks: the first microbatch's lm_loss and gradient through
               the flash kernel against chunked attention (loss within
               LM_TRAIN_LOSS_RTOL, each gradient leaf within
               PARITY_GRAD_RTOL of its largest |g|; the same comparison at
               the next seed is recorded, not held); the step-0 loss within
               LM_TRAIN_LOSS_SLACK of ln V + 1/2; finite losses; state.step
               at LM_TRAIN_STEPS; exactly LM_LAYERS x 2 (remat) x m flash
               launches a step, all on the Hopper path; no fused_infonce
               or fused_topk launch. Median step, tokens/s, the model-flops
               share of the bf16 peak, peak memory, and one microbatch's
               forward and backward profiled after the steps (kernel ms,
               busy share, launches, top kernels, the flash kernel's ms).
 10. lm_serve - LM serving: internlm2-1.8b's prefill_32k and decode_32k
               cells (launch/steps.py's prefill and decode programs) at full
               width and all 24 layers, both batches cut to LM_SERVE_BATCH
               sequences of 32768 tokens (the KV cache: 25.8 GB), attention
               through the flash kernel (causal GQA at S=32768), seeded
               weights and uniform seeded tokens: the prefill cell's fn
               timed LM_SERVE_PREFILL_RUNS times after a warm-up; a prompt
               of LM_SERVE_PROMPT tokens prefilled into 32768 slots and
               LM_SERVE_DECODE teacher-forced decode steps through the
               decode cell's fn, each timed; one forward over all the
               tokens, its logits at the generation's positions only; the
               flash kernel at (8, 32768, 16, 8, 128) held to its plain
               version on its first and last FLASH_SERVE_ROWS query rows,
               timed beside scaled_dot_product_attention and its bound;
               one decode step and one prefill profiled. Checks: the
               generation's logits against the forward's (mean and largest
               |difference| within LM_SERVE_TF_MEAN and LM_SERVE_TF_MAX),
               every logit finite, cache.length at prompt + decode steps,
               the cache's data_ptr unchanged by the decode, exactly 24
               flash launches a prefill or forward and none a decode step,
               all on the Hopper path, no fused_infonce or fused_topk
               launch, peak memory under LM_SERVE_PEAK_BYTES. Prefill
               seconds, tokens/s and model-flops share; decode ms a token,
               tokens/s, byte share, the plain decode attention's ms a layer
               and the params' cast; top-1 agreement; peak memory.
 11. moe_serve - MoE serving: olmoe-1b-7b's prefill_32k and decode_32k
               cells at full width and all 16 layers (64 experts, top 8,
               capacity factor 1.25, groups of 1024; the dispatch and
               experts as JAX's one-hot and batched einsums), both batches
               cut to MOE_SERVE_BATCH sequences of 32768 tokens, attention
               through the flash kernel (causal MHA at S=32768), seeded
               weights and uniform seeded tokens: the prefill cell's fn
               timed MOE_SERVE_PREFILL_RUNS times after a warm-up; a prompt
               of MOE_SERVE_PROMPT tokens (whole groups) prefilled into
               32768 slots, its cache rows held to the prefill cell's, and
               MOE_SERVE_DECODE decode steps through the decode cell's fn,
               each timed; under the dropless twin (capacity = group of
               MOE_TF_GROUP) MOE_TF_PROMPT tokens prefilled into
               MOE_TF_SLOTS slots and MOE_TF_DECODE decode steps held to
               one forward over the slots' tokens; the flash kernel at (2,
               32768, 16, 16, 128) held to its plain version on its first
               and last FLASH_SERVE_ROWS rows, timed beside
               scaled_dot_product_attention and its bound; a decode step
               and a prefill profiled, the MoE FFN's parts (routing,
               dispatch, experts, combine) timed at both shapes. Checks:
               the prompt rows within LM_SERVE_TF_MEAN / LM_SERVE_TF_MAX of
               the cell's, the dropless generation within MOE_TF_MEAN /
               MOE_TF_MAX of the forward and each of its positions within
               MOE_TF_POSITION_MEAN, a control generation fed a wrong
               token at one step over that bound at that step's position,
               every logit finite, cache.length
               at prompt + decode steps, the cache's data_ptr unchanged by
               the decode, exactly 16 flash launches a prefill or forward
               and none a decode step, all on the Hopper path, no
               fused_infonce or fused_topk launch, peak memory under
               MOE_SERVE_PEAK_BYTES.
 12. moe_train - MoE training: olmoe-1b-7b's train_4k cell (launch/steps.py's
               train program; the gradient of the token loss plus moe_aux)
               at full width, cut to MOE_TRAIN_LAYERS of 16 layers, 32
               microbatches of 8 x 4096 tokens, attention through the flash
               kernel (causal MHA at S=4096), remat="full", seeded weights
               and uniform seeded tokens, MOE_TRAIN_STEPS steps. Checks: the
               first microbatch through flash against chunked attention with
               flash's routing replayed (loss within LM_TRAIN_LOSS_RTOL,
               every gradient leaf within PARITY_GRAD_RTOL of its largest
               |g|; flash's gradient at targets shifted by one must break
               that on every leaf; a freely routed chunked run's flips at
               most MOE_TRAIN_FLIP_SHARE of a layer's assignments; the next
               seed's readings recorded), remat "full" against "none" on one
               sequence (equal losses, drops and routes, the recompute
               routing as the forward, gradients within
               MOE_TRAIN_REMAT_GRAD_RTOL); the step-0 loss within
               LM_TRAIN_LOSS_SLACK of ln V + 1/2 + 0.08; finite losses;
               exactly MOE_TRAIN_LAYERS x 2 x 32 flash launches a step, all
               Hopper, no fused_infonce or fused_topk launch; peak memory
               under MOE_TRAIN_PEAK_BYTES. Median step, tokens/s,
               model-flops share, the first microbatch's moe_aux and dropped
               shares at step 0 and after the steps, one microbatch
               profiled, and the MoE FFN's parts (routing, dispatch,
               experts, combine) and the attention timed forward and
               backward at its shape, as shares of its kernel time.
 13. recsys  - the recsys_train program of launch/steps.py for dcn-v2 at
               its train_batch cell (B=65536, every published width), with
               each field's vocabulary capped at RECSYS_ROW_CAP rows, for
               RECSYS_STEPS steps on ClickLogGenerator batches: step time,
               the host's share (batch generation), peak memory and the
               losses; checks finite losses, table rows no batch indexed
               bit-identical at the end and every indexed row moved, and
               one step at a small cap on the card against the CPU.
 14. xdev    - cross-device ContAccum in a one-rank NCCL group (a FileStore
               in a temporary directory): dpr-bert-base at full width, fp32,
               the fused loss kernels, one rank's share (XDEV_RANK_BATCH
               queries, 4 chunks) of the contaccum_xdev cell, both banks of
               8192 filled before step 1 with pairs the towers encode;
               XDEV_STEPS steps each, in turns, of contaccum_xdev (sharded
               banks, bank columns all-gathered), contaccum_xdev_ring (the
               ring-streamed loss) and the one-device contaccum program on
               the same config, from one state and the same batches.
               Checks: the all-gather program's loss and gradient norm
               against the one-device program's (XDEV_LOSS_RTOL,
               XDEV_GRAD_NORM_RTOL), the ring's loss against the all-gather
               program's and each of its gradient leaves within
               GRAD_RTOL_FP32 of the largest |g|; all-gathers and
               all-reduces counted through NCCL in both sharded programs
               (DistCtx's counts) and none in the one-device one; every
               fused_infonce launch on the fp32 kernels, 2/1/2 a chunk
               (forward, dQ, dP) for the all-gather and one-device
               programs and 3/2/1 for the ring, and no call of the plain
               version; bank fill 8192. Median step times, peak memory,
               and the fp32 forward, dQ and dP at the path's shapes (the
               32 local and 8192 bank rows against 8256 columns; the
               ring's 8224 rows against its 8192- and 64-column chunks)
               against the plain version, beside their bound and the
               dense backend; each on the "tf32x3" route also against
               ref.py in float64 (at most FP64_ERR_RATIO times the plain
               version's own error: the forward's lse, and dQ and dP taken
               against the forward's lse) and in turns with the "fp32"
               route it took before (faster in every turn).
 15. shard_serve - multi-device serving: the serve_topk cell (dpr-bert-base
               at full width, bf16_banks, the fused search, k = 100)
               through the sharded index of a one-rank NCCL group: the
               sharded Retriever builds rank 0's block (N_ENCODED encoded
               rows, then seeded rows up to 2^20), and N_REQUESTS requests
               from CLIENTS clients go through rank 0's server, which
               broadcasts each padded batch before the collective search.
               Checks: no collective in the build; one broadcast and two
               all-gathers (scores, ids) a coalesced batch and none other,
               one more broadcast (the stop word) at the server's stop;
               fused_topk launched once a batch, all on the Hopper path;
               every answer; one batch against the plain search on the same
               reps. Then the D = 4 layout of eval_topk's 2^20 - 37 rows
               (1,048,540 padded rows, 262,135 a block, one padding row in
               the last) replayed as 4 blocks on the one card through
               Retriever._local_topk and merge_shard_candidates: ids and
               scores equal to the replicated search's bit for bit. qps,
               p50, p99, batches, collectives by kind, each block's search
               ms beside the replicated one's and the merge's.
Then the kernels line, the nvidia-smi line, and the final
{"ok": true, "device": {...}} line.

    python3 chip_smoke.py --serve-turns     # builds, then only serves

runs the serve phase with plain and flash towers in turns (plain, flash,
flash, plain, ...), one line a run, and the nvidia-smi line; no final line.

    python3 chip_smoke.py --xdev            # builds, then only the xdev phase

runs the xdev phase alone, its line and the nvidia-smi line; no final line.

    python3 chip_smoke.py --shard-serve     # builds, then only shard_serve

runs the shard_serve phase alone, its line and the nvidia-smi line; no
final line.
Any failed check raises and the script
exits non-zero before the final line. Without a CUDA device, or without the
repo's ``src/repro_torch`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"

# H100 SXM data sheet (dense): bf16 and TF32 tensor-core peaks, fp32 peak
# outside the tensor cores, and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# fp32 sums of 768 exact bf16 products in another order: scores agree to
# 1e-5 of the row's largest |score|
SCORE_RTOL = 1e-5

# an id check that compared fewer clear slots than this share is vacuous
MIN_CLEAR = 0.5

# Where the serve phase departs from the serve_topk cell: it searches with
# the fused kernel (the cell's own search_impl is the plain "dense" one), and
# only the first N_ENCODED index rows are encoded passages (they encode in
# seconds); the rest, up to the cell's n_passages, are seeded random rows.
SEARCH_IMPL = "fused"
N_ENCODED = 32768
P_LEN = 256
N_REQUESTS = 512
CLIENTS = 64

# fused_infonce checks against the dense fp32 reference: statistics to 1e-5
# of the largest |logit| (exact bf16 products summed in fp32 in another
# order); gradients to 1e-2 of the largest |gradient| under bf16 (the kernel
# rounds each softmax coefficient to bf16 before its product, as the TPU
# kernel does, and the result to bf16) and 1e-4 under fp32 (order only)
STATS_RTOL = 1e-5
GRAD_RTOL_BF16 = 1e-2
GRAD_RTOL_FP32 = 1e-4
# the fp32 dQ and dP on 3xTF32 against ref.py run in float64: at most this
# many times the fp32 plain version's own error against it (one TF32 pass
# would sit ~500x above; fp32 products summed in another order near 1x)
FP64_ERR_RATIO = 10.0
N_BANK_MASKED = 1000

# the train phase: steps (16 x 8 = 128 pushes a step wrap the 2048-slot
# banks after 16; 18, not 20, since the xdev phase joined: the whole run
# must stay inside 1200 s on a slower host too), the corpus it draws from
# (and evaluates on), the paper's peak learning rate (Appendix B) with a
# short warmup for a short run
TRAIN_STEPS = 18
N_CORPUS = 4096
PEAK_LR = 2e-5
WARMUP_STEPS = 2
CHECKPOINT_EVERY = 10
# the dense and the fused backends on one step from the same state and
# batch: loss to 1e-3 relative (both sum exact bf16 products in fp32; the
# towers are the same ops); gradient global norm to 2e-2 relative (the fused
# backward rounds the softmax coefficients to bf16, the dense one keeps fp32)
PARITY_LOSS_RTOL = 1e-3
PARITY_GRAD_RTOL = 2e-2

# flash_attention against its plain version by ref.flash_attention_error:
# fp32, each element within 1e-5 of the largest |v| (the same fp32 products
# and exponentials summed in another order); bf16, each element within
# 2^-7 (a + |o|) + 2^-12 a, a = sum_j p_j |v_j| and o the exact output (both
# round their probabilities to bf16, the kernel each tile's unnormalised
# exp(s - m) and the plain version the normalised softmax, at most 2^-8 a
# each, and their output, 2^-8 |o| each), and a mean error from the exact
# attention at most 1.25 times the plain version's (the same kinds of
# rounding; a dropped or misweighted tile of late keys shows here)

# Where the flash phase departs from the repo's cells: the towers run with
# attention_impl="pallas", the BertConfig field both packages offer (no named
# cell selects it); it serves as the serve phase does, and trains
# FLASH_TRAIN_STEPS steps of the contaccum_bf16 cell.
FLASH_IMPL = "pallas"
#: plain and flash serves of each under --serve-turns
SERVE_TURN_PAIRS = 2
# prefill shapes of the LM configs (src/repro/configs/internlm2_1p8b.py,
# stablelm_3b.py) that no path of the port runs yet: (B, S, H, Hk, D), causal
FLASH_LM_SHAPES = {"internlm2_prefill": (1, 4096, 16, 8, 128),
                   "stablelm_prefill": (1, 2048, 32, 32, 80)}
# 3, not 5, since the xdev phase joined (the whole run's time)
FLASH_TRAIN_STEPS = 3
# passages whose reps are held against the plain-attention towers
FLASH_PARITY_PASSAGES = 256

# The mine phase: the contaccum_mined cell at its full shape (128 pairs as
# 16 chunks of 8, dual banks of 2048, q_len 32, p_len 256, 1 hard + 4 mined
# columns a query: 8 + 40 + 2048 = 2096 columns a chunk) on the train
# phase's towers, with contaccum_bf16's precision and loss kernels (the JAX
# cell runs fp32 and the dense loss); a miner over a MINE_CORPUS-passage
# corpus (its queries are the loader's), top MINE_TOPK through fused_topk
# (256 queries a search), the band MINE_BAND, a refresh every MINE_EVERY
# steps: MINE_STEPS gives refreshes after steps 3 and 7 and two steps after
# the last (10, not 14, since the xdev phase joined: the whole run's time). One async and one sync turn from the same seeded state,
# both with the train phase's last banks (full: 2048 each), so every chunk
# has the cell's 2096 columns from the first step.
MINE_CORPUS = 32768
MINE_STEPS = 10
MINE_EVERY = 4
MINE_TOPK = 32
MINE_BAND = (1, 32)
# the overlap this phase requires: the async turn's train_s below the sync
# turn's by at least MINE_SAVED_SHARE of the sync turn's summed refresh time
# (and of the sync time of the refreshes the async turn did), and its
# median step with a refresh in flight at most MINE_STEP_RATIO times its
# median step without
MINE_SAVED_SHARE = 0.25
MINE_STEP_RATIO = 1.5

# The lm phase: internlm2-1.8b (src/repro/configs/internlm2_1p8b.py) as both
# towers of an LM dual encoder at full width in the contaccum_bf16 cell,
# depth cut to LM_LAYERS of 24: each tower is 62.9M params a layer plus 379M
# in the embedding and the LM head (unused by the pooled encoder, but in the
# param tree and AdamW's state), the towers are two sets of leaves after the
# first step, and the functional AdamW holds about 11 param-sized fp32
# buffers at its peak: 24 layers would need about 3.78B params x 44 B = 166
# GB, 4 layers take 1.26B params, about 55 GB. No checkpoints (the train
# phase checks them; one here would be about 15 GB).
LM_ARCH = "internlm2-1.8b"
LM_LAYERS = 4
LM_STEPS = 6
# reps of the LM towers, and the eval's search: 256 eval queries against
# the N_CORPUS passages, k = the largest Top@k cutoff
LM_D = 2048
LM_EVAL_KS = (1, 5, 20)
LM_EVAL_QUERIES = 256
# the attention passes of the lm, lm_train and moe_train phases: (B, S, H,
# Hk, D), causal
FLASH_LM_PATH_SHAPES = {"lm_query": (8, 32, 16, 8, 128), "lm_passage": (8, 256, 16, 8, 128),
                        "lm_train": (8, 4096, 16, 8, 128), "moe_train": (8, 4096, 16, 16, 128)}

# The lm_train phase: internlm2-1.8b's train_4k cell (launch/steps.py's
# causal-LM train program: 256 sequences of 4096 tokens a step, clip 1.0,
# then AdamW) at full width through the flash kernel (attention_impl
# "pallas", remat "full"), seeded weights and seeded uniform tokens, with
# two cuts: depth LM_LAYERS of 24 (4 layers are 251.7M params plus 379.0M
# in the embedding and the head; the functional AdamW holds about 11
# param-sized fp32 buffers at its peak, about 28 GB at 4 layers and 83 GB
# at 24), and LM_TRAIN_MICRO_BATCHES microbatches in place of the config's
# 4: the flash op's backward recomputes through autograd of chunked
# attention (blocks of 256 x 512), which keeps every block's fp32 tiles of
# a layer alive at once, about 3.2 GB a sequence of 4096 tokens, so 64
# sequences a microbatch would need about 200 GB and 8 need about 26.
LM_TRAIN_STEPS = 3
LM_TRAIN_MICRO_BATCHES = 32
# flash against chunked attention on the first microbatch: the loss to
# 2e-3 relative (bf16 hidden states, fp32 logits), each gradient leaf to
# PARITY_GRAD_RTOL of its largest |g| (the port's bf16 backward allowance)
LM_TRAIN_LOSS_RTOL = 2e-3
# the step-0 loss: logits of unit spread after the final RMSNorm (lm_head
# drawn at std d^-1/2) give a loss near ln V + 1/2; it must lie within this
LM_TRAIN_LOSS_SLACK = 0.5

# The lm_serve phase: internlm2-1.8b's prefill_32k and decode_32k cells
# (launch/steps.py's prefill and decode programs) at full width and full
# depth (24 layers, 1,889,208,320 params, 7.56 GB in fp32; no optimizer)
# through the flash kernel (causal GQA at S = 32768), seeded weights and
# seeded uniform tokens, one cut: both global batches (prefill_32k's 32,
# decode_32k's 128) to LM_SERVE_BATCH sequences. The cache is 4 KiB a token
# a layer (k and v of 8 KV heads of 128 in bf16): 25.8 GB at 8 sequences of
# 32768 slots, 103 GB at 32 and 412 GB at 128.
LM_SERVE_BATCH = 8
LM_SERVE_PREFILL_RUNS = 3
# the generation: a prompt of LM_SERVE_PROMPT tokens prefilled into a cache
# of the cell's 32768 slots, then LM_SERVE_DECODE decode steps fed the
# seeded tokens that follow (teacher forced). The prompt is a multiple of
# 512: the flash op's shape contract (JAX's: Sq a multiple of min(256, Sq),
# Skv of min(512, Skv)) refuses 32640 = 32768 - 128, and 512 decode steps
# to fill the cache would take most of a minute
LM_SERVE_PROMPT = 32256
LM_SERVE_DECODE = 128
# the generation's LM_SERVE_DECODE + 1 logits against one forward over the
# same tokens: logits of about unit spread (lm_head at std d^-1/2 after the
# final RMSNorm) whose bf16 hidden states were rounded on two routes (a
# flash pass over the prompt and one query against the cache, against a
# flash pass over all of it): mean and largest |difference|
LM_SERVE_TF_MEAN = 0.02
LM_SERVE_TF_MAX = 0.25
LM_SERVE_PEAK_BYTES = 70e9
# the flash kernel at the prefill's attention, (B, S, H, Hk, D) causal bf16:
# its plain version would need (8, 16, 32768, 32768) fp32 scores (550 GB),
# so the first and the last FLASH_SERVE_ROWS query rows of every sequence
# are held to it
FLASH_SERVE_SHAPE = (LM_SERVE_BATCH, 32768, 16, 8, 128)
FLASH_SERVE_ROWS = 256

# The moe_serve phase: olmoe-1b-7b's prefill_32k and decode_32k cells
# (src/repro/configs/olmoe_1b_7b.py, arXiv 2409.02060: 16 layers, d_model
# 2048, 16 heads and 16 KV heads of 128, vocab 50304, 64 experts, top 8,
# d_expert 1024, capacity factor 1.25, groups of 1024) at full width and
# depth (6,919,096,320 params, 27.7 GB in fp32) through the flash kernel
# (causal MHA at S = 32768), seeded weights and uniform seeded tokens, one
# cut: both global batches (32, 128) to MOE_SERVE_BATCH sequences. The
# cache is 128 KiB a token (16 layers x k and v x 16 heads x 128 x 2 B):
# 8.6 GB at 2 x 32768 slots. The dispatch holds per layer, per token in
# bf16, disp and combine (G, g, E, C) at 20 KiB each, xe and ye (G, E, C,
# d) at 40 KiB each, gate, up and SwiGLU (G, E, C, f) at 20 KiB each: about
# 12 GB a layer at B = 2, 24 GB at 4; with the params and cache about 50 GB
# at B = 2 and 72 GB at 4, past the bound below.
MOE_ARCH = "olmoe-1b-7b"
MOE_SERVE_BATCH = 2
MOE_SERVE_PREFILL_RUNS = 3
# the generation at the config's own capacity: 31 groups of 1024 prefilled
# into the cell's 32768 slots, then MOE_SERVE_DECODE decode steps. 31744 and
# 32768 are multiples of the group, so each group of the prompt is the same
# group in the prefill cell's run (the B x S tokens flatten row-major), and
# the prompt's cache rows of the two runs are held to each other within
# LM_SERVE_TF_MEAN and LM_SERVE_TF_MAX (bf16 values of unit spread)
MOE_SERVE_PROMPT = 31744
MOE_SERVE_DECODE = 64
# teacher forcing under the dropless twin (capacity_factor E / k at groups
# of 512: capacity = group, nothing dropped, so a token's expert outputs do
# not depend on its group): a prompt of MOE_TF_PROMPT tokens into
# MOE_TF_SLOTS slots, MOE_TF_DECODE decode steps, one forward over the
# MOE_TF_SLOTS tokens (the flash op's shape contract wants a multiple of
# 512), the logits at the generation's positions.
# At the config's own capacity the forward's groups of 1024 drop
# assignments a decode step's group of B never drops, and the difference
# is the model's, not a fault (JAX's decode does the same)
MOE_TF_GROUP = 512
MOE_TF_PROMPT = 4096
MOE_TF_SLOTS = 4608
MOE_TF_DECODE = 32
# the generation's logits against the forward's: on top of the bf16 ulps
# that the two routes round apart (LM_SERVE_TF_*), a token whose router
# logits sit within those ulps of the k-th place picks another expert on
# one route, which moves that token's logits by a share of a whole expert
# output (tests/test_torch_moe_lm.py measures both in bf16 on the CPU). The
# mean over all positions is held at 2.5 times LM_SERVE_TF_MEAN and the
# largest at 4 times LM_SERVE_TF_MAX. A fault at one decode step moves its
# own position by a few tenths of the logits' spread at these random
# weights, which the mean over all positions hides, so each position's
# mean is held to MOE_TF_POSITION_MEAN as well: above the worst clean
# position, and below a control generation fed a wrong token at decode
# step MOE_TF_FAULT_STEP, which the check must flag (PERF.md, section 4)
MOE_TF_MEAN = 0.05
MOE_TF_MAX = 1.0
MOE_TF_POSITION_MEAN = 0.075
MOE_TF_FAULT_STEP = 16
MOE_SERVE_PEAK_BYTES = 70e9
# the flash kernel at the MoE prefill's attention (causal MHA), its first
# and last FLASH_SERVE_ROWS query rows held to the plain version
FLASH_MOE_SHAPE = (MOE_SERVE_BATCH, 32768, 16, 16, 128)

# The moe_train phase: olmoe-1b-7b's train_4k cell (launch/steps.py's
# causal-LM train program: 256 sequences of 4096 tokens a step, the
# gradient of the token loss plus moe_aux, clip 1.0, then AdamW) at full
# width through the flash kernel (attention_impl "pallas", remat "full"),
# seeded weights and seeded uniform tokens, with lm_train's two cuts. Depth
# MOE_TRAIN_LAYERS of 16: the embedding and the head are 206.0M params, a
# layer 419.56M (16.78M attention, 0.13M router, 402.65M experts), and the
# functional AdamW holds about 11 param-sized fp32 buffers at its peak:
# about 300 GB at 16 layers, 46 GB at 2 (1.045B params) and 64 GB at 3, too
# near the bound below to plan on. LM_TRAIN_MICRO_BATCHES microbatches of
# 8 sequences: beside the about 17 GB of params, moments and gradients,
# the flash op's fp32 backward keeps about 3.2 GB a sequence, and a layer's
# recompute keeps 32 groups' dispatch, combine, expert buffers and SwiGLU
# tensors in bf16 (about 0.2 GB a group of 1024) and as much again in
# gradients.
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3
MOE_TRAIN_PEAK_BYTES = 70e9
# flash against chunked attention on the first microbatch. A token whose
# router logits lie within the two routes' bf16 rounding of its k-th place
# picks another expert on one of them, which moves its own hidden state by
# a share of a whole expert output, the drops of its group's later tokens,
# and through the next layer's attention every later token's state: on an
# H100 (seeds 0 and 1) a free chunked run routed 0.30-0.32% of layer 0's
# (token, expert) assignments and 1.78-1.83% of layer 1's apart from the
# flash run, and every gradient leaf then parted by 0.04-0.33 of its
# largest |g| (the phase line's "free" readings), the embedding, router and
# expert leaves as much as the others. So the chunked run replays the
# flash run's routing (RouteLog), every leaf is held to PARITY_GRAD_RTOL
# (0.0155 at most there), and the control, flash's gradient at the targets
# shifted by one against that replayed run, must break it on every leaf
# (0.41 at least there). The free run's flips are held to at most
# MOE_TRAIN_FLIP_SHARE of a layer's assignments.
MOE_TRAIN_FLIP_SHARE = 0.05
# remat "full" against "none" on one sequence, flash in both: the same
# forward (the losses, drops and routes equal, and the recompute's routes
# the forward's), and each gradient leaf within this share of its largest
# |g| (the embedding's backward adds with atomics, in an order that varies)
MOE_TRAIN_REMAT_GRAD_RTOL = 1e-3
# the step-0 loss: ln V + 1/2 (LM_TRAIN_LOSS_SLACK) plus the aux term,
# router_aux_weight x top_k = 0.08 at uniform routing (E sum_e f_e p_e = k
# when each f_e = k / E and p_e = 1 / E). At these random weights the late
# tokens of a sequence route alike (their hidden states are mostly the
# attention's average over the same prefix), so the aux term reads more
# (0.133 on an H100) and 24-40% of a layer's assignments drop.

# fused_topk at k > 128 (row states in global memory): the k values held
# against the plain version at the eval_topk and serve_topk shapes
TOPK_LARGE_K = (129, 256, 1000)

# embedding_bag: the multi-hot pooling sizes of the 26 Criteo fields in the
# MLPerf DLRM-DCNv2 benchmark (214 lookups a sample); ids drawn per field as
# ClickLogGenerator draws them (zipf a=1.2, modulo the vocabulary)
DCN_POOLING = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3,
               1, 1)
ZIPF_A = 1.2
# dlrm-mlperf's width on the same bags, rows cut to 2^24: a 128-wide table
# of every Criteo row (96 GB in fp32) does not fit the card
BAG_WIDE_ROWS = 1 << 24
# the backward at a cut size: rows, samples
BAG_GRAD_ROWS, BAG_GRAD_SAMPLES = 1 << 20, 4096
# backward against the plain version's autograd: each row's gradient within
# 1e-5 of the sum of |g| over its lookups (index_add_ adds them with
# atomics, in an order that varies; a hot row of the zipf draws sums about
# 1e5 of them with cancellation, so its error is measured against what it
# summed, not against the largest |grad|)
BAG_GRAD_RTOL = 1e-5

# Where the recsys phase departs from dcn-v2's train_batch cell: each
# field's vocabulary is capped at RECSYS_ROW_CAP rows (the --max-ind-range
# of the DLRM reference implementation, facebookresearch/dlrm): 54,064,128
# stacked rows, a 3.46 GB fp32 table. The functional optimizer holds about
# 11 table-sized buffers at its peak (old and new moments, gradient, clipped
# gradient, temporaries, updates, new params): about 38 GB here, over 130 GB
# at the full 187.8M rows.
RECSYS_ROW_CAP = 10_000_000
RECSYS_STEPS = 20
# one step at a small cap on the card against the CPU: the fp32 loss to
# 1e-5 relative (fp32 GEMMs, TF32 off, sums in another order), and each
# gradient leaf to 1e-4 of its largest |g| (the index backward adds with
# atomics), in fp32 and in fp64. In fp32 a ReLU unit of the deep MLP whose
# pre-activation lies within rounding of 0 can take the other side under
# another summation order, which moves that sample's whole contribution to
# every gradient below it (on an H100 this put the last deep layer's fp32
# gradient 3.1e-3 of its largest |g| from the CPU's over the whole batch).
# So the fp32 gradients are those of bce_loss's mean over the samples whose
# deep-MLP ReLU masks agree on the two devices (the others weigh 0 and are
# counted, at most RECSYS_MAX_FLIPPED of the batch; the batch keeps its
# shape, so each device rounds as it did when the masks were read), and the
# fp64 ones those of the whole batch.
RECSYS_PARITY_CAP, RECSYS_PARITY_BATCH = 100_000, 4096
RECSYS_LOSS_RTOL, RECSYS_GRAD_RTOL = 1e-5, 1e-4
RECSYS_MAX_FLIPPED = 0.01

# Where the xdev phase departs from the contaccum_xdev and
# contaccum_xdev_ring cells: one rank of a one-rank NCCL group (NCCL takes
# no two ranks on one card, and `python3 chip_smoke.py` takes one card), training
# XDEV_RANK_BATCH queries a step, one rank's share of the cells' 2048 under
# the 16-way data axis of the JAX package's production mesh (the whole 2048
# in fp32 does not fit one card); the banks' 8192 slots are filled before
# the first step with pairs the towers encode from the corpus, so every
# bank column is live; XDEV_STEPS steps of each program from the same state
# and batches. The cells' other params are kept: fp32, the fused loss
# kernels, 4 chunks (of 32 queries here), 1 hard negative, q_len 32, p_len
# 256, remat as BERT_BASE's.
XDEV_RANK_BATCH = 128
XDEV_STEPS = 3
XDEV_CORPUS = 16384
# the sharded all-gather program against the one-device program: each step's
# loss and gradient global norm to 1e-5 relative (at one rank every
# collective is a copy; the same kernels on the same operands); the ring
# against the all-gather program: the loss to 1e-5 relative and every
# gradient leaf to GRAD_RTOL_FP32 of its largest |g| (the ring merges the
# 64 in-batch and 8192 bank columns' statistics: fp32 sums in another
# order)
XDEV_LOSS_RTOL = 1e-5
XDEV_GRAD_NORM_RTOL = 1e-5

# shard_serve: the serve_topk cell through the sharded index of a one-rank
# NCCL group (NCCL takes no two ranks on one card), then the D = 4 layout of
# eval_topk's 2^20 - 37 rows replayed as 4 blocks on the one card: 1,048,540
# padded rows, 262,135 a block, the last block holding one padding row
SHARD_REPLAY_SHARDS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def topk_bound_ms(n_q: int, n: int, n_valid: int, d: int, k: int, itemsize: int):
    """(bound_ms, bound_by): each input read once, each output written once,
    over HBM bandwidth; the products over valid columns over bf16 peak."""
    moved = (n_q + n) * d * itemsize + n + n_q * k * 8
    ops = 2.0 * n_q * n_valid * d
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_topk(q, p, k, chunk=512):
    """Yardstick only, never called by the port: torch.matmul + torch.topk,
    chunked over query rows (bf16 product, so its scores are bf16-rounded)."""
    import torch

    for lo in range(0, q.shape[0], chunk):
        torch.topk(q[lo : lo + chunk] @ p.T, k, dim=1)


def check_topk(ref, s, i, rs, ri, tol, what):
    """Hold (s, i) against the plain (rs, ri) of k + 1 slots: scores within
    tol, ids equal at clear slots, and at least MIN_CLEAR of them clear.
    Returns (max abs err, clear slots)."""
    err, bad, clear = ref.topk_mismatch(s, i, rs, ri, tol)
    require(err <= tol, f"{what}: max |score err| {err} > {tol}")
    require(bad == 0, f"{what}: {bad} ids differ at clear slots")
    require(clear >= MIN_CLEAR * i.numel(),
            f"{what}: only {clear} of {i.numel()} slots clear, the id check is vacuous")
    return err, clear


def phase_kernels(torch, ops, ref):
    from repro_torch.configs.dpr_bert_base import BERT_BASE, EVAL_TOPK, SERVE_TOPK
    from repro_torch.kernels._timing import cuda_ms

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, k = BERT_BASE.d_model, EVAL_TOPK["top_k"]
    result = {}

    def large_k(name, q, p, valid, n_valid):
        """k > 128 (the row states in global memory) against the plain
        version, which is computed once at the largest k + 1; that k timed."""
        kmax = max(TOPK_LARGE_K)
        rs, ri = ref.topk_scores_ref(q, p, kmax + 1, col_valid=valid)
        tol = SCORE_RTOL * rs[:, 0].abs().max().item()
        out = {"tolerance": tol}
        for kk in TOPK_LARGE_K:
            s, i = hopper_call(f"{name} k={kk}", q, p, kk, col_valid=valid)
            err, clear = check_topk(ref, s, i, rs[:, : kk + 1], ri[:, : kk + 1], tol,
                                    f"{name} k={kk}")
            out[f"k{kk}"] = {"max_abs_err": err, "clear_slots": clear, "slots": i.numel()}
        del rs, ri, s, i
        bound_ms, bound_by = topk_bound_ms(q.shape[0], p.shape[0], n_valid, d, kmax, 2)
        out[f"k{kmax}"].update({
            "ms": cuda_ms(lambda: ops.fused_topk(q, p, kmax, col_valid=valid), 3),
            "plain_ms": cuda_ms(lambda: ref.topk_scores_ref(q, p, kmax, col_valid=valid), 1),
            "library_ms": cuda_ms(lambda: library_topk(q, p, kmax), 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        return out

    def hopper_call(what, *args, **kw):
        """One call, which must take the Hopper kernel (ops.fused_topk.paths)."""
        ops.reset_launches()
        out = ops.fused_topk(*args, **kw)
        require(ops.fused_topk.paths["hopper"] == ops.fused_topk.launches == 1,
                f"{what}: fused_topk took {ops.fused_topk.paths}, not the Hopper kernel")
        return out

    # eval_topk shape, ragged N, masked columns
    n_q, n = EVAL_TOPK["n_queries"], EVAL_TOPK["n_passages"] - 37
    q = torch.randn((n_q, d), generator=g, device=dev).to(torch.bfloat16)
    p = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand((n,), generator=g, device=dev) > 0.01
    s, i = hopper_call("eval shape", q, p, k, col_valid=valid)
    rs, ri = ref.topk_scores_ref(q, p, k + 1, col_valid=valid)
    tol = SCORE_RTOL * rs[:, 0].abs().max().item()
    err, clear = check_topk(ref, s, i, rs, ri, tol, "eval shape")
    require(bool((i >= 0).all()) and bool(valid[i.long()].all()), "eval shape: masked id returned")
    kernel_ms = cuda_ms(lambda: ops.fused_topk(q, p, k, col_valid=valid), 5)
    plain_ms = cuda_ms(lambda: ref.topk_scores_ref(q, p, k, col_valid=valid), 1)
    library_ms = cuda_ms(lambda: library_topk(q, p, k), 2)
    n_valid = int(valid.sum().item())
    bound_ms, bound_by = topk_bound_ms(n_q, n, n_valid, d, k, 2)
    result["eval_topk"] = {
        "Q": n_q, "N": n, "n_valid": n_valid, "d": d, "k": k, "dtype": "bf16",
        "max_abs_err": err, "tolerance": tol, "clear_slots": clear, "slots": i.numel(),
        "path": "hopper", "ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    del rs, ri
    result["eval_topk_large_k"] = large_k("eval shape", q, p, valid, n_valid)

    # serve_topk shape: one coalesced batch against 2^20 rows
    n_q, n = SERVE_TOPK["n_queries"], SERVE_TOPK["n_passages"]
    q = torch.randn((n_q, d), generator=g, device=dev).to(torch.bfloat16)
    p = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    s, i = hopper_call("serve shape", q, p, k)
    rs, ri = ref.topk_scores_ref(q, p, k + 1)
    tol = SCORE_RTOL * rs[:, 0].abs().max().item()
    err, clear = check_topk(ref, s, i, rs, ri, tol, "serve shape")
    bound_ms, bound_by = topk_bound_ms(n_q, n, n, d, k, 2)
    result["serve_topk"] = {
        "Q": n_q, "N": n, "d": d, "k": k, "dtype": "bf16", "max_abs_err": err,
        "tolerance": tol, "clear_slots": clear, "slots": i.numel(), "path": "hopper",
        "ms": cuda_ms(lambda: ops.fused_topk(q, p, k), 10),
        "plain_ms": cuda_ms(lambda: ref.topk_scores_ref(q, p, k), 2),
        "library_ms": cuda_ms(lambda: library_topk(q, p, k), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    result["serve_topk_large_k"] = large_k("serve shape", q, p, None, n)
    del q, p, valid

    # the LM retriever's search (lm phase): bf16 reps LM_D wide, past a
    # resident query tile, so the Hopper scan streams the query chunks
    # through its rings; the eval's shape, and Q = 2048 at eval_topk's k;
    # each beside the route it took before (parent_ms: the rows widened to
    # fp32 in the call, then the fp32 kernel, as fp32_widened did)
    p = torch.randn((N_CORPUS, LM_D), generator=g, device=dev).to(torch.bfloat16)
    for name, n_q, kk in (("lm_eval", LM_EVAL_QUERIES, max(LM_EVAL_KS)), ("lm_q2048", 2048, k)):
        q = torch.randn((n_q, LM_D), generator=g, device=dev).to(torch.bfloat16)
        s, i = hopper_call(name, q, p, kk)
        rs, ri = ref.topk_scores_ref(q, p, kk + 1)
        tol = SCORE_RTOL * rs[:, 0].abs().max().item()
        err, clear = check_topk(ref, s, i, rs, ri, tol, name)
        bound_ms, bound_by = topk_bound_ms(n_q, N_CORPUS, N_CORPUS, LM_D, kk, 2)
        layout = ops.scan_plan(LM_D, kk, n_q)[0]
        require(layout == ops.STREAMED, f"{name}: scan layout {layout}, not streamed")
        kernel = lambda: ops.fused_topk(q, p, kk)                     # noqa: E731
        parent = lambda: ops.fused_topk(q.float(), p.float(), kk)     # noqa: E731
        times = {"ms": [], "parent_ms": []}
        for key, fn in (("parent_ms", parent), ("ms", kernel), ("ms", kernel),
                        ("parent_ms", parent)):
            times[key].append(cuda_ms(fn, 10))
        result[name] = {
            "Q": n_q, "N": N_CORPUS, "d": LM_D, "k": kk, "dtype": "bf16", "max_abs_err": err,
            "tolerance": tol, "clear_slots": clear, "slots": i.numel(), "path": "hopper",
            "layout": "streamed", "ms": statistics.mean(times["ms"]), "ms_turns": times["ms"],
            "parent_route": "fp32_widened", "parent_ms": statistics.mean(times["parent_ms"]),
            "parent_ms_turns": times["parent_ms"],
            "plain_ms": cuda_ms(lambda: ref.topk_scores_ref(q, p, kk), 3),
            "library_ms": cuda_ms(lambda: library_topk(q, p, kk), 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        require(result[name]["ms"] < result[name]["parent_ms"],
                f"{name}: the Hopper scan ({times['ms']} ms) is not faster than fp32_widened "
                f"({times['parent_ms']} ms)")
    del q, p

    # ties: duplicated integer rows, exact sums, so ties must go to the lowest id
    base = torch.randint(-3, 4, (64, 96), generator=g, device=dev)
    p = base[torch.randint(0, 64, (20000,), generator=g, device=dev)].to(torch.bfloat16)
    q = torch.randint(-3, 4, (100, 96), generator=g, device=dev).to(torch.bfloat16)
    s, i = ops.fused_topk(q, p, k)
    rs, ri = ref.topk_scores_ref(q, p, k)
    require(torch.equal(s, rs) and torch.equal(i, ri), "tie case: kernel differs from plain")

    # k > n_valid: the tail slots must be (-1e30, -1)
    q = torch.randn((10, d), generator=g, device=dev).to(torch.bfloat16)
    p = torch.randn((500, d), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.zeros((500,), dtype=torch.bool, device=dev)
    valid[::9] = True                                       # 56 valid columns
    s, i = ops.fused_topk(q, p, k, col_valid=valid)
    rs, ri = ref.topk_scores_ref(q, p, k + 1, col_valid=valid)
    tol = SCORE_RTOL * rs[:, 0].abs().max().item()
    require(bool((i[:, 56:] == -1).all()) and bool((s[:, 56:] == -1e30).all()),
            "k > n_valid: tail slots are not (-1e30, -1)")
    check_topk(ref, s, i, rs, ri, tol, "k > n_valid")

    # k > 128 and > n_valid: the tail slots must be (-1e30, -1) as well
    p = torch.randn((3000, d), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.zeros((3000,), dtype=torch.bool, device=dev)
    valid[::9] = True                                       # 334 valid columns
    s, i = ops.fused_topk(q, p, 500, col_valid=valid)
    rs, ri = ref.topk_scores_ref(q, p, 501, col_valid=valid)
    tol = SCORE_RTOL * rs[:, 0].abs().max().item()
    require(bool((i[:, 334:] == -1).all()) and bool((s[:, 334:] == -1e30).all()),
            "k=500 > n_valid: tail slots are not (-1e30, -1)")
    check_topk(ref, s, i, rs, ri, tol, "k=500 > n_valid")
    return result


def phase_serve(torch, topk_ref, bert_cfg, counters):
    """Serve the serve_topk cell with towers of ``bert_cfg``. ``counters``
    lists (name, wrapper, per encode batch, per coalesced batch): each
    wrapper's launches in the index encode and in the serving run must be
    that many times the batches of each."""
    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, SERVE_TOPK
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.kernels._timing import cuda_ms
    from repro_torch.retrieval import IndexStore, Retriever, RetrieverConfig, make_server

    k, precision = SERVE_TOPK["top_k"], SERVE_TOPK["precision"]
    n_index, d = SERVE_TOPK["n_passages"], BERT_BASE.d_model
    encode_batch = 256
    t0 = time.perf_counter()
    enc = make_bert_dual_encoder(bert_cfg, precision=precision)
    params = enc.init(torch.Generator().manual_seed(SEED), DEVICE)
    retriever = Retriever(
        enc, params,
        RetrieverConfig(top_k=k, search_impl=SEARCH_IMPL, precision=precision,
                        encode_batch=encode_batch),
        device=DEVICE,
    )
    corpus = SyntheticRetrievalCorpus(
        n_passages=N_ENCODED, vocab_size=BERT_BASE.vocab_size,
        q_len=SERVE_TOPK["q_len"], p_len=P_LEN, seed=SEED,
    )
    setup_s = time.perf_counter() - t0

    def reset():
        for _, wrapper, _, _ in counters:
            wrapper.launches = 0
            if hasattr(wrapper, "paths"):
                wrapper.paths = dict.fromkeys(wrapper.paths, 0)

    def read():
        return {name: wrapper.launches for name, wrapper, _, _ in counters}

    def read_paths():
        return {name: dict(wrapper.paths) for name, wrapper, _, _ in counters
                if hasattr(wrapper, "paths")}

    reset()                                           # the index encode starts here
    t0 = time.perf_counter()
    encoded = retriever.build_index(corpus.passages).reps
    encoded.sum().item()                              # waits for the encode
    index_s = time.perf_counter() - t0
    encode_launches = read()                          # read just after it
    encode_batches = -(-N_ENCODED // encode_batch)
    for name, _, per_encode, _ in counters:
        require(encode_launches[name] == per_encode * encode_batches,
                f"index encode launched {name} {encode_launches[name]} times for "
                f"{encode_batches} batches, not {per_encode} each")
    require(encoded.dtype == torch.bfloat16 and tuple(encoded.shape) == (N_ENCODED, d),
            "encoded index is not (N, d_model) bf16")
    require(bool(torch.isfinite(encoded).all()), "index has non-finite rows")
    # the rest of the cell's index: seeded random rows with the encoded rows'
    # per-dimension mean and spread
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    stats = encoded.float()
    fill = torch.randn((n_index - N_ENCODED, d), generator=g, device=DEVICE)
    fill = fill * stats.std(0) + stats.mean(0)
    store = retriever.index = IndexStore(
        reps=torch.cat([encoded, fill.to(encoded.dtype)]),
        row_valid=torch.ones((n_index,), dtype=torch.bool, device=DEVICE),
        n_total=n_index,
    )
    del stats, fill

    max_batch = SERVE_TOPK["n_queries"]
    server = make_server(retriever, max_batch=max_batch).start()
    try:
        server.query(corpus.queries[0])               # warm-up, not counted
        server.batch_sizes.clear()
        reset()                                       # the main path's run starts here
        lat = [0.0] * N_REQUESTS
        answers = [None] * N_REQUESTS

        def one(j):
            t = time.perf_counter()
            answers[j] = server.query(corpus.queries[j % N_ENCODED], timeout=120)
            lat[j] = time.perf_counter() - t

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CLIENTS) as pool:
            list(pool.map(one, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = read()                             # read just after the run
        paths = read_paths()
        batches = list(server.batch_sizes)
    finally:
        server.stop()
    require(not server._thread.is_alive(), "server thread did not stop")
    require(len(batches) > 0, "no coalesced batch was served")
    for name, _, _, per_batch in counters:
        require(launches[name] == per_batch * len(batches),
                f"{name} launched {launches[name]} times for {len(batches)} coalesced "
                f"batches, not {per_batch} each")
    for ids, scores in answers:
        require(ids.shape == (k,) and scores.shape == (k,), "answer shape")
        require(bool((ids >= 0).all() and (ids < n_index).all()), "answer id out of range")
        require(bool((scores[:-1] >= scores[1:]).all()), "answer scores not sorted descending")

    # one coalesced batch of answers against the plain search on the same reps
    tokens = corpus.queries[:max_batch]
    q_reps = retriever.encode_queries(tokens)
    rs, ri = topk_ref.topk_scores_ref(q_reps, store.reps, k + 1, col_valid=store.row_valid)
    s = torch.as_tensor(np.stack([answers[j][1] for j in range(max_batch)]), device=DEVICE)
    i = torch.as_tensor(np.stack([answers[j][0] for j in range(max_batch)]), device=DEVICE)
    tol = SCORE_RTOL * max(1.0, rs[:, 0].abs().max().item())
    err, clear = check_topk(topk_ref, s, i, rs, ri, tol, "served batch vs plain")
    encoded_hits = int((i < N_ENCODED).sum().item())
    search_ms = cuda_ms(lambda: retriever.search_reps_tensors(q_reps), 10)
    encode_ms = cuda_ms(lambda: retriever.encode_queries(tokens), 10)
    ms = sorted(x * 1e3 for x in lat)
    return {
        "model": "dpr-bert-base (2 x bert-base-uncased, 12 layers, d 768, seeded init)",
        "attention_impl": bert_cfg.attention_impl,
        "precision": precision, "search_impl": SEARCH_IMPL, "top_k": k,
        "index_rows": n_index, "encoded_rows": N_ENCODED, "p_len": P_LEN,
        "q_len": SERVE_TOPK["q_len"], "index_bytes": store.bytes_per_device(),
        "setup_s": setup_s, "index_build_s": index_s, "index_encode_launches": encode_launches,
        "requests": N_REQUESTS, "clients": CLIENTS, "qps": N_REQUESTS / wall,
        "p50_ms": statistics.median(ms), "p99_ms": ms[int(0.99 * (len(ms) - 1))],
        "batches": len(batches), "mean_batch": sum(batches) / len(batches),
        "launches": launches, "paths": paths, "batch_max_abs_err": err, "batch_tolerance": tol,
        "batch_clear_slots": clear, "batch_slots": i.numel(),
        "batch_hits_in_encoded_rows": encoded_hits,
        "fused_search_ms_one_batch": search_ms, "encode_ms_one_batch": encode_ms,
    }


def infonce_bound_ms(m: int, n: int, n_valid: int, d: int, itemsize: int, kernel: str,
                     route: str = ""):
    """(bound_ms, bound_by) of one fused_infonce kernel: inputs read once
    (q, p, labels, col_valid; the backward also lse, g_lse, g_pos) and
    outputs written once, over HBM bandwidth; the products over the valid
    columns over the peak of their type (bf16 tensor cores for 2-byte
    operands, fp32 outside the tensor cores for 4-byte ones on the "fp32"
    route): 2*M*N_valid*d for the forward, 4*M*N_valid*d for dQ or dP (the
    scores again, then the product); on the "tf32x3" route three times
    those on the TF32 tensor cores (each product is three TF32 products)."""
    moved = (m + n) * d * itemsize + 4 * m + n
    if kernel == "fwd":
        moved += 3 * 4 * m
        ops = 2.0 * m * n_valid * d
    else:
        moved += 3 * 4 * m + (m if kernel == "dq" else n) * d * itemsize
        ops = 4.0 * m * n_valid * d
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    if route == "tf32x3":
        ops, peak = 3 * ops, PEAK_TF32_FLOPS
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def close_err(x, ref, rtol_of_max, what):
    """Max abs error of x against ref; raises above rtol_of_max of the
    largest |ref|."""
    x, ref = x.float(), ref.float()
    tol = rtol_of_max * ref.abs().max().item()
    err = (x - ref).abs().max().item()
    require(err <= tol, f"{what}: max abs err {err} > {tol}")
    return err


def fp64_err_ratio(torch, got, plain, exact, plain_given, given, what):
    """A fp32 kernel's max error against ``exact`` (ref.py in float64) over
    the fp32 plain version's (``plain``, ref.py in fp32) against it; raises
    above FP64_ERR_RATIO. Also, not held: both given the forward's lse, the
    kernel's error and the plain version's (``plain_given``) against ref.py
    in float64 with that lse (``given``): the two arithmetics on one
    problem, without the plain version's advantage that its coefficients
    share its own lse's rounding (a dominant one comes out exactly 1)."""
    err = (got.double() - exact).abs().max().item()
    own = (plain.double() - exact).abs().max().item()
    ratio = err / own if own else (0.0 if err == 0 else math.inf)
    require(ratio <= FP64_ERR_RATIO, f"{what}: error against float64 {err} is {ratio}x the fp32 "
                                     f"plain version's {own} (> {FP64_ERR_RATIO}x)")
    err_given = (got.double() - given).abs().max().item()
    plain_err_given = (plain_given.double() - given).abs().max().item()
    return {"fp64_max_abs_err": err, "plain_fp64_max_abs_err": own, "fp64_err_ratio": ratio,
            "fp64_given_lse_max_abs_err": err_given,
            "plain_fp64_given_lse_max_abs_err": plain_err_given,
            "fp64_given_lse_err_ratio": err_given / plain_err_given if plain_err_given else None}


def fp64_lse_ratio(torch, lse, plain, exact, what):
    """A fp32 forward's max lse error against ``exact`` (ref.py in float64)
    over the fp32 plain version's (``plain``) against it, over the rows
    with a valid column; raises above FP64_ERR_RATIO: the backward's
    coefficients exp(s - lse) take this lse against scores of their own."""
    from repro_torch.core.precision import NEG_INF

    live = exact > NEG_INF / 2
    if not bool(live.any()):
        return {}
    err = (lse.double() - exact)[live].abs().max().item()
    own = (plain.double() - exact)[live].abs().max().item()
    ratio = err / own if own else (0.0 if err == 0 else math.inf)
    require(ratio <= FP64_ERR_RATIO, f"{what}: lse error against float64 {err} is {ratio}x the "
                                     f"fp32 plain version's {own} (> {FP64_ERR_RATIO}x)")
    return {"lse_fp64_max_abs_err": err, "plain_lse_fp64_max_abs_err": own,
            "lse_fp64_err_ratio": ratio}


def grad_turns(torch, fn, parent_fn, reps, what, require_faster=True):
    """Device ms of ``fn`` and of its parent route in turns (parent, new,
    new, parent); raises unless the new route is faster in every turn
    (with ``require_faster``; else reports whether it is)."""
    from repro_torch.kernels._timing import device_ms

    turns = {"ms": [], "parent_ms": []}
    for key, call in (("parent_ms", parent_fn), ("ms", fn), ("ms", fn), ("parent_ms", parent_fn)):
        turns[key].append(device_ms(call, reps))
    faster = max(turns["ms"]) < min(turns["parent_ms"])
    require(faster or not require_faster,
            f"{what}: the new route ({turns['ms']} ms) is not faster than its parent "
            f"({turns['parent_ms']} ms) in every turn")
    return {"ms_turns": turns["ms"], "parent_ms": statistics.mean(turns["parent_ms"]),
            "parent_ms_turns": turns["parent_ms"], "faster_in_every_turn": faster}


def phase_infonce_kernels(torch):
    """fused_infonce forward, dQ and dP against the plain version and
    against the dense backend (the yardstick), at the path shapes and at an
    fp32 and a small ragged case."""
    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16, CONTACCUM_MINED
    from repro_torch.core.loss import DenseLossBackend
    from repro_torch.core.precision import NEG_INF
    from repro_torch.kernels.fused_infonce import ops, ref
    from repro_torch.kernels._timing import cuda_ms, device_ms

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    d = BERT_BASE.d_model
    local = CONTACCUM_BF16["global_batch"] // CONTACCUM_BF16["accum_steps"]     # 8
    bank = CONTACCUM_BF16["bank_size"]                                          # 2048
    n_path = local * (1 + CONTACCUM_BF16["n_hard"]) + bank                       # 2064
    n_own_mined = local * (1 + CONTACCUM_MINED["n_hard"] + CONTACCUM_MINED["mined_negatives"])
    n_mined = n_own_mined + bank                                                 # 2096
    dense = DenseLossBackend()

    def case(m, n, dd, dtype, n_masked, labels, scale=0.2):
        q = (torch.randn((m, dd), generator=g, device=dev) * scale).to(dtype)
        p = (torch.randn((n, dd), generator=g, device=dev) * scale).to(dtype)
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        if n_masked:
            valid[-n_masked:] = False
        g_lse = torch.rand((m,), generator=g, device=dev)
        g_pos = -torch.rand((m,), generator=g, device=dev)
        return q, p, labels.to(torch.int32), valid, g_lse, g_pos

    def check(name, q, p, labels, valid, g_lse, g_pos, timed, parent=False):
        ops.reset_launches()
        lse, pos, amax = ops.fused_infonce_fwd(q, p, labels, valid)
        dq = ops.fused_infonce_dq(q, p, labels, valid, lse, g_lse, g_pos)
        dp = ops.fused_infonce_dp(q, p, labels, valid, lse, g_lse, g_pos)
        torch.cuda.synchronize()
        paths = {kernel: next(k for k, v in getattr(ops, f"fused_infonce_{kernel}").paths.items()
                              if v) for kernel in ("fwd", "dq", "dp")}
        rl, rp, ra = ref.infonce_stats_ref(q, p, labels, valid)
        rdq, rdp = ref.infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos)
        # the tolerance's scale: the largest |logit| of a valid column (a
        # label on a masked column has pos = NEG_INF, which must match exactly)
        finite = torch.cat([ra, rp])
        finite = finite[finite > NEG_INF / 2]
        stats_tol = STATS_RTOL * max(1.0, finite.abs().max().item() if finite.numel() else 1.0)
        require(torch.equal(pos <= NEG_INF / 2, rp <= NEG_INF / 2),
                f"{name}: pos at masked labels differs from the plain version")
        live = rp > NEG_INF / 2

        def stats_err_of(stats):
            s_lse, s_pos, s_amax = stats
            return max((s_lse - rl).abs().max().item(), (s_amax - ra).abs().max().item(),
                       (s_pos[live] - rp[live]).abs().max().item())

        stats_err = stats_err_of((lse, pos, amax))
        require(bool(torch.isfinite(lse).all()), f"{name}: non-finite lse")
        require(stats_err <= stats_tol, f"{name}: lse/pos/amax err {stats_err} > {stats_tol}")
        grad_rtol = GRAD_RTOL_BF16 if q.dtype == torch.bfloat16 else GRAD_RTOL_FP32
        out = {"M": q.shape[0], "N": p.shape[0], "n_valid": int(valid.sum().item()),
               "d": q.shape[1], "dtype": str(q.dtype).replace("torch.", ""),
               "stats_max_abs_err": stats_err, "stats_tolerance": stats_tol,
               "dq_max_abs_err": close_err(dq, rdq, grad_rtol, f"{name} dq"),
               "dp_max_abs_err": close_err(dp, rdp, grad_rtol, f"{name} dp"),
               "grad_rtol_of_max": grad_rtol, "paths": paths}
        if q.dtype == torch.float32:   # the forward, dQ and dP on 3xTF32
            require(paths == {kernel: ops.path_of(kernel, q.dtype, q.shape[0], q.shape[1])
                              for kernel in ("fwd", "dq", "dp")}
                    and set(paths.values()) == {"tf32x3"},
                    f"{name}: paths {paths}, not the tf32x3 forward, dQ and dP")
            plain_given = ref.infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos, lse=lse)
            given, own = (ref.infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos,
                                                    dtype=torch.float64, lse=l)
                          for l in (lse, None))
            out["dq_fp64"] = fp64_err_ratio(torch, dq, rdq, own[0], plain_given[0], given[0],
                                            f"{name} dq")
            out["dp_fp64"] = fp64_err_ratio(torch, dp, rdp, own[1], plain_given[1], given[1],
                                            f"{name} dp")
        if not timed:
            return out
        m, n, dd = q.shape[0], p.shape[0], q.shape[1]
        args = (q, p, labels, valid, lse, g_lse, g_pos)

        def plain_bwd(which):
            qf = q.float().requires_grad_(which == "dq")
            pf = p.float().requires_grad_(which == "dp")
            sl, sp, _ = ref.infonce_stats_ref(qf, pf, labels, valid)
            wrt = qf if which == "dq" else pf
            return lambda: torch.autograd.grad((sl, sp), wrt, (g_lse, g_pos), retain_graph=True)

        def library_bwd(which):
            qf = q.detach().requires_grad_(which == "dq")
            pf = p.detach().requires_grad_(which == "dp")
            sl, sp, _ = dense.chunk_stats(qf, pf, labels, valid, temperature=1.0)
            wrt = qf if which == "dq" else pf
            return lambda: torch.autograd.grad((sl, sp), wrt, (g_lse, g_pos), retain_graph=True)

        for kernel, fn, plain, library in (
            ("fwd", lambda: ops.fused_infonce_fwd(q, p, labels, valid),
             lambda: ref.infonce_stats_ref(q, p, labels, valid),
             lambda: dense.chunk_stats(q, p, labels, valid, temperature=1.0)),
            ("dq", lambda: ops.fused_infonce_dq(*args), plain_bwd("dq"), library_bwd("dq")),
            ("dp", lambda: ops.fused_infonce_dp(*args), plain_bwd("dp"), library_bwd("dp")),
        ):
            bound_ms, bound_by = infonce_bound_ms(m, n, out["n_valid"], dd, q.element_size(), kernel)
            out[kernel] = {"ms": device_ms(fn, 20), "plain_ms": device_ms(plain, 5),
                           "library_ms": device_ms(library, 5), "bound_ms": bound_ms,
                           "bound_by": bound_by, "ms_with_enqueue": cuda_ms(fn, 20)}
        if parent:
            # each kernel on its Hopper path against the wmma kernels it took
            # before, in turns (parent, Hopper, Hopper, parent), both held to
            # the plain version
            routes = {
                "fwd": (lambda: ops.fused_infonce_fwd(q, p, labels, valid),
                        lambda: ops.stats_on_path("wmma", q, p, labels, valid)),
                "dq": (lambda: ops.fused_infonce_dq(*args),
                       lambda: ops.grad_on_path("dq", "wmma", *args)),
                "dp": (lambda: ops.fused_infonce_dp(*args),
                       lambda: ops.grad_on_path("dp", "wmma", *args)),
            }
            for kernel, (fn, parent_fn) in routes.items():
                if paths[kernel] != "hopper":
                    continue
                got = parent_fn()
                if kernel == "fwd":
                    err = stats_err_of(got)
                    require(err <= stats_tol, f"{name} forward on the wmma path: err {err} > "
                                              f"{stats_tol}")
                else:
                    err = close_err(got, rdq if kernel == "dq" else rdp, grad_rtol,
                                    f"{name} {kernel} on the wmma path")
                turns = {"ms": [], "parent_ms": []}
                for key, call in (("parent_ms", parent_fn), ("ms", fn), ("ms", fn),
                                  ("parent_ms", parent_fn)):
                    turns[key].append(device_ms(call, 20))
                out[kernel].update({"ms_turns": turns["ms"], "parent_route": "wmma",
                                    "parent_ms": statistics.mean(turns["parent_ms"]),
                                    "parent_ms_turns": turns["parent_ms"],
                                    "parent_max_abs_err": err})
                require(max(turns["ms"]) < min(turns["parent_ms"]),
                        f"{name}: the Hopper {kernel} ({turns['ms']} ms) is not faster than the "
                        f"wmma kernels ({turns['parent_ms']} ms)")
        return out

    result = {}
    labels8 = torch.arange(local, device=dev)
    labels8[local - 3], labels8[local - 2] = -1, n_path + 5     # outside [0, N): pos = 0
    q, p, labels, valid, g_lse, g_pos = case(local, n_path, d, torch.bfloat16, N_BANK_MASKED, labels8)
    result["local_rows"] = check("M=8", q, p, labels, valid, g_lse, g_pos, timed=True)
    pos = ops.fused_infonce_fwd(q, p, labels, valid)[1]
    require(pos[local - 3].item() == 0.0 and pos[local - 2].item() == 0.0,
            "out-of-range labels did not give pos = 0")
    labels_bank = local * (1 + CONTACCUM_BF16["n_hard"]) + torch.arange(bank, device=dev)
    result["bank_rows"] = check("M=2048", *case(bank, n_path, d, torch.bfloat16, N_BANK_MASKED,
                                                labels_bank), timed=True)
    # a passage tile whose columns are all masked is written as zeros without
    # its products (16 of the 33 above): the train phase after its warm-up
    # masks none
    result["bank_rows_all_valid"] = check("M=2048 all valid", *case(
        bank, n_path, d, torch.bfloat16, 0, labels_bank), timed=True)
    # the contaccum_mined chunk: 48 columns of its own, the banks' 2048
    labels_mined = torch.arange(local, device=dev)
    labels_mined[local - 1] = -1
    for suffix, n_masked in (("_mined", N_BANK_MASKED), ("_mined_all_valid", 0)):
        result["local_rows" + suffix] = check(
            f"M=8 N={n_mined}{suffix}",
            *case(local, n_mined, d, torch.bfloat16, n_masked, labels_mined), timed=True)
        result["bank_rows" + suffix] = check(
            f"M=2048 N={n_mined}{suffix}",
            *case(bank, n_mined, d, torch.bfloat16, n_masked,
                  n_own_mined + torch.arange(bank, device=dev)), timed=True)
    # the lm phase's chunk: the same rows and columns at internlm2-1.8b's
    # d = LM_D, every kernel on its Hopper path (the split kernels at the
    # local rows; the many-row forward and the cluster dP at the bank rows,
    # whose dQ has no caller and stays on wmma), each timed in turns with
    # the wmma kernels it took before
    for suffix, n_masked in (("", N_BANK_MASKED), ("_all_valid", 0)):
        result["lm_local_rows" + suffix] = check(
            f"LM M=8{suffix}", *case(local, n_path, LM_D, torch.bfloat16, n_masked, labels8),
            timed=True, parent=True)
        result["lm_bank_rows" + suffix] = check(
            f"LM M=2048{suffix}", *case(bank, n_path, LM_D, torch.bfloat16, n_masked,
                                        labels_bank), timed=True, parent=True)
        for shape in ("lm_local_rows" + suffix, "lm_bank_rows" + suffix):
            for kernel in ("fwd", "dq", "dp"):
                want = "wmma" if kernel == "dq" and "bank" in shape else "hopper"
                require(result[shape]["paths"][kernel] == want,
                        f"{shape} {kernel} took the {result[shape]['paths'][kernel]} path, "
                        f"not {want}")
        dq = result["lm_local_rows" + suffix]["dq"]
        require(max(dq["ms_turns"]) < dq["library_ms"],
                f"lm_local_rows{suffix}: the Hopper dQ ({dq['ms_turns']} ms) is not faster "
                f"than the dense backend ({dq['library_ms']} ms)")
    result["lm_plan"] = {"local_rows_ranks": ops.small_ranks(LM_D),
                         **{f"local_rows_{k}_blocks": ops.hopper_blocks(k, local, n_path, d=LM_D)
                            for k in ("fwd", "dq", "dp")},
                         "bank_rows_dp_ranks": ops.dp_plan(bank)[0],
                         "bank_rows_dp_blocks": ops.hopper_blocks("dp", bank, n_path, d=LM_D),
                         "bank_rows_fwd_blocks": ops.hopper_blocks("fwd", bank, n_path, d=LM_D)}
    for shape, kernels in (("local_rows", ("fwd", "dq", "dp")), ("bank_rows", ("fwd", "dp")),
                           ("bank_rows_all_valid", ("fwd", "dp")),
                           ("local_rows_mined", ("fwd", "dq", "dp")),
                           ("local_rows_mined_all_valid", ("fwd", "dq", "dp")),
                           ("bank_rows_mined", ("fwd", "dp")),
                           ("bank_rows_mined_all_valid", ("fwd", "dp"))):
        for kernel in kernels:
            require(result[shape]["paths"][kernel] == "hopper",
                    f"{shape} {kernel} took the {result[shape]['paths'][kernel]} path, not Hopper")
    ranks, rows = ops.dp_plan(bank)
    result["dp_plan"] = {"M": bank, "ranks": ranks, "rows_per_rank": rows,
                         "blocks": ops.hopper_blocks("dp", bank, n_path),
                         "max_active_clusters": ops.dp_max_clusters(ranks),
                         "sm_count": torch.cuda.get_device_properties(dev).multi_processor_count}
    sms = result["dp_plan"]["sm_count"]
    result["fwd_plan"] = {"M": bank, "rows_per_block": ops.fwd_plan(bank, n_path, sms),
                          "blocks": ops.hopper_blocks("fwd", bank, n_path, sms),
                          "blocks_local_rows": ops.hopper_blocks("fwd", local, n_path, sms)}
    result["fp32"] = check("fp32", *case(64, 1000, d, torch.float32, 100,
                                         torch.randint(0, 900, (64,), generator=g, device=dev)),
                           timed=False)
    result["ragged"] = check("ragged", *case(37, 301, 96, torch.bfloat16, 50,
                                             torch.randint(0, 251, (37,), generator=g, device=dev)),
                             timed=False)
    return result


def contaccum_setup(torch, towers, total_steps, generator=None):
    """The contaccum_bf16 cell on ``towers`` (a BertConfig, or a built
    DualEncoder), seeded: encoder, contrastive config, optimizer (warmup,
    then linear decay to 0 at ``total_steps``), update, initial state (drawn
    from ``generator``, a CPU generator seeded SEED by default), corpus,
    loader and the batch function a Trainer draws from."""
    import types

    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16
    from repro_torch.core.methods import build_step_program, init_state
    from repro_torch.core.types import ContrastiveConfig, DualEncoder, RetrievalBatch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.optim import adamw, chain, clip_by_global_norm, linear_warmup_linear_decay

    cell = CONTACCUM_BF16
    enc = (towers if isinstance(towers, DualEncoder)
           else make_bert_dual_encoder(towers, precision=cell["precision"]))
    cfg = ContrastiveConfig(
        method=cell["method"], accumulation_steps=cell["accum_steps"],
        bank_size=cell["bank_size"], loss_impl=cell["loss_impl"],
        precision=cell["precision"], temperature=1.0, grad_clip_norm=2.0,
    )
    tx = chain(clip_by_global_norm(cfg.grad_clip_norm),
               adamw(linear_warmup_linear_decay(PEAK_LR, WARMUP_STEPS, total_steps)))
    corpus = SyntheticRetrievalCorpus(
        n_passages=N_CORPUS, vocab_size=BERT_BASE.vocab_size, q_len=cell["q_len"],
        p_len=cell["p_len"], n_hard=cell["n_hard"], seed=SEED,
    )
    loader = ShardedLoader(N_CORPUS, cell["global_batch"], seed=SEED)

    def next_batch(step):
        b = corpus.batch(loader.next_indices())
        return RetrievalBatch(*(torch.from_numpy(np.asarray(b[key], np.int64)).to(DEVICE)
                                for key in ("query", "passage_pos", "passage_hard")))

    return types.SimpleNamespace(
        enc=enc, cfg=cfg, tx=tx, update=build_step_program(enc, tx, cfg).update,
        state=init_state(generator or torch.Generator().manual_seed(SEED), enc, tx, cfg,
                         device=DEVICE),
        corpus=corpus, loader=loader, next_batch=next_batch,
    )


def phase_train(torch, topk_ops):
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16
    from repro_torch.core.methods import build_step_program
    from repro_torch.evaluation import evaluate_topk
    from repro_torch.kernels.fused_infonce import ops
    from repro_torch.retrieval import RetrieverConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cell = CONTACCUM_BF16
    k, batch = cell["accum_steps"], cell["global_batch"]
    t0 = time.perf_counter()
    run = contaccum_setup(torch, BERT_BASE, TRAIN_STEPS)
    enc, cfg, tx, update, state = run.enc, run.cfg, run.tx, run.update, run.state
    corpus, loader, next_batch = run.corpus, run.loader, run.next_batch
    setup_s = time.perf_counter() - t0
    tokens_per_step = batch * (cell["q_len"] + cell["p_len"] * (1 + cell["n_hard"]))
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_dir=tmp,
                             checkpoint_every=CHECKPOINT_EVERY, keep_checkpoints=1, log_every=5)
        trainer = Trainer(tcfg, update, next_batch, loader_state=loader.state)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                               # the train path's run starts here
        t0 = time.perf_counter()
        state, report = trainer.run(state)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"fwd": ops.fused_infonce_fwd.launches, "dq": ops.fused_infonce_dq.launches,
                    "dp": ops.fused_infonce_dp.launches}      # read just after the run
        paths = {kernel: dict(getattr(ops, f"fused_infonce_{kernel}").paths)
                 for kernel in ("fwd", "dq", "dp")}
        peak_bytes = torch.cuda.max_memory_allocated()
        hist = report.history
        require(report.steps_run == TRAIN_STEPS and report.restarts == 0,
                f"ran {report.steps_run} steps with {report.restarts} restarts")
        require(all(np.isfinite(h["loss"]) for h in hist), "non-finite training loss")
        last = hist[-1]
        require(last["bank_fill_q"] == last["bank_fill_p"] == cell["bank_size"],
                f"banks not full: {last['bank_fill_q']}, {last['bank_fill_p']}")
        n_neg = batch // k * (1 + cell["n_hard"]) + cell["bank_size"] - 1
        require(last["n_negatives"] == n_neg, f"n_negatives {last['n_negatives']} != {n_neg}")
        banks = tuple(type(b)(*(t.clone() for t in b)) for b in (state.bank_q, state.bank_p))
        want = {"fwd": 2 * k * TRAIN_STEPS, "dq": k * TRAIN_STEPS, "dp": 2 * k * TRAIN_STEPS}
        require(launches == want, f"fused_infonce launches {launches} != {want}")
        for kernel in ("fwd", "dq", "dp"):
            require(paths[kernel]["hopper"] == launches[kernel],
                    f"fused_infonce {kernel} took {paths[kernel]}, not all the Hopper kernels")

        # one step from the trained state and a fresh batch on both backends
        parity_batch = next_batch(TRAIN_STEPS)
        dense_update = build_step_program(enc, tx, dataclasses.replace(cfg, loss_impl="dense")).update
        _, m_fused = update(state, parity_batch)
        _, m_dense = dense_update(state, parity_batch)
        parity = {key: (float(getattr(m_fused, key)), float(getattr(m_dense, key)))
                  for key in ("loss", "grad_norm", "accuracy")}
        for key, rtol in (("loss", PARITY_LOSS_RTOL), ("grad_norm", PARITY_GRAD_RTOL)):
            fz, dn = parity[key]
            require(abs(fz - dn) <= rtol * abs(dn), f"dense vs fused {key}: {fz} vs {dn}")

        # the share of a step in the three kernels, from a profile of one step
        share = profile_step_share(torch, lambda: update(state, parity_batch))

        # a second Trainer on the same directory resumes from the saved step
        resumed = Trainer(dataclasses.replace(tcfg, total_steps=TRAIN_STEPS + 1), update,
                          next_batch, loader_state=type(loader.state)())
        _, report2 = resumed.run(state)
        require(report2.steps_run == 1 and report2.history[0]["step"] == TRAIN_STEPS,
                f"resume ran steps {[h['step'] for h in report2.history]}")
        require(np.isfinite(report2.history[0]["loss"]), "resumed step loss not finite")

    # Top@k eval through the fused search kernel
    topk_ops.reset_launches()
    t0 = time.perf_counter()
    recalls = evaluate_topk(
        enc, state.params, corpus, ks=(1, 5, 20),
        cfg=RetrieverConfig(top_k=20, search_impl="fused", precision=cell["precision"]),
        device=DEVICE,
    )
    eval_s = time.perf_counter() - t0
    eval_launches = topk_ops.fused_topk.launches
    eval_paths = dict(topk_ops.fused_topk.paths)
    require(eval_launches > 0, "evaluate_topk did not launch fused_topk")
    require(eval_paths["hopper"] == eval_launches,
            f"the eval's searches took {eval_paths}, not all the Hopper kernel")
    require(all(np.isfinite(v) for v in recalls.values()), f"non-finite recall {recalls}")

    times = [h["step_time_s"] for h in hist[1:]]
    step_s = statistics.median(times)
    return {
        "model": "dpr-bert-base (2 x bert-base-uncased, 12 layers, d 768, seeded init, remat full)",
        "cell": "contaccum_bf16", "steps": TRAIN_STEPS, "accumulation_steps": k,
        "global_batch": batch, "bank_size": cell["bank_size"], "q_len": cell["q_len"],
        "p_len": cell["p_len"], "n_hard": cell["n_hard"], "precision": cell["precision"],
        "loss_impl": cell["loss_impl"], "corpus": N_CORPUS, "setup_s": setup_s,
        "train_s": train_s, "first_step_s": hist[0]["step_time_s"],
        "median_step_s": step_s, "pairs_per_s": batch / step_s,
        "tokens_per_s": tokens_per_step / step_s, "tokens_per_step": tokens_per_step,
        "max_memory_allocated": peak_bytes,
        "first_loss": hist[0]["loss"], "last_loss": last["loss"],
        "first_grad_norm_ratio": hist[0]["grad_norm_ratio"],
        "last_grad_norm_ratio": last["grad_norm_ratio"],
        "bank_fill": [last["bank_fill_q"], last["bank_fill_p"]],
        "n_negatives": last["n_negatives"], "launches": launches, "infonce_paths": paths,
        "dense_vs_fused": parity, "infonce_share": share,
        "resumed_from_step": report2.history[0]["step"] - 1,
        "eval": recalls, "eval_s": eval_s, "eval_fused_topk_launches": eval_launches,
        "eval_fused_topk_paths": eval_paths,
    }, banks


def profile_step_share(torch, fn):
    """``fn()`` once to warm up, then once under torch.profiler (CPU and
    CUDA activity): its wall time, the device time of its kernels (busy
    share = device / wall), their launches, the parts in the fused_infonce
    and flash kernels, and the kernels that take the most device time.
    Reads the profiler's raw events, which stays seconds where
    ``key_averages()`` over a long profile takes minutes. The device fields
    are None where the profile shows no kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    kernels = sorted(((key, ms, c) for key, (ms, c) in by_name.items()), key=lambda k: -k[1])
    kernel_ms = sum(ms for _, ms, _ in kernels)
    if kernel_ms <= 0:
        return {"step_wall_ms": wall_ms, "device_ms": None, "infonce_ms": None,
                "share_of_device": None, "busy_share": None, "flash_ms": None,
                "top_kernels": [], "infonce_kernels": []}
    infonce = [{"name": key[:80], "ms": ms, "count": c} for key, ms, c in kernels
               if "infonce" in key]
    flash = [(ms, c) for key, ms, c in kernels if "flash_fwd_kernel" in key]
    infonce_ms = sum(k["ms"] for k in infonce)
    return {"step_wall_ms": wall_ms, "device_ms": kernel_ms, "infonce_ms": infonce_ms,
            "share_of_device": infonce_ms / kernel_ms, "busy_share": kernel_ms / wall_ms,
            "flash_ms": sum(ms for ms, _ in flash), "flash_launches": sum(c for _, c in flash),
            "kernel_launches": sum(c for _, _, c in kernels),
            "top_kernels": [{"name": key[:80], "ms": ms, "count": c}
                            for key, ms, c in kernels[:10]],
            "infonce_kernels": infonce}


def mine_corpus():
    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_MINED
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus

    cell = CONTACCUM_MINED
    return SyntheticRetrievalCorpus(
        n_passages=MINE_CORPUS, vocab_size=BERT_BASE.vocab_size, q_len=cell["q_len"],
        p_len=cell["p_len"], n_hard=cell["n_hard"], seed=SEED,
    )


def mine_turn(torch, corpus, banks, *, sync, ckpt_dir=None, resume=False):
    """One run of the mine phase from the seeded initial state with
    ``banks`` (bank_q, bank_p) already full: a Trainer with the miner's
    refresh hook (``sync``: the loop waits for each refresh), its loop on a
    high-priority stream. ``train_s`` runs until the
    last refresh has landed (an async refresh requested while one is in
    flight is skipped, as the miner's contract says, and counted); steps
    are timed by the Trainer on the loop's stream (no device-wide sync,
    which would wait for the miner). ``outside_steps_s`` is what training
    spent outside its steps: refreshes waited for, the last refresh's
    drain, snapshots and the checkpoint. With ``ckpt_dir`` the run checkpoints at its
    end (inside ``train_s``); with ``resume`` too, a second Trainer with a
    new miner then resumes from it for one step.
    The result keeps the miner (key "miner") and each published table by
    version ("tables") for the caller."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16, CONTACCUM_MINED
    from repro_torch.core.memory_bank import BankState
    from repro_torch.core.methods import build_step_program
    from repro_torch.core.types import RetrievalBatch
    from repro_torch.data.loader import MinedNegativeInjector, ShardedLoader
    from repro_torch.kernels.fused_infonce import ops as infonce_ops
    from repro_torch.kernels.fused_topk import ops as topk_ops
    from repro_torch.mining import HardNegativeMiner, MinerConfig
    from repro_torch.runtime.trainer import PeriodicHook, Trainer, TrainerConfig, priority_stream

    # contaccum_mined is contaccum_bf16's geometry plus the mined columns:
    # the train phase's encoder, config, optimizer and seeded state
    cell = CONTACCUM_MINED
    require({key: v for key, v in CONTACCUM_BF16.items() if key not in ("precision", "loss_impl")}
            == {key: v for key, v in cell.items() if key != "mined_negatives"},
            "contaccum_mined is not contaccum_bf16's geometry")
    k, batch = cell["accum_steps"], cell["global_batch"]
    # the caching allocator keeps freed blocks with the stream that used
    # them, and every turn runs on new streams: release the earlier ones
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = contaccum_setup(torch, BERT_BASE, MINE_STEPS)
    enc, update = run.enc, run.update
    state = run.state._replace(**{name: BankState(*(t.clone() for t in bank))
                                  for name, bank in zip(("bank_q", "bank_p"), banks)})
    precision = run.cfg.precision
    mcfg = MinerConfig(
        refresh_every=MINE_EVERY, top_k=MINE_TOPK, n_negatives=cell["mined_negatives"],
        depth_lo=MINE_BAND[0], depth_hi=MINE_BAND[1], sync=sync, search_impl="fused",
        precision=precision,
    )

    def make_run(steps):
        """A miner, loader, injector and Trainer over ``corpus``."""
        miner = HardNegativeMiner(enc, mcfg, queries=corpus.queries, passages=corpus.passages,
                                  device=DEVICE)
        loader = ShardedLoader(MINE_CORPUS, batch, seed=SEED)
        injector = MinedNegativeInjector(miner.buffer.read, MINE_CORPUS, seed=SEED,
                                         state=loader.state, on_step=miner.note_step)
        in_flight, tables = [], {}

        def next_batch(step):
            in_flight.append(miner.in_flight())
            table = miner.buffer.read()
            tables.setdefault(table.version, table)
            idx = loader.next_indices()
            b = corpus.batch(idx)
            mined = corpus.passages[injector.mined_ids(idx, gold=idx, step=step)]
            hard = np.concatenate([b["passage_hard"], mined], axis=1)
            return RetrievalBatch(*(torch.from_numpy(np.asarray(x, np.int64)).to(DEVICE)
                                    for x in (b["query"], b["passage_pos"], hard)))

        tcfg = TrainerConfig(total_steps=steps, checkpoint_dir=ckpt_dir,
                             checkpoint_every=1 << 30, keep_checkpoints=1, log_every=4)
        hook = PeriodicHook(every=MINE_EVERY, fn=miner.refresh_hook, prefix="mine/",
                            name="mine", advisory=False)
        trainer = Trainer(tcfg, update, next_batch, loader_state=loader.state, hooks=[hook],
                          aux_state=miner)
        return miner, trainer, in_flight, tables, next_batch

    miner, trainer, in_flight, tables, next_batch = make_run(MINE_STEPS)
    setup_s = time.perf_counter() - t0
    infonce_ops.reset_launches()
    topk_ops.reset_launches()                      # the mine path's run starts here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with priority_stream(DEVICE):
        state, report = trainer.run(state)
        miner.wait()                               # the last refresh lands (or raises)
    torch.cuda.current_stream().synchronize()      # the loop's stream, not the miner's
    train_s = time.perf_counter() - t0
    launches = {"fwd": infonce_ops.fused_infonce_fwd.launches,
                "dq": infonce_ops.fused_infonce_dq.launches,
                "dp": infonce_ops.fused_infonce_dp.launches}
    paths = {kernel: dict(getattr(infonce_ops, f"fused_infonce_{kernel}").paths)
             for kernel in ("fwd", "dq", "dp")}
    topk_launches, topk_paths = topk_ops.fused_topk.launches, dict(topk_ops.fused_topk.paths)
    peak = torch.cuda.max_memory_allocated()       # read just after the run

    hist = report.history
    require(report.steps_run == MINE_STEPS and report.restarts == 0,
            f"mine: ran {report.steps_run} steps with {report.restarts} restarts")
    require(all(np.isfinite(h["loss"]) for h in hist), "mine: non-finite training loss")
    # every chunk of every step: 8 x (1 + 1 + 4) columns of its own (the
    # mined ones included) and two full banks of 2048: 2096 columns
    n_neg = batch // k * (1 + cell["n_hard"] + cell["mined_negatives"]) + cell["bank_size"] - 1
    negatives = [h["n_negatives"] for h in hist]
    require(all(n == n_neg for n in negatives),
            f"mine: n_negatives {negatives}, not {n_neg} at every step")
    require(all(h["bank_fill_q"] == h["bank_fill_p"] == cell["bank_size"] for h in hist),
            "mine: a bank was not full")
    want = {"fwd": 2 * k * MINE_STEPS, "dq": k * MINE_STEPS, "dp": 2 * k * MINE_STEPS}
    require(launches == want, f"mine: fused_infonce launches {launches} != {want}")
    for kernel in ("fwd", "dq", "dp"):
        require(paths[kernel]["hopper"] == launches[kernel],
                f"mine: fused_infonce {kernel} took {paths[kernel]}, not all the Hopper kernels")
    searches = -(-MINE_CORPUS // mcfg.query_batch)
    require(miner.refreshes >= 1 and topk_launches == searches * miner.refreshes,
            f"mine: {topk_launches} fused_topk launches for {miner.refreshes} refreshes")
    require(topk_paths["hopper"] == topk_launches,
            f"mine: the miner's searches took {topk_paths}, not all the Hopper kernel")
    table = miner.buffer.read()
    tables.setdefault(table.version, table)
    require(table.version == miner.refreshes and (table.ids >= 0).mean() > 0.5,
            f"mine: table version {table.version}, {(table.ids >= 0).mean():.3f} filled")
    require(not (table.ids == np.arange(MINE_CORPUS)[:, None]).any(), "mine: gold was mined")

    times = [h["step_time_s"] for h in hist]
    flying = [t for t, f in zip(times[1:], in_flight[1:]) if f]
    grounded = [t for t, f in zip(times[1:], in_flight[1:]) if not f]
    med_in = statistics.median(flying) if flying else None
    med_out = statistics.median(grounded) if grounded else None
    out = {
        "sync": sync, "setup_s": setup_s, "train_s": train_s, "outside_steps_s": train_s - sum(times),
        "first_step_s": times[0],
        "step_times_s": times, "in_flight_at_step_start": in_flight[: len(times)],
        "median_step_s_refresh_in_flight": med_in, "median_step_s_no_refresh": med_out,
        "in_flight_over_no_refresh": (med_in / med_out) if flying and grounded else None,
        "refreshes": miner.refreshes, "skipped": miner.skipped,
        "refresh_s_total": sum(r["wall_s"] for r in miner.refresh_log),
        "refresh_log": miner.refresh_log,
        "staleness_at_hooks": [h["mine/table_staleness"] for h in hist
                               if "mine/table_staleness" in h],
        "losses": [h["loss"] for h in hist], "n_negatives": n_neg,
        "launches": launches, "infonce_paths": paths,
        "fused_topk_launches": topk_launches, "fused_topk_paths": topk_paths,
        "max_memory_allocated": peak, "miner": miner, "tables": tables,
    }
    if sync:
        # one step from the trained state and a mined batch on both loss
        # backends (no refresh in flight)
        parity_batch = next_batch(MINE_STEPS)
        dense_update = build_step_program(
            enc, run.tx, dataclasses.replace(run.cfg, loss_impl="dense")).update
        _, m_fused = update(state, parity_batch)
        _, m_dense = dense_update(state, parity_batch)
        parity = {key: (float(getattr(m_fused, key)), float(getattr(m_dense, key)))
                  for key in ("loss", "grad_norm", "accuracy")}
        for key, rtol in (("loss", PARITY_LOSS_RTOL), ("grad_norm", PARITY_GRAD_RTOL)):
            fz, dn = parity[key]
            require(abs(fz - dn) <= rtol * abs(dn), f"mine: dense vs fused {key}: {fz} vs {dn}")
        out["dense_vs_fused"] = parity
    if resume:
        # a second Trainer and a new miner resume from the saved step, with
        # the table published when it was saved (a refresh then in flight is
        # not saved)
        miner2, trainer2, _, _, _ = make_run(MINE_STEPS + 1)
        with priority_stream(DEVICE):
            _, report2 = trainer2.run(state)
            miner2.wait()
        restored = miner2.buffer.read()
        require(report2.steps_run == 1 and report2.history[0]["step"] == MINE_STEPS
                and np.isfinite(report2.history[0]["loss"]),
                f"mine: resume ran steps {[h['step'] for h in report2.history]}")
        saved = tables.get(restored.version)
        require(restored.version >= 1 and saved is not None
                and restored.step == saved.step and np.array_equal(restored.ids, saved.ids),
                f"mine: the resumed table v{restored.version} is none the run published")
        out["resume"] = {"from_step": MINE_STEPS - 1, "table_version": restored.version,
                         "table_step": restored.step, "loss": report2.history[0]["loss"]}
        miner2.close()
    return out


def mine_search_check(torch, miner, topk_ref):
    """The miner's search shape alone, on its last index and its first 256
    queries (one mined batch): the kernel held against ref.py (k + 1
    slots: scores within tol, ids equal at every clear slot; the seeded
    towers' reps crowd the top scores, so fewer slots are clear than in
    the kernels phase, and the shape is also held on seeded random rows
    with the kernels phase's share of clear slots), and the kernel, plain,
    library (torch.matmul + torch.topk) and bound times on the mined
    batch."""
    from repro_torch.kernels._timing import cuda_ms
    from repro_torch.kernels.fused_topk import ops

    r, k = miner.retriever, miner.cfg.top_k
    p = r.index.reps
    q = r.encode_queries(torch.from_numpy(miner.queries[: miner.cfg.query_batch]).to(DEVICE))
    ops.reset_launches()
    s, i = ops.fused_topk(q, p, k)
    require(ops.fused_topk.paths["hopper"] == 1, f"mine search: took {ops.fused_topk.paths}")
    rs, ri = topk_ref.topk_scores_ref(q, p, k + 1)
    tol = SCORE_RTOL * rs[:, 0].abs().max().item()
    err, bad, clear = topk_ref.topk_mismatch(s, i, rs, ri, tol)
    require(err <= tol and bad == 0,
            f"mine search: max |score err| {err} (tol {tol}), {bad} ids differ at clear slots")
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    qr = torch.randn(q.shape, generator=g, device=DEVICE).to(q.dtype)
    pr = torch.randn(p.shape, generator=g, device=DEVICE).to(p.dtype)
    rrs, rri = topk_ref.topk_scores_ref(qr, pr, k + 1)
    rand_err, rand_clear = check_topk(topk_ref, *ops.fused_topk(qr, pr, k), rrs, rri,
                                      SCORE_RTOL * rrs[:, 0].abs().max().item(),
                                      "mine search shape, random rows")
    bound_ms, bound_by = topk_bound_ms(q.shape[0], p.shape[0], p.shape[0], q.shape[1], k, 2)
    return {
        "Q": q.shape[0], "N": p.shape[0], "d": q.shape[1], "k": k, "dtype": "bf16",
        "max_abs_err": err, "tolerance": tol, "clear_slots": clear, "slots": i.numel(),
        "random_rows": {"max_abs_err": rand_err, "clear_slots": rand_clear},
        "path": "hopper", "ms": cuda_ms(lambda: ops.fused_topk(q, p, k), 20),
        "plain_ms": cuda_ms(lambda: topk_ref.topk_scores_ref(q, p, k), 3),
        "library_ms": cuda_ms(lambda: library_topk(q, p, k), 10),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def public(turn):
    return {key: v for key, v in turn.items() if key not in ("miner", "tables")}


def phase_mine(torch, topk_ref, banks):
    """contaccum_mined with an async turn (checkpointed, then resumed) and a
    sync turn from the same seeded state, ``banks`` (the train phase's, full)
    in both; their first tables (mined from the same params at step 3) must
    be identical. Then the miner's search shape alone, and the overlap the
    async turn shows (its ``train_s`` also holds its checkpoint save; the
    sync turn saves none), which must meet MINE_SAVED_SHARE and
    MINE_STEP_RATIO."""
    import gc
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    corpus = mine_corpus()
    corpus_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        turn_async = mine_turn(torch, corpus, banks, sync=False, ckpt_dir=tmp, resume=True)
    turn_async.pop("miner").close()
    emit({"phase": "mine_turn", **public(turn_async)})
    turn_sync = mine_turn(torch, corpus, banks, sync=True)
    emit({"phase": "mine_turn", **public(turn_sync)})
    ta, ts = turn_async.pop("tables"), turn_sync.pop("tables")
    require(1 in ta and 1 in ts and np.array_equal(ta[1].ids, ts[1].ids),
            "mine: the async and sync turns' first tables differ")
    miner = turn_sync.pop("miner")
    search = mine_search_check(torch, miner, topk_ref)
    miner.close()
    del miner
    gc.collect()
    torch.cuda.empty_cache()          # the later phases run on the default stream
    refresh_s = turn_sync["refresh_s_total"]
    saved_s = turn_sync["train_s"] - turn_async["train_s"]
    ratio = turn_async["in_flight_over_no_refresh"]
    # the same against the refreshes the async turn did (a request while
    # one is in flight is skipped, and the sync turn's time for it is not
    # overlap): the sync turn's mean refresh stands for each one
    per_refresh = refresh_s / turn_sync["refreshes"]
    done = turn_async["refreshes"]
    saved_done_s = saved_s - (turn_sync["refreshes"] - done) * per_refresh
    overlap = {"sync_refresh_s": refresh_s, "train_s_saved": saved_s,
               "saved_share_of_refresh": saved_s / refresh_s,
               "async_refreshes": done, "sync_refreshes": turn_sync["refreshes"],
               "train_s_saved_per_refresh_done": saved_done_s / done,
               "saved_share_per_refresh_done": saved_done_s / (done * per_refresh),
               "in_flight_over_no_refresh": ratio}
    require(overlap["saved_share_of_refresh"] >= MINE_SAVED_SHARE
            and overlap["saved_share_per_refresh_done"] >= MINE_SAVED_SHARE,
            f"mine: the async turn saved too little of the sync turn's refresh time: {overlap}")
    require(ratio is not None and ratio <= MINE_STEP_RATIO,
            f"mine: steps with a refresh in flight took {ratio} x the others")
    return {
        "model": "dpr-bert-base (2 x bert-base-uncased, 12 layers, d 768, seeded init, remat full)",
        "cell": "contaccum_mined", "overrides": {"precision": "bf16_banks", "loss_impl": "fused"},
        "steps": MINE_STEPS, "refresh_every": MINE_EVERY, "corpus": MINE_CORPUS,
        "corpus_s": corpus_s, "columns_per_chunk": turn_sync["n_negatives"] + 1,
        "banks": "the train phase's last banks (full)",
        "miner": {"top_k": MINE_TOPK, "band": list(MINE_BAND), "query_batch": 256,
                  "encode_batch": 256, "search_impl": "fused", "precision": "bf16_banks"},
        "async": public(turn_async), "sync": public(turn_sync),
        "first_tables_identical": True,
        "n_negatives": turn_sync["n_negatives"], "overlap": overlap,
        "search": search,
        "fused_topk_launches": turn_async["fused_topk_launches"] + turn_sync["fused_topk_launches"],
        "infonce_launches": {kernel: turn_async["launches"][kernel] + turn_sync["launches"][kernel]
                             for kernel in ("fwd", "dq", "dp")},
    }


def ptxas_report(log: str):
    """Each kernel entry of an ``nvcc -Xptxas -v`` log: its registers,
    static shared memory, stack frame and spill bytes."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)), static_smem_bytes=int(sm.group(1)) if sm else 0)
    return entries


def flash_instantiations(torch, log: str):
    """Every flash_attention kernel, named by its path and tile plan (BQ x
    BK x D): the dynamic shared memory it asks for, its registers and local
    memory (stack frame and spills) as the card reports them
    (``ops.kernel_attributes``), and ptxas's report of it from the build log
    (kept beside the library, so a library built earlier has it too). Fails
    unless the log reports every kernel with the card's register count."""
    from repro_torch.kernels.flash_attention import ops

    ptxas = {}
    for e in ptxas_report(log):
        plan = re.search(r"PlanILi(\d+)ELi(\d+)ELi(\d+)E", e["entry"])
        if plan:
            ptxas["flash_fwd_kernel_wgmma<{}, {}, {}>".format(*plan.groups())] = e
        elif "flash_fwd_kernel_fp32" in e["entry"]:
            ptxas["flash_fwd_kernel_fp32"] = e
    smem = ops._library().flash_attention_smem_bytes   # (dtype code, BQ, BK, D)
    kernels = [(f"flash_fwd_kernel_wgmma<{bq}, {bk}, {d}>", smem(1, bq, bk, d),
                ops.kernel_attributes(bq, bk, d, torch.bfloat16))
               for bq in (128, 64) for bk in (128, 64) for d in ops.HEAD_DIMS]
    kernels.append(("flash_fwd_kernel_fp32", f"{smem(0, 64, 64, 16)}-{smem(0, 64, 64, 128)} (D)",
                    ops.kernel_attributes(64, 64, 128, torch.float32)))
    out = []
    for name, dynamic_smem, attrs in kernels:
        e = ptxas.get(name)
        require(e is not None and e.get("registers") == attrs["registers"],
                f"the build log has no ptxas report of {name} with the card's {attrs}: {e}")
        out.append({"name": name, "dynamic_smem_bytes": dynamic_smem, **attrs,
                    **{k: v for k, v in e.items() if k not in ("entry", "registers")}})
    return out


def topk_instantiations(log: str):
    """Every fused_topk kernel (``ops.KERNELS``): its registers and local
    memory as the card reports them (``ops.kernel_attributes``) beside
    ptxas's report of it from the build log. Fails unless the log reports
    every kernel with the card's register count, and on a bf16 kernel with
    local memory or spills."""
    from repro_torch.kernels.fused_topk import ops

    ptxas = {}
    for e in ptxas_report(log):
        m = re.search(r"(topk_[a-z]+_kernel)(?:ILi(\d+)EE)?", e["entry"])
        if m:
            ptxas[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = e
    out = []
    for name in ops.KERNELS:
        attrs, e = ops.kernel_attributes(name), ptxas.get(name)
        require(e is not None and e.get("registers") == attrs["registers"],
                f"the build log has no ptxas report of {name} with the card's {attrs}: {e}")
        row = {"name": name, "bf16": name in ops.BF16_KERNELS, **attrs,
               **{k: v for k, v in e.items() if k not in ("entry", "registers")}}
        require(not row["bf16"] or row["spill_store_bytes"] == row["spill_load_bytes"]
                == row["local_bytes"] == 0, f"a bf16 fused_topk kernel spills: {row}")
        out.append(row)
    return out


def infonce_instantiations(log: str):
    """Every fused_infonce kernel (``ops.KERNELS``): its registers and local
    memory as the card reports them (``ops.kernel_attributes``) beside
    ptxas's report of it from the build log. Fails unless the log reports
    every kernel with the card's register count, on a bf16 kernel that
    spills, and on a Hopper kernel (``ops.HOPPER_KERNELS``, the train path's
    forward, dQ and dP; ``ops.TF32X3_KERNELS``, the xdev path's fp32 dQ and
    dP) that spills or has any local memory."""
    from repro_torch.kernels.fused_infonce import ops

    types = {"13__nv_bfloat16": "<bf16>", "f": "<fp32>", "Lb1": "<dq>", "Lb0": "<dp>"}
    ptxas = {}
    for e in ptxas_report(log):
        m = re.search(r"\d(infonce_[a-z0-9_]+?_kernel)(?:I(13__nv_bfloat16|f|Lb[01])E)?", e["entry"])
        if m:
            ptxas[m.group(1) + types.get(m.group(2), "")] = e
    out = []
    for name in ops.KERNELS:
        attrs, e = ops.kernel_attributes(name), ptxas.get(name)
        require(e is not None and e.get("registers") == attrs["registers"],
                f"the build log has no ptxas report of {name} with the card's {attrs}: {e}")
        row = {"name": name, "bf16": "fp32" not in name and name != "infonce_stats_merge_kernel"
               and name not in ops.TF32X3_KERNELS,
               "hopper": name in ops.HOPPER_KERNELS or name in ops.TF32X3_KERNELS, **attrs,
               **{k: v for k, v in e.items() if k not in ("entry", "registers")}}
        require(not (row["bf16"] or row["hopper"])
                or row["spill_store_bytes"] == row["spill_load_bytes"] == 0,
                f"a bf16 or Hopper fused_infonce kernel spills: {row}")
        require(not row["hopper"] or row["local_bytes"] == row["stack_bytes"] == 0,
                f"a Hopper fused_infonce kernel uses local memory: {row}")
        out.append(row)
    return out


def flash_flops(b, sq, skv, h, d, causal):
    """Operations of one flash_attention call: the two products,
    4*B*H*Sq*Skv*D, half of them under a causal mask."""
    return 4.0 * b * h * sq * skv * d * (0.5 if causal else 1.0)


def flash_bound_ms(b, sq, skv, h, hk, d, causal, masked, itemsize):
    """(bound_ms, bound_by) of one flash_attention call: q, k, v and the key
    mask read once and o written once, over HBM bandwidth; the two products
    (4*B*H*Sq*Skv*D, half of it under a causal mask) over the bf16 tensor
    peak, or the fp32 peak outside the tensor cores for fp32 inputs."""
    moved = (2 * b * sq * h + 2 * b * skv * hk) * d * itemsize + (b * skv if masked else 0)
    ops = flash_flops(b, sq, skv, h, d, causal)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash_kernels(torch):
    """flash_attention against its plain version at the BERT passes (strided
    q, k, v from one fused projection, ragged key masks), a fully masked
    row, fp32, and the LM prefill shapes; each also timed against
    scaled_dot_product_attention on the same inputs (the yardstick)."""
    import torch.nn.functional as F

    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels._timing import cuda_ms, device_ms

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    h, dh = BERT_BASE.n_heads, BERT_BASE.dh
    b = CONTACCUM_BF16["global_batch"] // CONTACCUM_BF16["accum_steps"]          # 8
    bf16 = torch.bfloat16

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def ragged(bb, s):
        lengths = torch.randint(1, s + 1, (bb,), generator=g, device=dev)
        return torch.arange(s, device=dev)[None, :] < lengths[:, None]

    def fused_qkv(bb, s, dtype):
        """q, k, v as bert.py makes them: reshaped splits of one projection."""
        qkv = rand((bb, s, 3 * h * dh), dtype)
        return [t.reshape(bb, s, h, dh) for t in qkv.split(h * dh, dim=-1)]

    def check(name, q, k, v, causal=False, kv_mask=None):
        out = ops.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
        err = ref.flash_attention_error(out, q, k, v, causal=causal, kv_mask=kv_mask)
        require(ref.error_ok(err, q.dtype), f"{name}: kernel departs from the plain version: {err}")
        want = ref.flash_attention_ref(q, k, v, causal=causal, kv_mask=kv_mask)
        bb, sq, hq, d = q.shape
        skv, hk = k.shape[1], k.shape[2]
        res = {"B": bb, "Sq": sq, "Skv": skv, "H": hq, "Hk": hk, "D": d, "causal": causal,
               "masked_keys": 0 if kv_mask is None else int((~kv_mask).sum().item()),
               "strided_qkv": not q.is_contiguous(), "dtype": str(q.dtype).replace("torch.", ""),
               "max_abs_err": err["max_abs_err"], "worst_share_of_allowance": err["worst"],
               "mean_err_vs_exact": err["mean_err"], "plain_mean_err_vs_exact": err["plain_mean_err"]}
        mask4 = None if kv_mask is None else kv_mask[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask4,
                is_causal=causal, scale=d ** -0.5, enable_gqa=hk != hq)

        # the yardstick computes the same function, except for a batch row
        # with every key masked (it does not average the values there), so
        # its error is taken over the other rows
        seen = slice(None) if kv_mask is None else kv_mask.any(1)
        lib_err = (library().transpose(1, 2).float()[seen] - want.float()[seen]).abs().max().item()
        bound_ms, bound_by = flash_bound_ms(bb, sq, skv, hq, hk, d, causal, kv_mask is not None,
                                            q.element_size())
        ms = device_ms(lambda: ops.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask), 20)
        res.update({
            "tiles": "x".join(map(str, ops._plan(bb, sq, skv, hq, d, q.dtype, q.device.index,
                                                 causal))),
            "ms": ms, "tflops": flash_flops(bb, sq, skv, hq, d, causal) / ms / 1e9,
            "plain_ms": device_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=causal, kv_mask=kv_mask), 3),
            "library_ms": device_ms(library, 20), "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ms_with_enqueue": cuda_ms(
                lambda: ops.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask), 20),
        })
        return res

    result = {}
    for name, s in (("bert_query", CONTACCUM_BF16["q_len"]), ("bert_passage", CONTACCUM_BF16["p_len"])):
        q, k, v = fused_qkv(b, s, bf16)
        result[name] = check(name, q, k, v, kv_mask=ragged(b, s))
    q, k, v = (rand((4, 256, h, dh), bf16) for _ in range(3))
    mask = ragged(4, 256)
    mask[1] = False
    result["all_masked_row"] = check("all_masked_row", q, k, v, kv_mask=mask)
    out, v1 = ops.flash_attention(q, k, v, kv_mask=mask)[1].float(), v[1].float()
    require(bool(((out - v1.mean(0)).abs() <= ref.bf16_allowance(v1.abs().mean(0), v1.mean(0))).all()),
            "a row with every key masked does not average the values")   # every p is 1 / Skv
    q, k, v = fused_qkv(b, 256, torch.float32)
    result["fp32"] = check("fp32", q, k, v, kv_mask=ragged(b, 256))
    for name, (bb, s, hq, hk, d) in {**FLASH_LM_SHAPES, **FLASH_LM_PATH_SHAPES}.items():
        q = rand((bb, s, hq, d), bf16)
        k, v = rand((bb, s, hk, d), bf16), rand((bb, s, hk, d), bf16)
        result[name] = check(name, q, k, v, causal=True)
    return result


def serve_pair(plain, flash):
    """This run's serving with plain and with flash towers, side by side."""
    keys = ("qps", "p50_ms", "p99_ms", "encode_ms_one_batch")
    return {name: {key: r[key] for key in keys} for name, r in (("plain", plain), ("flash", flash))}


def serve_turns(torch, topk_ops, topk_ref, pairs: int):
    """The serve phase with plain and with flash towers in turns (plain,
    flash, flash, plain, ...: ``pairs`` runs of each), one JSON line a run,
    with the launch checks of the two phases."""
    import dataclasses

    from repro_torch.configs.dpr_bert_base import BERT_BASE
    from repro_torch.kernels.flash_attention import ops as flash_ops

    n_layers = BERT_BASE.n_layers
    for turn in range(2 * pairs):
        flash = turn % 4 in (1, 2)
        cfg = dataclasses.replace(BERT_BASE, attention_impl=FLASH_IMPL) if flash else BERT_BASE
        n = n_layers if flash else 0
        r = phase_serve(torch, topk_ref, cfg, [
            ("fused_topk", topk_ops.fused_topk, 0, 1),
            ("flash_attention", flash_ops.flash_attention, n, n)])
        emit({"phase": "serve_turn", "turn": turn, "towers": "flash" if flash else "plain",
              **{key: r[key] for key in ("qps", "p50_ms", "p99_ms", "encode_ms_one_batch",
                                         "index_build_s", "batches")}})


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def phase_flash(torch, topk_ops, topk_ref):
    """The towers with attention_impl="pallas": reps held against the
    plain-attention towers, the serve phase on them, and contaccum_bf16
    training."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16, SERVE_TOPK
    from repro_torch.core.methods import build_step_program
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    flash_cfg = dataclasses.replace(BERT_BASE, attention_impl=FLASH_IMPL)
    n_layers = BERT_BASE.n_layers
    precision = SERVE_TOPK["precision"]
    out = {"attention_impl": FLASH_IMPL}

    # ---- reps against the plain-attention towers on the same params; the
    # tolerance is bf16's own distance from fp32 (the plain towers in fp32):
    # the flash path may move the reps no further on average than bf16
    # compute does, and no element further than that plus one bf16 ulp of
    # the largest rep (the flash and plain reps are both rounded to bf16, the
    # fp32 reps are not, so two bf16 reps differ by whole ulps)
    params = make_bert_dual_encoder(BERT_BASE, precision=precision).init(
        torch.Generator().manual_seed(SEED), DEVICE)
    corpus = SyntheticRetrievalCorpus(
        n_passages=FLASH_PARITY_PASSAGES, vocab_size=BERT_BASE.vocab_size,
        q_len=SERVE_TOPK["q_len"], p_len=P_LEN, seed=SEED,
    )
    with torch.inference_mode():
        toks = torch.as_tensor(corpus.passages, device=DEVICE).long()
        reps = {name: make_bert_dual_encoder(cfg, precision=prec).encode_passage(params, toks).float()
                for name, cfg, prec in (("flash", flash_cfg, precision), ("plain", BERT_BASE, precision),
                                        ("plain_fp32", BERT_BASE, "fp32"))}
    diff, floor = (reps["flash"] - reps["plain"]).abs(), (reps["plain"] - reps["plain_fp32"]).abs()
    cos = torch.nn.functional.cosine_similarity(reps["flash"], reps["plain"], dim=-1)
    ulp = 2.0 ** (math.floor(math.log2(reps["plain"].abs().max().item())) - 7)
    out["reps_vs_plain"] = {
        "passages": FLASH_PARITY_PASSAGES, "max_abs_err": diff.max().item(),
        "mean_abs_err": diff.mean().item(), "min_cosine": cos.min().item(),
        "bf16_vs_fp32_max_abs_err": floor.max().item(),
        "bf16_vs_fp32_mean_abs_err": floor.mean().item(), "bf16_ulp_of_max": ulp,
    }
    require(diff.mean().item() <= floor.mean().item()
            and diff.max().item() <= floor.max().item() + ulp,
            f"flash reps depart from the plain towers' further than bf16 does from fp32: "
            f"{out['reps_vs_plain']}")
    del params, reps, toks

    # ---- serving: the serve phase on the flash towers (every layer of each
    # encode batch and each coalesced batch launches the kernel once)
    out["serve"] = phase_serve(torch, topk_ref, flash_cfg, [
        ("fused_topk", topk_ops.fused_topk, 0, 1),
        ("flash_attention", flash_ops.flash_attention, n_layers, n_layers),
    ])

    # ---- training: contaccum_bf16 with the flash towers
    cell = CONTACCUM_BF16
    kk, batch = cell["accum_steps"], cell["global_batch"]
    run = contaccum_setup(torch, flash_cfg, FLASH_TRAIN_STEPS)
    update, state, next_batch = run.update, run.state, run.next_batch
    trainer = Trainer(TrainerConfig(total_steps=FLASH_TRAIN_STEPS, log_every=1), update,
                      next_batch, loader_state=run.loader.state)
    torch.cuda.reset_peak_memory_stats()
    flash_ops.flash_attention.launches = 0             # the train path's run starts here
    t0 = time.perf_counter()
    state, report = trainer.run(state)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = flash_ops.flash_attention.launches      # read just after the run
    peak_bytes = torch.cuda.max_memory_allocated()
    hist = report.history
    require(report.steps_run == FLASH_TRAIN_STEPS, f"flash train ran {report.steps_run} steps")
    require(all(np.isfinite(row["loss"]) for row in hist), "non-finite flash training loss")
    # each chunk runs the query, positive and hard-negative tower passes;
    # each layer's forward runs again in the backward under remat
    passes = 2 + (1 if cell["n_hard"] else 0)
    per_step = kk * passes * n_layers * (2 if BERT_BASE.remat != "none" else 1)
    require(launches == per_step * FLASH_TRAIN_STEPS,
            f"flash_attention launched {launches} times, not {per_step} x {FLASH_TRAIN_STEPS}")

    # one step with flash towers and one with plain towers, same state and batch
    parity_batch = next_batch(FLASH_TRAIN_STEPS)
    plain_update = build_step_program(
        make_bert_dual_encoder(BERT_BASE, precision=cell["precision"]), run.tx, run.cfg).update
    _, m_flash = update(state, parity_batch)
    _, m_plain = plain_update(state, parity_batch)
    parity = {key: (float(getattr(m_flash, key)), float(getattr(m_plain, key)))
              for key in ("loss", "grad_norm", "accuracy")}
    # the dense-vs-fused tolerances, for the same cause: bf16 rounding at
    # other places (here the attention's probabilities, per tile or
    # normalised) under fp32 sums of the same products
    for key, rtol in (("loss", PARITY_LOSS_RTOL), ("grad_norm", PARITY_GRAD_RTOL)):
        fl, pl = parity[key]
        require(rel_err(fl, pl) <= rtol, f"flash vs plain towers {key}: {fl} vs {pl}")
    share = profile_step_share(torch, lambda: update(state, parity_batch))
    # the profile finds the kernel by its symbol: a renamed kernel reads 0
    require(bool(share.get("flash_launches")) and bool(share.get("flash_ms")),
            f"the profiled flash step shows no flash_fwd_kernel time: {share}")
    times = [row["step_time_s"] for row in hist[1:]]
    out["train"] = {
        "cell": "contaccum_bf16", "steps": FLASH_TRAIN_STEPS, "train_s": train_s,
        "first_step_s": hist[0]["step_time_s"], "median_step_s": statistics.median(times),
        "step_times_s": [row["step_time_s"] for row in hist],
        "pairs_per_s": batch / statistics.median(times),
        "max_memory_allocated": peak_bytes,
        "losses": [row["loss"] for row in hist], "flash_attention_launches": launches,
        "launches_per_step": per_step, "flash_vs_plain": parity,
        "flash_vs_plain_rel_err": {key: rel_err(*parity[key]) for key in ("loss", "grad_norm")},
        "profile": share,
    }
    return out


def phase_lm(torch, topk_ops):
    """ContAccum training of full-width internlm2-1.8b dual encoders (LM_LAYERS
    of 24 layers) through the flash kernel in the contaccum_bf16 cell, held
    against chunked attention and the dense loss, then a Top@k eval."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.common.treemath import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.configs.dpr_bert_base import CONTACCUM_BF16
    from repro_torch.core.methods import build_step_program
    from repro_torch.evaluation import evaluate_topk
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_infonce import ops as infonce_ops
    from repro_torch.models.towers import make_lm_dual_encoder
    from repro_torch.retrieval import RetrieverConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cell = CONTACCUM_BF16
    kk, batch = cell["accum_steps"], cell["global_batch"]
    lm_cfg = dataclasses.replace(get_arch(LM_ARCH).model_cfg, n_layers=LM_LAYERS,
                                 attention_impl=FLASH_IMPL, remat="full")
    require(lm_cfg.d_model == LM_D, f"{LM_ARCH} reps are {lm_cfg.d_model} wide, not {LM_D}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    enc = make_lm_dual_encoder(lm_cfg, precision=cell["precision"])
    run = contaccum_setup(torch, enc, LM_STEPS,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    update, state, next_batch = run.update, run.state, run.next_batch
    run.state = None                      # the trained state replaces it below
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tower_params = sum(t.numel() for t in tree_leaves(state.params["query"]))
    trainer = Trainer(TrainerConfig(total_steps=LM_STEPS, log_every=1), update, next_batch,
                      loader_state=run.loader.state)
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launches()            # the lm path's run starts here
    infonce_ops.reset_launches()
    t0 = time.perf_counter()
    state, report = trainer.run(state)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    flash_launches = flash_ops.flash_attention.launches   # read just after the run
    flash_paths = dict(flash_ops.flash_attention.paths)
    launches = {kernel: getattr(infonce_ops, f"fused_infonce_{kernel}").launches
                for kernel in ("fwd", "dq", "dp")}
    paths = {kernel: dict(getattr(infonce_ops, f"fused_infonce_{kernel}").paths)
             for kernel in ("fwd", "dq", "dp")}
    peak_bytes = torch.cuda.max_memory_allocated()
    hist = report.history
    require(report.steps_run == LM_STEPS, f"lm train ran {report.steps_run} steps")
    require(all(np.isfinite(row["loss"]) for row in hist), "non-finite lm training loss")
    # each chunk runs the query, positive and hard-negative tower passes;
    # each layer's forward runs again in the backward under remat
    passes = 2 + (1 if cell["n_hard"] else 0)
    per_step = kk * passes * LM_LAYERS * 2
    require(flash_launches == per_step * LM_STEPS,
            f"flash_attention launched {flash_launches} times, not {per_step} x {LM_STEPS}")
    require(flash_paths["hopper"] == flash_launches,
            f"flash_attention took {flash_paths}, not all the bf16 Hopper kernel")
    want = {"fwd": 2 * kk * LM_STEPS, "dq": kk * LM_STEPS, "dp": 2 * kk * LM_STEPS}
    require(launches == want, f"fused_infonce launches {launches} != {want}")
    # every forward, dQ and dP at d = 2048 on its Hopper kernels
    for kernel in ("fwd", "dq", "dp"):
        require(paths[kernel]["hopper"] == launches[kernel],
                f"fused_infonce {kernel} took {paths[kernel]}, not all the Hopper kernels")
    last = hist[-1]
    towers_apart = max((q - p).abs().max().item() for q, p in zip(
        tree_leaves(state.params["query"]), tree_leaves(state.params["passage"])))
    require(towers_apart > 0, "the shared towers did not part after training")

    # one step from the trained state and a fresh batch: flash against
    # chunked attention, and the fused loss against the dense one
    parity_batch = next_batch(LM_STEPS)
    steps = {"flash_fused": update,
             "chunked": build_step_program(make_lm_dual_encoder(
                 dataclasses.replace(lm_cfg, attention_impl="chunked"),
                 precision=cell["precision"]), run.tx, run.cfg).update,
             "dense": build_step_program(enc, run.tx, dataclasses.replace(
                 run.cfg, loss_impl="dense")).update}
    parity = {}
    for name, fn in steps.items():
        _, m = fn(state, parity_batch)
        parity[name] = {key: float(getattr(m, key)) for key in ("loss", "grad_norm", "accuracy")}
    rel = {}
    for other in ("chunked", "dense"):
        for key, rtol in (("loss", PARITY_LOSS_RTOL), ("grad_norm", PARITY_GRAD_RTOL)):
            a, b = parity["flash_fused"][key], parity[other][key]
            rel[f"{other}_{key}"] = rel_err(a, b)
            require(rel_err(a, b) <= rtol, f"lm step: flash, fused vs {other} {key}: {a} vs {b}")
    share = profile_step_share(torch, lambda: update(state, parity_batch))
    require(bool(share.get("flash_launches")) and bool(share.get("flash_ms")),
            f"the profiled lm step shows no flash_fwd_kernel time: {share}")
    # the loss kernels of the profiled step by name: none of the wmma kernels
    wmma = ("infonce_fwd_kernel", "infonce_dq_kernel", "infonce_dp_kernel")
    require(bool(share["infonce_kernels"]) and not any(
        w in k["name"] for k in share["infonce_kernels"] for w in wmma),
        f"the profiled lm step ran a wmma loss kernel: {share['infonce_kernels']}")

    # Top@k eval: the corpus and the eval queries through the flash towers,
    # the search through fused_topk (every call on the Hopper scan)
    topk_ops.reset_launches()
    flash_ops.reset_launches()
    t0 = time.perf_counter()
    recalls = evaluate_topk(
        enc, state.params, run.corpus, ks=LM_EVAL_KS,
        cfg=RetrieverConfig(top_k=max(LM_EVAL_KS), search_impl="fused",
                            precision=cell["precision"]),
        device=DEVICE,
    )
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches, eval_paths = topk_ops.fused_topk.launches, dict(topk_ops.fused_topk.paths)
    eval_flash = dict(flash_ops.flash_attention.paths)
    require(eval_launches > 0 and eval_paths["hopper"] == eval_launches,
            f"the lm eval's searches took {eval_paths}, not all the Hopper kernel")
    require(eval_flash["hopper"] == flash_ops.flash_attention.launches > 0,
            f"the lm eval's encodes took {eval_flash}")
    require(all(np.isfinite(v) for v in recalls.values()), f"non-finite recall {recalls}")
    del state, run, steps, update, trainer
    gc.collect()
    torch.cuda.empty_cache()

    times = [row["step_time_s"] for row in hist[1:]]
    step_s = statistics.median(times)
    tokens_per_step = batch * (cell["q_len"] + cell["p_len"] * (1 + cell["n_hard"]))
    return {
        "model": f"{LM_ARCH} dual encoder (shared=True at init; d_model {lm_cfg.d_model}, "
                 f"{lm_cfg.n_heads} heads, {lm_cfg.n_kv_heads} KV heads of {lm_cfg.dh}, d_ff "
                 f"{lm_cfg.d_ff}, vocab {lm_cfg.vocab_size}; {LM_LAYERS} of 24 layers; seeded "
                 f"init; remat full; attention {FLASH_IMPL})",
        "cell": "contaccum_bf16", "steps": LM_STEPS, "accumulation_steps": kk,
        "global_batch": batch, "bank_size": cell["bank_size"], "q_len": cell["q_len"],
        "p_len": cell["p_len"], "n_hard": cell["n_hard"], "precision": cell["precision"],
        "loss_impl": cell["loss_impl"], "params_per_tower": tower_params, "setup_s": setup_s,
        "train_s": train_s, "first_step_s": hist[0]["step_time_s"], "median_step_s": step_s,
        "step_times_s": [row["step_time_s"] for row in hist], "pairs_per_s": batch / step_s,
        "tokens_per_s": tokens_per_step / step_s, "max_memory_allocated": peak_bytes,
        "losses": [row["loss"] for row in hist],
        "grad_norm_ratios": [row["grad_norm_ratio"] for row in hist],
        "n_negatives": last["n_negatives"], "towers_max_abs_diff": towers_apart,
        "flash_attention_launches": flash_launches, "flash_attention_paths": flash_paths,
        "flash_launches_per_step": per_step, "infonce_launches": launches,
        "infonce_paths": paths, "parity": parity, "parity_rel_err": rel, "profile": share,
        "eval": recalls, "eval_s": eval_s, "eval_fused_topk_launches": eval_launches,
        "eval_fused_topk_paths": eval_paths,
        "eval_flash_launches": flash_ops.flash_attention.launches,
    }


def phase_lm_train(torch):
    """The causal-LM train cell of launch/steps.py (internlm2-1.8b train_4k)
    at full width, LM_LAYERS of 24 layers, through the flash kernel: the
    loss and its gradient held against chunked attention on one microbatch,
    then LM_TRAIN_STEPS steps, then one microbatch profiled."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.common.treemath import tree_leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_infonce import ops as infonce_ops
    from repro_torch.kernels.fused_topk import ops as topk_ops
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(LM_ARCH).model_cfg, n_layers=LM_LAYERS,
                              attention_impl=FLASH_IMPL, remat="full")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prog = steps.build_cell(LM_ARCH, "train_4k", DEVICE, model_cfg=cfg,
                            micro_batches=LM_TRAIN_MICRO_BATCHES)
    info, cell = prog.static_info, get_arch(LM_ARCH).shapes["train_4k"].params
    m, shape = info["microbatches"], tuple(prog.args[1].shape)
    require(m == LM_TRAIN_MICRO_BATCHES and shape == (m, cell["global_batch"] // m,
                                                      cell["seq_len"]),
            f"train_4k inputs are {shape}")
    state = prog.init(torch.Generator(device=DEVICE).manual_seed(SEED))

    def next_tokens(rng, size):
        tokens = rng.integers(0, cfg.vocab_size, size=size, dtype=np.int32)
        targets = np.roll(tokens, -1, axis=-1)
        targets[..., -1] = -1
        return torch.from_numpy(tokens).to(DEVICE), torch.from_numpy(targets).to(DEVICE)

    rng = np.random.default_rng(SEED)
    batches = [next_tokens(rng, shape) for _ in range(LM_TRAIN_STEPS)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # one microbatch's lm_loss forward and backward, as the train step runs it
    def loss_and_grads(c, params, tokens, targets):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = lm.lm_loss(leaves, c, tokens, targets)
        loss.backward()
        return loss.item(), [t.grad for t in tree_leaves(leaves)]

    def flash_vs_chunked(params, tokens, targets):
        """The loss through flash and through chunked attention, and each
        gradient leaf's largest difference over its largest |g|."""
        fl, fg = loss_and_grads(cfg, params, tokens, targets)
        cl, cg = loss_and_grads(dataclasses.replace(cfg, attention_impl="chunked"), params,
                                tokens, targets)
        return fl, cl, [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(fg, cg)]

    # the first microbatch: flash against chunked attention on the same
    # params and tokens (launches not counted)
    flash_loss, chunked_loss, grad_errs = flash_vs_chunked(state.params, batches[0][0][0],
                                                           batches[0][1][0])
    require(math.isfinite(flash_loss)
            and rel_err(flash_loss, chunked_loss) <= LM_TRAIN_LOSS_RTOL,
            f"lm_loss through flash {flash_loss} vs chunked {chunked_loss}")
    require(max(grad_errs) <= PARITY_GRAD_RTOL,
            f"lm_loss gradient through flash vs chunked: {grad_errs} of the largest |g|")
    # the same comparison with params and tokens of the next seed: the
    # check's headroom, recorded and not held to the limit
    seed2 = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 1), device=DEVICE)
    seed2_loss, seed2_chunked, seed2_errs = flash_vs_chunked(
        seed2, *next_tokens(np.random.default_rng(SEED + 1), shape[1:]))
    del seed2
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: LM_TRAIN_STEPS steps of the cell
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launches()
    infonce_ops.reset_launches()
    topk_ops.reset_launches()
    losses, times, launches_per_step = [], [], []
    for i, (tokens, targets) in enumerate(batches):
        before = flash_ops.flash_attention.launches
        t1 = time.perf_counter()
        state, metrics = prog.fn(state, tokens, targets)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t1)
        launches_per_step.append(flash_ops.flash_attention.launches - before)
        print(f"[lm_train] step {i}: {times[-1]:.3f} s, loss {losses[-1]:.5f}", file=sys.stderr,
              flush=True)
    torch.cuda.synchronize()
    flash_launches = flash_ops.flash_attention.launches      # read just after the run
    flash_paths = dict(flash_ops.flash_attention.paths)
    other = {"fused_infonce": sum(getattr(infonce_ops, f"fused_infonce_{k}").launches
                                  for k in ("fwd", "dq", "dp")),
             "fused_topk": topk_ops.fused_topk.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    final_step = int(state.step)

    # where the time goes: one microbatch of a step (m of them, then clip
    # and AdamW) under the profiler; a whole step is ~1.3M launches
    t1 = time.perf_counter()
    profile = profile_step_share(torch, lambda: loss_and_grads(
        cfg, state.params, batches[0][0][0], batches[0][1][0]))
    profile_s = time.perf_counter() - t1
    del state, batches, prog
    gc.collect()
    torch.cuda.empty_cache()

    want_loss = math.log(cfg.vocab_size) + 0.5
    require(all(math.isfinite(x) for x in losses), f"non-finite lm_train loss {losses}")
    require(abs(losses[0] - want_loss) <= LM_TRAIN_LOSS_SLACK,
            f"step-0 loss {losses[0]} is not within {LM_TRAIN_LOSS_SLACK} of {want_loss}")
    require(final_step == LM_TRAIN_STEPS, f"state.step is {final_step}")
    per_step = LM_LAYERS * 2 * m         # forward and remat recompute, each microbatch
    require(launches_per_step == [per_step] * LM_TRAIN_STEPS,
            f"flash_attention launched {launches_per_step} a step, not {per_step}")
    require(flash_paths["hopper"] == flash_launches,
            f"flash_attention took {flash_paths}, not all the bf16 Hopper kernel")
    require(other == {"fused_infonce": 0, "fused_topk": 0}, f"lm_train launched {other}")
    # the profile finds the kernel by its symbol: a renamed kernel reads 0
    require(bool(profile.get("flash_launches")) and bool(profile.get("flash_ms")),
            f"the profiled lm_train microbatch shows no flash_fwd_kernel time: {profile}")
    step_s = statistics.median(times)
    tokens_per_step = info["tokens_per_step"]
    return {
        "model": f"{LM_ARCH} causal LM (d_model {cfg.d_model}, {cfg.n_heads} heads, "
                 f"{cfg.n_kv_heads} KV heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab "
                 f"{cfg.vocab_size}; {LM_LAYERS} of 24 layers; seeded init; remat full; "
                 f"attention {FLASH_IMPL})",
        "cell": "train_4k", "steps": LM_TRAIN_STEPS, "microbatches": m,
        "microbatch_shape": list(shape[1:]), "tokens_per_step": tokens_per_step,
        "params": info["params"], "model_flops": info["model_flops"], "setup_s": setup_s,
        "parity": {"flash_loss": flash_loss, "chunked_loss": chunked_loss,
                   "loss_rel_err": rel_err(flash_loss, chunked_loss),
                   "grad_err_of_max": max(grad_errs), "grad_errs_by_leaf": grad_errs,
                   "seed2": {"flash_loss": seed2_loss, "chunked_loss": seed2_chunked,
                             "loss_rel_err": rel_err(seed2_loss, seed2_chunked),
                             "grad_err_of_max": max(seed2_errs),
                             "grad_errs_by_leaf": seed2_errs}},
        "losses": losses, "step0_loss_expected": want_loss, "step_times_s": times,
        "median_step_s": step_s,
        "tokens_per_s": tokens_per_step / step_s,
        "model_flops_share": info["model_flops"] / step_s / PEAK_BF16_FLOPS,
        "max_memory_allocated": peak_bytes, "flash_attention_launches": flash_launches,
        "flash_launches_per_step": per_step, "flash_attention_paths": flash_paths,
        "other_launches": other,
        # the profile is of one microbatch; a step runs m of them, and its
        # flash launches are counted (the profiler can miss an event)
        "profile": {"scope": "one microbatch: lm_loss forward and backward", **profile},
        "profile_s": profile_s,
        "flash_ms_per_step": profile["flash_ms"] / profile["flash_launches"] * per_step,
        "microbatch_kernels_share_of_step": m * profile["device_ms"] / (step_s * 1e3),
    }


def flash_launches():
    """The flash kernel's launch count so far."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    return flash_ops.flash_attention.launches


def timed(torch, fn):
    """fn's result and its wall seconds, the card synchronised around it."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t1


def flash_at_serve_shape(torch, shape):
    """The flash kernel at a prefill's attention, shape (B, S, H, Hk, D),
    causal, on seeded bf16 inputs and not counted: its first and last
    FLASH_SERVE_ROWS query rows held to the plain version, its time beside
    SDPA's and the bound."""
    import gc

    import torch.nn.functional as F

    from repro_torch.kernels._timing import device_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    fb, fs, fh, fhk, fd = shape
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    q = torch.randn((fb, fs, fh, fd), generator=g, device=DEVICE).to(torch.bfloat16)
    k = torch.randn((fb, fs, fhk, fd), generator=g, device=DEVICE).to(torch.bfloat16)
    v = torch.randn((fb, fs, fhk, fd), generator=g, device=DEVICE).to(torch.bfloat16)
    flash_out = flash_ops.flash_attention(q, k, v, causal=True)
    require(bool(torch.isfinite(flash_out.float()).all()), f"flash at {shape}: non-finite output")
    row_errs = {}
    for start in (0, fs - FLASH_SERVE_ROWS):
        rows, keys = slice(start, start + FLASH_SERVE_ROWS), slice(0, start + FLASH_SERVE_ROWS)
        err = flash_ref.flash_attention_error(flash_out[:, rows], q[:, rows], k[:, keys],
                                              v[:, keys], causal=True, q_offset=start)
        require(flash_ref.error_ok(err, torch.bfloat16),
                f"flash at {shape}, rows from {start}: kernel departs from the plain version: "
                f"{err}")
        row_errs[f"rows_{start}"] = err

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              scale=fd ** -0.5, enable_gqa=fhk != fh)

    lib_diff = (library().transpose(1, 2).float() - flash_out.float()).abs().max().item()
    del flash_out
    flash_ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True), 5)
    bound_ms, bound_by = flash_bound_ms(fb, fs, fs, fh, fhk, fd, True, False, 2)
    out = {
        "B": fb, "S": fs, "H": fh, "Hk": fhk, "D": fd, "causal": True,
        "tiles": "x".join(map(str, flash_ops._plan(fb, fs, fs, fh, fd, q.dtype,
                                                   q.device.index, True))),
        "rows_checked": [[0, FLASH_SERVE_ROWS], [fs - FLASH_SERVE_ROWS, fs]],
        "max_abs_err": max(e["max_abs_err"] for e in row_errs.values()),
        "row_errors": row_errs, "ms": flash_ms,
        "tflops": flash_flops(fb, fs, fs, fh, fd, True) / flash_ms / 1e9,
        "plain_ms": None,
        "plain_not_run": f"its ({fb}, {fh}, {fs}, {fs}) fp32 scores would be "
                         f"{fb * fh * fs * fs * 4 / 1e9:.0f} GB",
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": device_ms(library, 5),
        "library_max_abs_diff_from_kernel": lib_diff,
    }
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lm_serve(torch):
    """internlm2-1.8b's prefill_32k and decode_32k cells at full width and
    depth through the flash kernel: the prefill cell's fn timed, then a
    prompt prefilled and LM_SERVE_DECODE tokens decoded through the decode
    cell's fn, held against one forward over the same tokens; the flash
    kernel at the prefill's shape against its plain version on its first
    and last rows; a decode step and a prefill profiled."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.common.treemath import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.kernels._timing import device_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_infonce import ops as infonce_ops
    from repro_torch.kernels.fused_topk import ops as topk_ops
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.attention import decode_attention

    cfg = dataclasses.replace(get_arch(LM_ARCH).model_cfg, attention_impl=FLASH_IMPL)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre = steps.build_cell(LM_ARCH, "prefill_32k", DEVICE, model_cfg=cfg,
                           global_batch=LM_SERVE_BATCH)
    dec = steps.build_cell(LM_ARCH, "decode_32k", DEVICE, model_cfg=cfg,
                           global_batch=LM_SERVE_BATCH)
    b, s = tuple(pre.args[1].shape)
    kv_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.dh)
    require((b, s, cfg.n_heads, cfg.n_kv_heads, cfg.dh) == FLASH_SERVE_SHAPE
            and tuple(dec.args[1].k.shape) == kv_shape,
            f"prefill_32k tokens {(b, s)}, decode_32k cache {tuple(dec.args[1].k.shape)}, "
            f"flash at {FLASH_SERVE_SHAPE}")
    params = pre.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(b, s), dtype=np.int32)).to(DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ---- the main path, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launches()
    infonce_ops.reset_launches()
    topk_ops.reset_launches()
    # the prefill cell: a warm-up, then LM_SERVE_PREFILL_RUNS timed runs;
    # each run's cache is dropped before the next is allocated
    prefill_times, prefill_launches, out = [], [], None
    for i in range(1 + LM_SERVE_PREFILL_RUNS):
        out, before = None, flash_launches()
        out, dt = timed(torch, lambda: pre.fn(params, tokens))
        prefill_launches.append(flash_launches() - before)
        if i:
            prefill_times.append(dt)
        print(f"[lm_serve] prefill {i}: {dt:.3f} s", file=sys.stderr, flush=True)
    cache, cell_logits = out
    del out
    cell_ok = (bool(torch.isfinite(cell_logits.float()).all())
               and tuple(cell_logits.shape) == (b, cfg.vocab_size)
               and bool((cache.length == s).all()) and tuple(cache.k.shape) == kv_shape)
    del cache, cell_logits

    # the generation: prefill of the prompt into the cell's s slots, then
    # decode steps through the decode cell's fn, each timed
    p_len = LM_SERVE_PROMPT
    before = flash_launches()
    (cache, logits), gen_prefill_s = timed(
        torch, lambda: lm.prefill(params, cfg, tokens[:, :p_len], max_seq=s))
    gen_prefill_launches = flash_launches() - before
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr())
    gen = [logits.float()]
    decode_times, before = [], flash_launches()
    for t in range(p_len, p_len + LM_SERVE_DECODE):
        (cache, logits), dt = timed(torch, lambda: dec.fn(params, cache, tokens[:, t]))
        gen.append(logits.float())
        decode_times.append(dt)
    decode_launches = flash_launches() - before
    gen = torch.stack(gen, 1)                                   # (B, 1 + decode, V)
    lengths = cache.length.tolist()
    in_place = (cache.k.data_ptr(), cache.v.data_ptr()) == ptrs
    print(f"[lm_serve] decode: median {statistics.median(decode_times) * 1e3:.2f} ms a step",
          file=sys.stderr, flush=True)
    # where a decode step's time goes: the step profiled (it writes one
    # more row, past the generation's), the plain decode attention of one
    # layer, and the cast of the fp32 params to bf16 that every step does
    decode_profile = profile_step_share(
        torch, lambda: dec.fn(params, cache, tokens[:, 0]))
    q1 = torch.randn((b, 1, cfg.n_heads, cfg.dh), device=DEVICE).to(cfg.dtype)
    attn_layer_ms = device_ms(lambda: decode_attention(
        q1, cache.k[0], cache.v[0], cache_len=cache.length + 1), 5)
    cast = tree_leaves([params["layers"]["attn"], params["layers"]["ffn"],
                        params.get("lm_head")])
    cast_ms = device_ms(lambda: [t.to(cfg.dtype) for t in cast], 5)
    del cache, q1
    gc.collect()
    torch.cuda.empty_cache()

    # teacher forcing: one forward over all s tokens; the logits of the
    # generation's positions only (all (B, s, V) would be 97 GB in fp32)
    before = flash_launches()
    with torch.no_grad():
        (x, _, _), tf_s = timed(torch, lambda: lm.backbone(params, cfg, tokens))
        want = lm._head(params, cfg, x[:, p_len - 1:p_len + LM_SERVE_DECODE]).float()
    tf_launches = flash_launches() - before
    del x
    main_launches = flash_launches()                 # read just after the main path
    main_paths = dict(flash_ops.flash_attention.paths)
    other = {"fused_infonce": sum(getattr(infonce_ops, f"fused_infonce_{k}").launches
                                  for k in ("fwd", "dq", "dp")),
             "fused_topk": topk_ops.fused_topk.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    diff = (gen - want).abs()
    finite = bool(torch.isfinite(gen).all()) and bool(torch.isfinite(want).all())
    tf = {"positions": [p_len - 1, p_len + LM_SERVE_DECODE - 1],
          "mean_abs_diff": diff.mean().item(), "max_abs_diff": diff.max().item(),
          "prefill_mean_abs_diff": diff[:, 0].mean().item(),
          "decode_mean_abs_diff": diff[:, 1:].mean().item(),
          "decode_max_abs_diff": diff[:, 1:].max().item(),
          "top1_agreement": (gen.argmax(-1) == want.argmax(-1)).float().mean().item(),
          "logit_std": want.std().item()}
    del gen, want, diff
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the flash kernel at the prefill's attention (not counted)
    flash_serve = flash_at_serve_shape(torch, FLASH_SERVE_SHAPE)

    # ---- one prefill profiled (its cache dropped before the next run)
    prefill_profile = profile_step_share(torch, lambda: pre.fn(params, tokens))
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()

    per_pass = cfg.n_layers
    require(cell_ok, "the prefill cell's cache or logits are not what its shape says, or "
                     "not finite")
    require(finite, "non-finite generation or teacher-forced logits")
    require(tf["mean_abs_diff"] <= LM_SERVE_TF_MEAN and tf["max_abs_diff"] <= LM_SERVE_TF_MAX,
            f"generation against teacher forcing: {tf}")
    require(lengths == [p_len + LM_SERVE_DECODE] * b, f"cache.length ends at {lengths}")
    require(in_place, "decode moved the cache: its data_ptr changed")
    require(prefill_launches == [per_pass] * (1 + LM_SERVE_PREFILL_RUNS)
            and gen_prefill_launches == tf_launches == per_pass and decode_launches == 0,
            f"flash_attention launched {prefill_launches} a prefill cell run, "
            f"{gen_prefill_launches} in the generation's prefill, {decode_launches} in its "
            f"decode, {tf_launches} in the forward; want {per_pass}, {per_pass}, 0, {per_pass}")
    require(main_paths["hopper"] == main_launches,
            f"flash_attention took {main_paths}, not all the bf16 Hopper kernel")
    require(other == {"fused_infonce": 0, "fused_topk": 0}, f"lm_serve launched {other}")
    require(peak_bytes < LM_SERVE_PEAK_BYTES, f"lm_serve peak memory {peak_bytes / 1e9:.1f} GB")
    require(bool(prefill_profile.get("flash_launches")) and bool(prefill_profile.get("flash_ms")),
            f"the profiled prefill shows no flash_fwd_kernel time: {prefill_profile}")
    prefill_s = statistics.median(prefill_times)
    decode_s = statistics.median(decode_times)
    kv_bytes = dec.static_info["kv_cache_bytes"]
    bf16_param_bytes = param_bytes // 2
    return {
        "model": f"{LM_ARCH} causal LM (d_model {cfg.d_model}, {cfg.n_heads} heads, "
                 f"{cfg.n_kv_heads} KV heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab "
                 f"{cfg.vocab_size}; all {cfg.n_layers} layers; seeded init; attention "
                 f"{FLASH_IMPL})",
        "cells": {name: {"global_batch": [get_arch(LM_ARCH).shapes[name].params["global_batch"],
                                          b], "seq_len": s}
                  for name in ("prefill_32k", "decode_32k")},
        "params": pre.static_info["params"], "param_bytes": param_bytes, "setup_s": setup_s,
        "prefill": {"runs_s": prefill_times, "median_s": prefill_s,
                    "tokens_per_s": pre.static_info["tokens_per_step"] / prefill_s,
                    "model_flops": pre.static_info["model_flops"],
                    "model_flops_share": pre.static_info["model_flops"] / prefill_s
                    / PEAK_BF16_FLOPS,
                    "flash_launches_per_run": prefill_launches},
        "generation": {"prompt": p_len, "decode_steps": LM_SERVE_DECODE, "slots": s,
                       "prefill_s": gen_prefill_s, "lengths_at_end": lengths,
                       "cache_in_place": in_place},
        "decode": {"step_times_s": decode_times, "median_ms": decode_s * 1e3,
                   "tokens_per_s": b / decode_s,
                   "kv_cache_bytes": kv_bytes,
                   "bytes_per_step": param_bytes + kv_bytes,
                   "byte_share": (param_bytes + kv_bytes) / decode_s / PEAK_BYTES_PER_S,
                   "bound_ms_bf16_params": (bf16_param_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
                   "bound_ms_fp32_params": (param_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
                   "attention_ms_per_layer": attn_layer_ms,
                   "attention_ms_per_step": attn_layer_ms * cfg.n_layers,
                   "attention_bound_ms_per_layer": kv_bytes / cfg.n_layers / PEAK_BYTES_PER_S
                   * 1e3,
                   "param_cast_ms": cast_ms,
                   "flash_launches": decode_launches},
        "teacher_forcing": {**tf, "forward_s": tf_s},
        "max_memory_allocated": peak_bytes, "flash_attention_launches": main_launches,
        "flash_attention_paths": main_paths, "other_launches": other,
        "flash_attention_s32768": flash_serve,
        "profile_decode": {"scope": f"one decode_32k step (B = {b}, {s} slots)",
                           **decode_profile},
        "profile_prefill": {"scope": f"one prefill_32k run ({b} x {s} tokens)",
                            **prefill_profile},
    }


def moe_parts_ms(torch, lp, cfg, y):
    """Device ms of one MoE FFN and of its parts on tokens y (T, d) with
    one layer's params lp: the routing (router, top-k, dispatch and combine
    tensors), the dispatch einsum, the experts' three einsums and SwiGLU,
    the combine einsum; their TFLOP by shape; the dropped share."""
    from repro_torch.kernels._timing import device_ms
    from repro_torch.models import moe

    mc = cfg.moe
    t, d = y.shape
    g = min(mc.group_size, t)
    n, cap = t // g, moe._capacity(g, mc)
    xs, s_disp, s_comb = y.reshape(n, g, d), "Ggec,Ggd->Gecd", "Ggec,Gecd->Ggd"
    _, disp, combine, _, _ = moe._route(lp["router"].float(), xs, mc, cap)
    xe = torch.einsum(s_disp, disp, xs)
    ye = moe._experts(lp, xe)
    slots = n * mc.n_experts * cap                  # expert rows, padding included
    out = {
        "tokens": t, "groups": n, "group": g, "capacity": cap, "expert_rows": slots,
        "route_ms": device_ms(lambda: moe._route(lp["router"].float(), xs, mc, cap), 3),
        "dispatch_ms": device_ms(lambda: torch.einsum(s_disp, disp, xs), 3),
        "experts_ms": device_ms(lambda: moe._experts(lp, xe), 3),
        "combine_ms": device_ms(lambda: torch.einsum(s_comb, combine, ye), 3),
        "moe_ffn_ms": device_ms(lambda: moe.moe_ffn(lp, y, mc), 3),
        "dispatch_combine_tflop": 2 * 2.0 * t * mc.n_experts * cap * d / 1e12,
        "experts_tflop": 3 * 2.0 * slots * d * mc.d_expert / 1e12,
        "dropped_frac": moe.moe_ffn(lp, y, mc)[1]["moe_dropped_frac"].item(),
    }
    del disp, combine, xe, ye
    return out


def phase_moe_serve(torch):
    """olmoe-1b-7b's prefill_32k and decode_32k cells at full width and
    depth through the flash kernel: the prefill cell's fn timed, then a
    prompt of whole groups prefilled (its cache rows held to the cell's)
    and MOE_SERVE_DECODE tokens decoded through the decode cell's fn;
    teacher forcing under the dropless twin; the flash kernel at the
    prefill's shape against its plain version on its first and last rows;
    a decode step and a prefill profiled, the MoE FFN's parts timed."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.common.treemath import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.kernels._timing import device_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_infonce import ops as infonce_ops
    from repro_torch.kernels.fused_topk import ops as topk_ops
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.attention import decode_attention

    cfg = dataclasses.replace(get_arch(MOE_ARCH).model_cfg, attention_impl=FLASH_IMPL)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre = steps.build_cell(MOE_ARCH, "prefill_32k", DEVICE, model_cfg=cfg,
                           global_batch=MOE_SERVE_BATCH)
    dec = steps.build_cell(MOE_ARCH, "decode_32k", DEVICE, model_cfg=cfg,
                           global_batch=MOE_SERVE_BATCH)
    b, s = tuple(pre.args[1].shape)
    kv_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.dh)
    require((b, s, cfg.n_heads, cfg.n_kv_heads, cfg.dh) == FLASH_MOE_SHAPE
            and tuple(dec.args[1].k.shape) == kv_shape,
            f"prefill_32k tokens {(b, s)}, decode_32k cache {tuple(dec.args[1].k.shape)}, "
            f"flash at {FLASH_MOE_SHAPE}")
    params = pre.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(b, s), dtype=np.int32)).to(DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ---- the main path, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launches()
    infonce_ops.reset_launches()
    topk_ops.reset_launches()
    # the prefill cell: a warm-up, then MOE_SERVE_PREFILL_RUNS timed runs;
    # each run's cache is dropped before the next is allocated, the last
    # one's kept for the generation's prompt rows
    prefill_times, prefill_launches, out = [], [], None
    for i in range(1 + MOE_SERVE_PREFILL_RUNS):
        out, before = None, flash_launches()
        out, dt = timed(torch, lambda: pre.fn(params, tokens))
        prefill_launches.append(flash_launches() - before)
        if i:
            prefill_times.append(dt)
        print(f"[moe_serve] prefill {i}: {dt:.3f} s", file=sys.stderr, flush=True)
    cell_cache, cell_logits = out
    del out
    cell_ok = (bool(torch.isfinite(cell_logits.float()).all())
               and tuple(cell_logits.shape) == (b, cfg.vocab_size)
               and bool((cell_cache.length == s).all()) and tuple(cell_cache.k.shape) == kv_shape)
    del cell_logits

    # the generation at the config's capacity: the prompt's groups are the
    # cell's, so its cache rows are the cell's; then decode steps through
    # the decode cell's fn, each timed
    p_len = MOE_SERVE_PROMPT
    before = flash_launches()
    (cache, logits), gen_prefill_s = timed(
        torch, lambda: lm.prefill(params, cfg, tokens[:, :p_len], max_seq=s))
    gen_prefill_launches = flash_launches() - before
    rows = {"mean_abs_diff": 0.0, "max_abs_diff": 0.0, "equal_share": 0.0}
    for got, want in ((cache.k, cell_cache.k), (cache.v, cell_cache.v)):
        for i in range(cfg.n_layers):
            diff = (got[i, :, :p_len].float() - want[i, :, :p_len].float()).abs()
            rows["mean_abs_diff"] += diff.mean().item() / (2 * cfg.n_layers)
            rows["max_abs_diff"] = max(rows["max_abs_diff"], diff.max().item())
            rows["equal_share"] += (diff == 0).float().mean().item() / (2 * cfg.n_layers)
    del cell_cache, diff
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr())
    gen = [logits.float()]
    decode_times, before = [], flash_launches()
    for t in range(p_len, p_len + MOE_SERVE_DECODE):
        (cache, logits), dt = timed(torch, lambda: dec.fn(params, cache, tokens[:, t]))
        gen.append(logits.float())
        decode_times.append(dt)
    decode_launches = flash_launches() - before
    gen = torch.stack(gen, 1)                                   # (B, 1 + decode, V)
    gen_finite = bool(torch.isfinite(gen).all())
    lengths = cache.length.tolist()
    in_place = (cache.k.data_ptr(), cache.v.data_ptr()) == ptrs
    del gen
    print(f"[moe_serve] decode: median {statistics.median(decode_times) * 1e3:.2f} ms a step",
          file=sys.stderr, flush=True)
    # where a decode step's time goes: the step profiled (it writes one
    # more row, past the generation's), the plain decode attention of one
    # layer, the MoE FFN's parts on the step's B tokens, and the cast of the
    # fp32 params to bf16 that every step does
    decode_profile = profile_step_share(
        torch, lambda: dec.fn(params, cache, tokens[:, 0]))
    q1 = torch.randn((b, 1, cfg.n_heads, cfg.dh), device=DEVICE).to(cfg.dtype)
    attn_layer_ms = device_ms(lambda: decode_attention(
        q1, cache.k[0], cache.v[0], cache_len=cache.length + 1), 5)
    del cache, q1
    layer0 = {key: leaf[0] for key, leaf in params["layers"]["ffn"].items()}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    decode_parts = moe_parts_ms(torch, layer0, cfg, torch.randn(
        (b, cfg.d_model), generator=g, device=DEVICE).to(cfg.dtype))
    cast = tree_leaves([params["layers"]["attn"], params["layers"]["ffn"],
                        params.get("lm_head")])
    cast_ms = device_ms(lambda: [t.to(cfg.dtype) for t in cast], 5)
    gc.collect()
    torch.cuda.empty_cache()

    # teacher forcing under the dropless twin: prefill, decode steps, then
    # one forward over the same tokens, its logits at the generation's
    # positions only
    tf_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k, group_size=MOE_TF_GROUP))
    tf_end = MOE_TF_PROMPT + MOE_TF_DECODE

    def dropless_generation(fault_step=None):
        """The twin's prompt prefilled and MOE_TF_DECODE tokens decoded ->
        (the logits (B, 1 + decode, V), the prefill's flash launches); the
        decode step fault_step is fed the next token id instead of its own."""
        before = flash_launches()
        cache, logits = lm.prefill(params, tf_cfg, tokens[:, :MOE_TF_PROMPT],
                                   max_seq=MOE_TF_SLOTS)
        launches = flash_launches() - before
        gen = [logits.float()]
        for i, t in enumerate(range(MOE_TF_PROMPT, tf_end)):
            token = tokens[:, t] if i != fault_step else (tokens[:, t] + 1) % cfg.vocab_size
            cache, logits = lm.decode_step(params, tf_cfg, cache, token)
            gen.append(logits.float())
        return torch.stack(gen, 1), launches

    tf_gen, tf_prefill_launches = dropless_generation()
    before = flash_launches()
    with torch.no_grad():
        (x, _, _), tf_s = timed(
            torch, lambda: lm.backbone(params, tf_cfg, tokens[:, :MOE_TF_SLOTS]))
        want = lm._head(params, tf_cfg, x[:, MOE_TF_PROMPT - 1:tf_end]).float()
    tf_launches = flash_launches() - before
    del x
    control_gen, control_launches = dropless_generation(MOE_TF_FAULT_STEP)
    control = (control_gen - want).abs().mean(-1)               # (B, 1 + decode)
    del control_gen
    main_launches = flash_launches()                 # read just after the main path
    main_paths = dict(flash_ops.flash_attention.paths)
    other = {"fused_infonce": sum(getattr(infonce_ops, f"fused_infonce_{k}").launches
                                  for k in ("fwd", "dq", "dp")),
             "fused_topk": topk_ops.fused_topk.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    diff = (tf_gen - want).abs()
    tf_finite = bool(torch.isfinite(tf_gen).all()) and bool(torch.isfinite(want).all())
    tf = {"group": MOE_TF_GROUP, "capacity_factor": tf_cfg.moe.capacity_factor,
          "prompt": MOE_TF_PROMPT, "decode_steps": MOE_TF_DECODE, "slots": MOE_TF_SLOTS,
          "positions": [MOE_TF_PROMPT - 1, tf_end - 1],
          "mean_abs_diff": diff.mean().item(), "max_abs_diff": diff.max().item(),
          "prefill_mean_abs_diff": diff[:, 0].mean().item(),
          "decode_mean_abs_diff": diff[:, 1:].mean().item(),
          "decode_max_abs_diff": diff[:, 1:].max().item(),
          "position_mean_abs_diff_max": diff.mean(-1).max().item(),
          "control_fault_step": MOE_TF_FAULT_STEP,
          "control_fault_position_mean_abs_diff": control[:, MOE_TF_FAULT_STEP + 1].tolist(),
          "control_position_mean_abs_diff_max": control.max().item(),
          "positions_over_lm_serve_max": int((diff.amax(-1) > LM_SERVE_TF_MAX).sum()),
          "top1_agreement": (tf_gen.argmax(-1) == want.argmax(-1)).float().mean().item(),
          "logit_std": want.std().item(), "forward_s": tf_s}
    del tf_gen, want, diff, control
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the flash kernel at the prefill's attention (not counted)
    flash_moe = flash_at_serve_shape(torch, FLASH_MOE_SHAPE)

    # ---- one prefill profiled (its cache dropped before the next run), and
    # the MoE FFN's parts on the prefill's B x S tokens
    prefill_profile = profile_step_share(torch, lambda: pre.fn(params, tokens))
    gc.collect()
    torch.cuda.empty_cache()
    prefill_parts = moe_parts_ms(torch, layer0, cfg, torch.randn(
        (b * s, cfg.d_model), generator=g, device=DEVICE).to(cfg.dtype))
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    del params, tokens, layer0, cast
    gc.collect()
    torch.cuda.empty_cache()

    per_pass = cfg.n_layers
    require(cell_ok, "the prefill cell's cache or logits are not what its shape says, or "
                     "not finite")
    require(rows["mean_abs_diff"] <= LM_SERVE_TF_MEAN and rows["max_abs_diff"] <= LM_SERVE_TF_MAX,
            f"the generation's prompt cache rows against the prefill cell's: {rows}")
    require(gen_finite and tf_finite, "non-finite generation or teacher-forced logits")
    require(tf["mean_abs_diff"] <= MOE_TF_MEAN and tf["max_abs_diff"] <= MOE_TF_MAX
            and tf["position_mean_abs_diff_max"] <= MOE_TF_POSITION_MEAN,
            f"dropless generation against teacher forcing: {tf}")
    require(min(tf["control_fault_position_mean_abs_diff"]) > MOE_TF_POSITION_MEAN,
            f"a wrong token at decode step {MOE_TF_FAULT_STEP} passes the per-position check: "
            f"{tf}")
    require(lengths == [p_len + MOE_SERVE_DECODE] * b, f"cache.length ends at {lengths}")
    require(in_place, "decode moved the cache: its data_ptr changed")
    require(prefill_launches == [per_pass] * (1 + MOE_SERVE_PREFILL_RUNS)
            and gen_prefill_launches == tf_prefill_launches == tf_launches == per_pass
            and control_launches == per_pass and decode_launches == 0,
            f"flash_attention launched {prefill_launches} a prefill cell run, "
            f"{gen_prefill_launches} in the generation's prefill, {decode_launches} in its "
            f"decode, {tf_prefill_launches}, {tf_launches} and {control_launches} in the "
            f"dropless prefill, forward and control prefill; want {per_pass}, {per_pass}, 0 "
            f"and {per_pass} each")
    require(main_paths["hopper"] == main_launches,
            f"flash_attention took {main_paths}, not all the bf16 Hopper kernel")
    require(other == {"fused_infonce": 0, "fused_topk": 0}, f"moe_serve launched {other}")
    require(peak_bytes < MOE_SERVE_PEAK_BYTES, f"moe_serve peak memory {peak_bytes / 1e9:.1f} GB")
    require(bool(prefill_profile.get("flash_launches")) and bool(prefill_profile.get("flash_ms")),
            f"the profiled prefill shows no flash_fwd_kernel time: {prefill_profile}")
    prefill_s = statistics.median(prefill_times)
    decode_s = statistics.median(decode_times)
    kv_bytes = dec.static_info["kv_cache_bytes"]

    def shares(parts, profile):
        """The MoE parts' device time over all layers, as shares of the
        profiled run's kernel time."""
        if not profile.get("device_ms"):
            return None
        return {f"{key[:-3]}_share": parts[key] * cfg.n_layers / profile["device_ms"]
                for key in ("route_ms", "dispatch_ms", "experts_ms", "combine_ms", "moe_ffn_ms")}

    return {
        "model": f"{MOE_ARCH} MoE causal LM (d_model {cfg.d_model}, {cfg.n_heads} heads, "
                 f"{cfg.n_kv_heads} KV heads of {cfg.dh}, {cfg.moe.n_experts} experts, top "
                 f"{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}, capacity factor "
                 f"{cfg.moe.capacity_factor}, groups of {cfg.moe.group_size}, vocab "
                 f"{cfg.vocab_size}; all {cfg.n_layers} layers; seeded init; attention "
                 f"{FLASH_IMPL})",
        "cells": {name: {"global_batch": [get_arch(MOE_ARCH).shapes[name].params["global_batch"],
                                          b], "seq_len": s}
                  for name in ("prefill_32k", "decode_32k")},
        "params": pre.static_info["params"], "active_params": pre.static_info["active_params"],
        "param_bytes": param_bytes, "setup_s": setup_s,
        "prefill": {"runs_s": prefill_times, "median_s": prefill_s,
                    "tokens_per_s": pre.static_info["tokens_per_step"] / prefill_s,
                    "model_flops": pre.static_info["model_flops"],
                    "model_flops_share": pre.static_info["model_flops"] / prefill_s
                    / PEAK_BF16_FLOPS,
                    "model_flops_leave_out": "the capacity-padded expert rows and the "
                                             "dispatch and combine einsums (moe_parts)",
                    "flash_launches_per_run": prefill_launches},
        "generation": {"prompt": p_len, "decode_steps": MOE_SERVE_DECODE, "slots": s,
                       "prefill_s": gen_prefill_s, "lengths_at_end": lengths,
                       "cache_in_place": in_place, "prompt_rows_vs_cell": rows},
        "decode": {"step_times_s": decode_times, "median_ms": decode_s * 1e3,
                   "tokens_per_s": b / decode_s,
                   "kv_cache_bytes": kv_bytes,
                   "bytes_per_step": param_bytes + kv_bytes,
                   "byte_share": (param_bytes + kv_bytes) / decode_s / PEAK_BYTES_PER_S,
                   "bound_ms_bf16_params": (param_bytes // 2 + kv_bytes) / PEAK_BYTES_PER_S
                   * 1e3,
                   "bound_ms_fp32_params": (param_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3,
                   "attention_ms_per_layer": attn_layer_ms,
                   "attention_ms_per_step": attn_layer_ms * cfg.n_layers,
                   "param_cast_ms": cast_ms,
                   "flash_launches": decode_launches},
        "teacher_forcing_dropless": tf,
        "moe_parts_decode": {**decode_parts, **(shares(decode_parts, decode_profile) or {})},
        "moe_parts_prefill": {**prefill_parts, **(shares(prefill_parts, prefill_profile) or {})},
        "max_memory_allocated": peak_bytes, "flash_attention_launches": main_launches,
        "flash_attention_paths": main_paths, "other_launches": other,
        "flash_attention_s32768": flash_moe,
        "profile_decode": {"scope": f"one decode_32k step (B = {b}, {s} slots)",
                           **decode_profile},
        "profile_prefill": {"scope": f"one prefill_32k run ({b} x {s} tokens)",
                            **prefill_profile},
    }


def leaf_names(tree, prefix=""):
    """The '/'-joined key paths of a param tree's leaves, in tree_leaves'
    order."""
    if isinstance(tree, dict):
        return [name for key, sub in tree.items() for name in leaf_names(sub, f"{prefix}{key}/")]
    return [prefix[:-1]]


class RouteLog:
    """``models.moe._route`` wrapped inside a ``with`` block: each call's
    routed and kept masks (G, g, E) recorded as bool, in call order (under
    remat "full" the backward calls it again for each layer, the last layer
    first). With ``replay`` (one routed mask a layer, from another run's
    forward), every call routes each token to the experts of that mask in
    place of its own top k, with JAX's formulation: the gates are those
    experts' probs renormalised, the slots the cumulative count a group."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe._route
        moe._route = self._call
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route

    def forward_masks(self, n_layers):
        return [routed for routed, _ in self.calls[:n_layers]]

    def _call(self, router, xs, cfg, cap):
        import torch

        probs, disp, combine, mask, keep = self._route(router, xs, cfg, cap)
        if self.replay is not None:
            n, c = len(self.replay), len(self.calls)
            mask = self.replay[c if c < n else 2 * n - 1 - c].to(probs.dtype)
            gates = probs * mask
            if cfg.normalize_top_k:
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
            pos = torch.cumsum(mask, dim=-2) - 1.0
            keep = mask * (pos < cap).to(torch.float32)
            slot = torch.where(keep > 0, pos, -1.0)
            disp = (slot[..., None] == torch.arange(cap, dtype=slot.dtype, device=xs.device)
                    ).to(xs.dtype)
            combine = disp * gates[..., None].to(xs.dtype)
        self.calls.append((mask.bool(), keep.bool()))
        return probs, disp, combine, mask, keep


def routing_diff(a, b):
    """Per layer, the (token, expert) assignments routed differently by two
    runs' masks (each moved assignment counted once) and the tokens with
    any such move."""
    return {"assignments_moved": [int((x != y).sum()) // 2 for x, y in zip(a, b)],
            "tokens_moved": [int((x != y).any(-1).sum()) for x, y in zip(a, b)]}


def dropped_shares(log, n_layers):
    """Each layer's dropped share in a run's forward: 1 - kept / routed."""
    return [1.0 - keep.sum().item() / routed.sum().item()
            for routed, keep in log.calls[:n_layers]]


def moe_train_parts_ms(torch, lp, cfg, y):
    """Device ms of the MoE FFN's parts on tokens y (T, d) with one layer's
    params lp, forward (``moe_parts_ms``) and backward: each part's
    autograd backward from a seeded output gradient to its inputs (routing:
    the combine tensor back to the router and the tokens; dispatch: the
    buffers back to the tokens; experts: their outputs back to the buffers
    and the three weights; combine: the output back to the combine tensor
    and the experts' outputs)."""
    from repro_torch.kernels._timing import device_ms
    from repro_torch.models import moe

    mc = cfg.moe
    t, d = y.shape
    g = min(mc.group_size, t)
    n, cap = t // g, moe._capacity(g, mc)
    gen = torch.Generator(device=y.device).manual_seed(SEED + 8)
    router = lp["router"].detach().float().requires_grad_(True)
    weights = {key: lp[key].detach().requires_grad_(True) for key in ("w_gate", "w_up", "w_down")}
    xs = y.reshape(n, g, d).detach().requires_grad_(True)
    _, disp, combine, _, _ = moe._route(router, xs, mc, cap)
    xe = torch.einsum("Ggec,Ggd->Gecd", disp, xs)
    xe_in = xe.detach().requires_grad_(True)
    ye = moe._experts(weights, xe_in)
    combine_in, ye_in = combine.detach().requires_grad_(True), ye.detach().requires_grad_(True)
    out = torch.einsum("Ggec,Gecd->Ggd", combine_in, ye_in)

    def backward_ms(output, inputs):
        grad = torch.randn(output.shape, generator=gen, device=y.device).to(output.dtype)
        return device_ms(lambda: torch.autograd.grad(output, inputs, grad, retain_graph=True), 3)

    res = {"route_bwd_ms": backward_ms(combine, (router, xs)),
           "dispatch_bwd_ms": backward_ms(xe, (xs,)),
           "experts_bwd_ms": backward_ms(ye, (xe_in, *weights.values())),
           "combine_bwd_ms": backward_ms(out, (combine_in, ye_in))}
    del disp, combine, xe, xe_in, ye, combine_in, ye_in, out
    return {**moe_parts_ms(torch, {key: w.detach() for key, w in lp.items()}, cfg, y), **res}


def attention_train_ms(torch, cfg, b, s):
    """Device ms of one layer's causal attention at the shape (b, s) of a
    train microbatch through ``cfg.attention_impl``: the forward, and the
    backward from a seeded output gradient to q, k and v (the flash op's
    recomputes through autograd of chunked attention)."""
    from repro_torch.kernels._timing import device_ms
    from repro_torch.models.attention import attention

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)

    def rand(heads):
        return torch.randn((b, s, heads, cfg.dh), generator=gen, device=DEVICE).to(
            cfg.dtype).requires_grad_(True)

    q, k, v = rand(cfg.n_heads), rand(cfg.n_kv_heads), rand(cfg.n_kv_heads)

    def forward():
        return attention(q, k, v, impl=cfg.attention_impl, causal=True, q_chunk=cfg.q_chunk,
                         kv_chunk=cfg.kv_chunk)

    out = forward()
    grad = torch.randn(out.shape, generator=gen, device=DEVICE).to(out.dtype)
    return {"fwd_ms": device_ms(forward, 3),
            "bwd_ms": device_ms(lambda: torch.autograd.grad(out, (q, k, v), grad,
                                                            retain_graph=True), 3)}


def phase_moe_train(torch):
    """olmoe-1b-7b's train_4k cell (launch/steps.py's causal-LM train
    program) at full width, MOE_TRAIN_LAYERS of 16 layers, through the flash
    kernel: the first microbatch's loss and gradient through flash held
    against chunked attention (the routing replayed, the flips counted),
    remat "full" against "none" on one sequence, then MOE_TRAIN_STEPS
    steps, then one microbatch profiled and the MoE FFN's parts timed."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.common.treemath import tree_leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_infonce import ops as infonce_ops
    from repro_torch.kernels.fused_topk import ops as topk_ops
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(MOE_ARCH).model_cfg, n_layers=MOE_TRAIN_LAYERS,
                              attention_impl=FLASH_IMPL, remat="full")
    n_layers = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prog = steps.build_cell(MOE_ARCH, "train_4k", DEVICE, model_cfg=cfg,
                            micro_batches=LM_TRAIN_MICRO_BATCHES)
    info, cell = prog.static_info, get_arch(MOE_ARCH).shapes["train_4k"].params
    m, shape = info["microbatches"], tuple(prog.args[1].shape)
    require(m == LM_TRAIN_MICRO_BATCHES and shape == (m, cell["global_batch"] // m,
                                                       cell["seq_len"]),
            f"train_4k inputs are {shape}")
    b, s = shape[1:]
    require((b, s, cfg.n_heads, cfg.n_kv_heads, cfg.dh) == FLASH_LM_PATH_SHAPES["moe_train"],
            f"the microbatch's attention is not {FLASH_LM_PATH_SHAPES['moe_train']}")
    state = prog.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    names = leaf_names(state.params)

    def next_tokens(rng, size):
        tokens = rng.integers(0, cfg.vocab_size, size=size, dtype=np.int32)
        targets = np.roll(tokens, -1, axis=-1)
        targets[..., -1] = -1
        return torch.from_numpy(tokens).to(DEVICE), torch.from_numpy(targets).to(DEVICE)

    rng = np.random.default_rng(SEED)
    batches = [next_tokens(rng, shape) for _ in range(MOE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def loss_and_grads(c, params, tokens, targets, log=None):
        """One microbatch's lm_loss forward and backward, as the train step
        runs it: (loss, moe_aux, the gradient leaves)."""
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with log if log is not None else contextlib.nullcontext():
            loss, aux = lm.lm_loss(leaves, c, tokens, targets)
            loss.backward()
        return loss.item(), aux["moe_aux"].item(), [t.grad for t in tree_leaves(leaves)]

    def leaf_errs(got, want):
        return [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]

    def flash_vs_chunked(params, tokens, targets, control=False):
        """The first microbatch through flash, and through chunked attention
        twice: routed freely (its forward's flips against flash's counted)
        and with flash's routing replayed; each gradient leaf's largest
        difference over its largest |g|. With ``control``, flash's gradient
        at the targets shifted by one against the replayed run's too."""
        chunked = dataclasses.replace(cfg, attention_impl="chunked")
        flash_log, free_log = RouteLog(), RouteLog()
        fl, fl_aux, fg = loss_and_grads(cfg, params, tokens, targets, flash_log)
        flash_masks = flash_log.forward_masks(n_layers)
        free_loss, _, free_g = loss_and_grads(chunked, params, tokens, targets, free_log)
        free_errs = leaf_errs(free_g, fg)
        del free_g
        replay_log = RouteLog(replay=flash_masks)
        cl, _, cg = loss_and_grads(chunked, params, tokens, targets, replay_log)
        errs = leaf_errs(fg, cg)
        del fg
        res = {"flash_loss": fl, "chunked_loss": cl, "loss_rel_err": rel_err(fl, cl),
               "moe_aux": fl_aux, "dropped_frac_by_layer": dropped_shares(flash_log, n_layers),
               "grad_errs_by_leaf": dict(zip(names, errs)), "grad_err_of_max": max(errs),
               # the replay's slots and drops are _route's on the same mask
               "replay_keeps_as_flash": all(
                   torch.equal(flash_log.calls[i][1], replay_log.calls[i][1])
                   for i in range(n_layers)),
               "flips": {**routing_diff(flash_masks, free_log.forward_masks(n_layers)),
                         "assignments": [int(x.sum()) for x in flash_masks]},
               "free": {"chunked_loss": free_loss, "loss_rel_err": rel_err(fl, free_loss),
                        "grad_errs_by_leaf": dict(zip(names, free_errs))}}
        if control:
            shifted = torch.roll(targets, 1, dims=-1)
            _, _, sg = loss_and_grads(cfg, params, tokens, shifted)
            control_errs = leaf_errs(sg, cg)
            res["control_shifted_targets"] = {"grad_errs_by_leaf": dict(zip(names, control_errs)),
                                              "grad_err_of_min": min(control_errs)}
            del sg
        del cg
        return res

    # parity (a): the first microbatch, flash against chunked attention on
    # the same params and tokens (launches not counted)
    tokens0, targets0 = batches[0][0][0], batches[0][1][0]
    parity = flash_vs_chunked(state.params, tokens0, targets0, control=True)
    gc.collect()
    torch.cuda.empty_cache()
    # the same with params and tokens of the next seed: recorded, not held
    seed2 = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 1), device=DEVICE)
    parity_seed2 = flash_vs_chunked(seed2, *next_tokens(np.random.default_rng(SEED + 1),
                                                       shape[1:]))
    del seed2
    gc.collect()
    torch.cuda.empty_cache()

    # parity (b): remat "full" against "none" on one sequence, flash in both
    tk1, tg1 = tokens0[:1], targets0[:1]
    full_log, none_log = RouteLog(), RouteLog()
    full_loss, full_aux, full_g = loss_and_grads(cfg, state.params, tk1, tg1, full_log)
    none_loss, none_aux, none_g = loss_and_grads(dataclasses.replace(cfg, remat="none"),
                                                 state.params, tk1, tg1, none_log)
    remat_errs = leaf_errs(full_g, none_g)
    del full_g, none_g
    remat = {
        "tokens": s, "full_loss": full_loss, "none_loss": none_loss,
        "full_moe_aux": full_aux, "none_moe_aux": none_aux,
        "full_dropped_by_layer": dropped_shares(full_log, n_layers),
        "none_dropped_by_layer": dropped_shares(none_log, n_layers),
        "route_calls": [len(full_log.calls), len(none_log.calls)],
        # the backward's recompute of layer i is call 2n - 1 - i
        "recompute_routes_as_forward": len(full_log.calls) == 2 * n_layers and all(
            torch.equal(full_log.calls[i][j], full_log.calls[2 * n_layers - 1 - i][j])
            for i in range(n_layers) for j in (0, 1)),
        "forward_routes_as_none": all(
            torch.equal(x[j], y[j]) for x, y in zip(full_log.calls, none_log.calls)
            for j in (0, 1)),
        "grad_errs_by_leaf": dict(zip(names, remat_errs)), "grad_err_of_max": max(remat_errs),
    }
    del full_log, none_log
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the main path: MOE_TRAIN_STEPS steps of the cell, counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launches()
    infonce_ops.reset_launches()
    topk_ops.reset_launches()
    losses, times, launches_per_step = [], [], []
    for i, (tokens, targets) in enumerate(batches):
        before = flash_ops.flash_attention.launches
        t1 = time.perf_counter()
        state, metrics = prog.fn(state, tokens, targets)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t1)
        launches_per_step.append(flash_ops.flash_attention.launches - before)
        print(f"[moe_train] step {i}: {times[-1]:.3f} s, loss {losses[-1]:.5f}", file=sys.stderr,
              flush=True)
    torch.cuda.synchronize()
    flash_launches = flash_ops.flash_attention.launches      # read just after the run
    flash_paths = dict(flash_ops.flash_attention.paths)
    other = {"fused_infonce": sum(getattr(infonce_ops, f"fused_infonce_{k}").launches
                                  for k in ("fwd", "dq", "dp")),
             "fused_topk": topk_ops.fused_topk.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    final_step = int(state.step)

    # the first microbatch's aux term and drops after the steps
    after_log = RouteLog()
    with torch.no_grad(), after_log:
        _, after_aux = lm.lm_loss(state.params, cfg, tokens0, targets0)
    after = {"moe_aux": after_aux["moe_aux"].item(),
             "dropped_frac_by_layer": dropped_shares(after_log, n_layers)}
    del after_log

    # where the time goes: one microbatch under the profiler, and the MoE
    # FFN's parts at its 8 x 4096 tokens, forward and backward
    t1 = time.perf_counter()
    profile = profile_step_share(torch, lambda: loss_and_grads(cfg, state.params, tokens0,
                                                                targets0))
    profile_s = time.perf_counter() - t1
    layer0 = {key: leaf[0] for key, leaf in state.params["layers"]["ffn"].items()}
    del state, batches, prog
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    parts = moe_train_parts_ms(torch, layer0, cfg, torch.randn(
        (b * s, cfg.d_model), generator=g, device=DEVICE).to(cfg.dtype))
    del layer0
    gc.collect()
    torch.cuda.empty_cache()
    attn = attention_train_ms(torch, cfg, b, s)
    gc.collect()
    torch.cuda.empty_cache()

    want_loss = math.log(cfg.vocab_size) + 0.5 + cfg.moe.router_aux_weight * cfg.moe.top_k
    require(math.isfinite(parity["flash_loss"])
            and parity["loss_rel_err"] <= LM_TRAIN_LOSS_RTOL,
            f"lm_loss through flash {parity['flash_loss']} vs chunked {parity['chunked_loss']}")
    require(parity["replay_keeps_as_flash"],
            "the replayed routing keeps other assignments than the flash run's")
    require(parity["grad_err_of_max"] <= PARITY_GRAD_RTOL,
            f"lm_loss gradient through flash vs chunked (routing replayed): "
            f"{parity['grad_errs_by_leaf']}")
    flip_shares = [moved / total for moved, total in zip(parity["flips"]["assignments_moved"],
                                                         parity["flips"]["assignments"])]
    require(max(flip_shares) <= MOE_TRAIN_FLIP_SHARE,
            f"flash and chunked attention route {flip_shares} of a layer's assignments apart")
    require(parity["control_shifted_targets"]["grad_err_of_min"] > PARITY_GRAD_RTOL,
            f"flash's gradient at shifted targets passes the check: "
            f"{parity['control_shifted_targets']}")
    require(remat["full_loss"] == remat["none_loss"]
            and remat["full_dropped_by_layer"] == remat["none_dropped_by_layer"]
            and remat["recompute_routes_as_forward"] and remat["forward_routes_as_none"],
            f"remat full against none: {remat}")
    require(remat["grad_err_of_max"] <= MOE_TRAIN_REMAT_GRAD_RTOL,
            f"remat full against none, gradients: {remat['grad_errs_by_leaf']}")
    require(all(math.isfinite(x) for x in losses), f"non-finite moe_train loss {losses}")
    require(abs(losses[0] - want_loss) <= LM_TRAIN_LOSS_SLACK,
            f"step-0 loss {losses[0]} is not within {LM_TRAIN_LOSS_SLACK} of {want_loss}")
    require(final_step == MOE_TRAIN_STEPS, f"state.step is {final_step}")
    per_step = n_layers * 2 * m         # forward and remat recompute, each microbatch
    require(launches_per_step == [per_step] * MOE_TRAIN_STEPS,
            f"flash_attention launched {launches_per_step} a step, not {per_step}")
    require(flash_paths["hopper"] == flash_launches,
            f"flash_attention took {flash_paths}, not all the bf16 Hopper kernel")
    require(other == {"fused_infonce": 0, "fused_topk": 0}, f"moe_train launched {other}")
    require(peak_bytes < MOE_TRAIN_PEAK_BYTES, f"moe_train peak memory {peak_bytes / 1e9:.1f} GB")
    require(bool(profile.get("flash_launches")) and bool(profile.get("flash_ms")),
            f"the profiled moe_train microbatch shows no flash_fwd_kernel time: {profile}")
    step_s = statistics.median(times)
    tokens_per_step = info["tokens_per_step"]
    device_ms_ = profile.get("device_ms")
    fwd = sum(parts[k] for k in ("route_ms", "dispatch_ms", "experts_ms", "combine_ms"))
    bwd = sum(parts[k] for k in ("route_bwd_ms", "dispatch_bwd_ms", "experts_bwd_ms",
                                 "combine_bwd_ms"))
    # a microbatch runs each layer's MoE FFN and attention forward twice
    # (the forward and the recompute) and backward once
    shares = None if not device_ms_ else {
        **{f"{k[:-3]}_share": 2 * parts[k] * n_layers / device_ms_
           for k in ("route_ms", "dispatch_ms", "experts_ms", "combine_ms")},
        **{f"{k[:-3]}_share": parts[k] * n_layers / device_ms_
           for k in ("route_bwd_ms", "dispatch_bwd_ms", "experts_bwd_ms", "combine_bwd_ms")},
        "moe_forward_share": 2 * fwd * n_layers / device_ms_,
        "moe_backward_share": bwd * n_layers / device_ms_}
    attn_shares = None if not device_ms_ else {
        "fwd_share": 2 * attn["fwd_ms"] * n_layers / device_ms_,
        "bwd_share": attn["bwd_ms"] * n_layers / device_ms_}
    return {
        "model": f"{MOE_ARCH} MoE causal LM (d_model {cfg.d_model}, {cfg.n_heads} heads, "
                 f"{cfg.n_kv_heads} KV heads of {cfg.dh}, {cfg.moe.n_experts} experts, top "
                 f"{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}, capacity factor "
                 f"{cfg.moe.capacity_factor}, groups of {cfg.moe.group_size}, vocab "
                 f"{cfg.vocab_size}; {n_layers} of 16 layers; seeded init; remat full; "
                 f"attention {FLASH_IMPL})",
        "cell": "train_4k", "steps": MOE_TRAIN_STEPS, "microbatches": m,
        "microbatch_shape": [b, s], "tokens_per_step": tokens_per_step,
        "params": info["params"], "active_params": info["active_params"],
        "model_flops": info["model_flops"], "setup_s": setup_s,
        "parity": {**parity, "seed2": parity_seed2, "flip_share_by_layer": flip_shares},
        "remat_full_vs_none": remat,
        "losses": losses, "step0_loss_expected": want_loss,
        "first_microbatch_step0": {"moe_aux": parity["moe_aux"],
                                   "dropped_frac_by_layer": parity["dropped_frac_by_layer"]},
        "first_microbatch_after": after,
        "step_times_s": times, "median_step_s": step_s,
        "tokens_per_s": tokens_per_step / step_s,
        "model_flops_share": info["model_flops"] / step_s / PEAK_BF16_FLOPS,
        "max_memory_allocated": peak_bytes, "flash_attention_launches": flash_launches,
        "flash_launches_per_step": per_step, "flash_attention_paths": flash_paths,
        "other_launches": other,
        "profile": {"scope": "one microbatch: lm_loss forward and backward", **profile},
        "profile_s": profile_s,
        "moe_parts": {**parts, **(shares or {})},
        "attention_parts": {"shape": [b, s, cfg.n_heads, cfg.n_kv_heads, cfg.dh], **attn,
                            **(attn_shares or {})},
        "flash_ms_per_step": profile["flash_ms"] / profile["flash_launches"] * per_step,
        "microbatch_kernels_share_of_step": m * profile["device_ms"] / (step_s * 1e3),
    }


def bag_bound_ms(indices, n_bags: int, d: int, itemsize: int):
    """(bound_ms, "bytes", distinct rows) of one embedding_bag call: each
    distinct row read once, the indices and bag ids once (8 bytes a lookup),
    the output written once, over HBM bandwidth (a lookup adds D values:
    well under one operation per byte)."""
    import torch

    distinct = torch.unique(indices).numel()
    moved = distinct * d * itemsize + 8 * indices.numel() + n_bags * d * itemsize
    return moved / PEAK_BYTES_PER_S * 1e3, "bytes", distinct


def dcn_bags(torch, n_samples: int, vocabs, rows: int):
    """Multi-hot lookups of n_samples x 26 fields with DCN_POOLING lookups a
    field: ids drawn per field as ClickLogGenerator draws them (zipf,
    a=ZIPF_A, modulo the vocabulary) plus the field's stacked-table offset,
    then modulo ``rows``. Bag b = sample * 26 + field, sorted. Returns
    (indices, bag_ids) int32 on the device and the number of bags."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    offs = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    cols = [((rng.zipf(ZIPF_A, (n_samples, n)) - 1) % v + o) % rows
            for n, v, o in zip(DCN_POOLING, vocabs, offs)]
    indices = np.concatenate(cols, axis=1).ravel()           # sample-major, field, lookup
    n_bags = n_samples * len(DCN_POOLING)
    bag_ids = np.repeat(np.arange(n_bags), np.tile(DCN_POOLING, n_samples))
    to = lambda a: torch.from_numpy(a.astype(np.int32)).to(DEVICE)  # noqa: E731
    return to(indices), to(bag_ids), n_bags


def phase_embedding_bag_kernels(torch):
    """embedding_bag against its plain version at the dcn-v2 stacked table
    (64-bit row offsets), at D=128 in fp32 and bf16, with empty bags, and
    its backward; each timed against F.embedding_bag (the yardstick)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.kernels._timing import device_ms

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    dcn = get_arch("dcn-v2")
    cfg, n_samples = dcn.model_cfg, dcn.shapes["train_batch"].params["batch"]

    def check(name, table, indices, bag_ids, n_bags, timed=True):
        out = ops.embedding_bag(table, indices, bag_ids, n_bags)
        torch.cuda.synchronize()
        err = ref.embedding_bag_error(out, table, indices, bag_ids, n_bags)
        # the same adds in the same order and dtype: bit-equal in fp32 and bf16
        require(err["equal"], f"{name}: kernel departs from the plain version: {err}")
        v, d = table.shape
        res = {"V": v, "D": d, "dtype": str(table.dtype).replace("torch.", ""),
               "table_bytes": table.numel() * table.element_size(),
               "lookups": indices.numel(), "bags": n_bags, "max_abs_err": err["max_abs_err"],
               "equal_to_plain": err["equal"], "worst_share_of_allowance": err["worst"]}
        if not timed:
            return res, out
        offsets = torch.searchsorted(bag_ids, torch.arange(n_bags, dtype=torch.int32, device=dev),
                                     out_int32=True)
        bound_ms, bound_by, distinct = bag_bound_ms(indices, n_bags, d, table.element_size())
        res.update({
            "distinct_rows": distinct,
            "ms": device_ms(lambda: ops.embedding_bag(table, indices, bag_ids, n_bags), 20),
            "plain_ms": device_ms(lambda: ref.embedding_bag_ref(table, indices, bag_ids, n_bags), 2),
            "library_ms": device_ms(
                lambda: F.embedding_bag(indices, table, offsets, mode="sum"), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        return res, out

    result = {}
    # 1. the full dcn-v2 stacked table: 187,767,808 x 16 fp32, 3.0e9 elements
    table = torch.empty((cfg.total_rows, cfg.embed_dim), device=dev)
    table.uniform_(-0.05, 0.05, generator=g)
    indices, bag_ids, n_bags = dcn_bags(torch, n_samples, cfg.vocab_sizes, cfg.total_rows)
    result["dcn_v2"], _ = check("dcn-v2 table", table, indices, bag_ids, n_bags)
    del table
    torch.cuda.empty_cache()

    # 2. dlrm-mlperf's width on the same bags, rows cut to 2^24
    wide_idx = indices % BAG_WIDE_ROWS
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((BAG_WIDE_ROWS, 128), generator=g, device=dev).to(dtype)
        name = f"d128_{str(dtype).replace('torch.', '')}"
        result[name], _ = check(name, table, wide_idx, bag_ids, n_bags)
        del table
        torch.cuda.empty_cache()
    del indices, bag_ids, wide_idx

    # 3. empty bags (only every third bag gets lookups) must come out 0
    table = torch.randn((5000, 16), generator=g, device=dev)
    bag_ids = torch.sort(torch.randint(0, 300, (2000,), generator=g, device=dev) * 3).values
    indices = torch.randint(0, 5000, (2000,), generator=g, device=dev)
    res, out = check("empty bags", table, indices, bag_ids, 900, timed=False)
    empty = torch.bincount(bag_ids.long(), minlength=900) == 0
    require(bool(empty.any()) and bool((out[empty] == 0).all()), "empty bags are not 0")
    result["empty_bags"] = {**res, "empty": int(empty.sum().item())}

    # 4. the backward at a cut size against the plain version's autograd
    indices, bag_ids, n_bags = dcn_bags(torch, BAG_GRAD_SAMPLES, cfg.vocab_sizes, BAG_GRAD_ROWS)
    table = torch.randn((BAG_GRAD_ROWS, cfg.embed_dim), generator=g, device=dev)
    w = torch.randn((n_bags, cfg.embed_dim), generator=g, device=dev)
    grads = []
    for fn in (ops.embedding_bag, ref.embedding_bag_ref):
        t = table.clone().requires_grad_(True)
        (fn(t, indices, bag_ids, n_bags) * w).sum().backward()
        grads.append(t.grad)
    summed = torch.zeros_like(table).index_add_(0, indices, w[bag_ids].abs())
    err = (grads[0] - grads[1]).abs()
    share = (err / (BAG_GRAD_RTOL * summed).clamp(min=1e-30)).max().item()
    require(share <= 1.0, f"embedding_bag backward: an element uses {share} of its allowance")
    result["backward"] = {"V": BAG_GRAD_ROWS, "D": cfg.embed_dim, "lookups": indices.numel(),
                          "bags": n_bags, "max_abs_err": err.max().item(),
                          "max_abs_grad": grads[1].abs().max().item(),
                          "rtol_of_summed_abs": BAG_GRAD_RTOL, "worst_share_of_allowance": share}
    return result


def phase_recsys(torch):
    """dcn-v2 train_batch through launch/steps.py's recsys_train program,
    vocabularies capped at RECSYS_ROW_CAP rows a field."""
    import dataclasses

    from repro_torch.common.treemath import tree_leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import ClickLogGenerator
    from repro_torch.launch import steps
    from repro_torch.models.recsys import _mlp_apply, bce_loss, embedding_lookup, forward

    arch = get_arch("dcn-v2")
    full, b = arch.model_cfg, arch.shapes["train_batch"].params["batch"]

    def capped(cap):
        return dataclasses.replace(full, vocab_sizes=tuple(min(v, cap) for v in full.vocab_sizes))

    def tensors(batch, device):
        return tuple(torch.from_numpy(batch[key]).to(device) for key in ("dense", "sparse", "labels"))

    cfg = capped(RECSYS_ROW_CAP)
    t0 = time.perf_counter()
    prog = steps.build_cell("dcn-v2", "train_batch", DEVICE, model_cfg=cfg)
    state = prog.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    table0 = state.params["table"].cpu()                 # for the untouched-rows check
    gen = ClickLogGenerator(cfg.vocab_sizes, cfg.n_dense, seed=SEED)
    offsets = cfg.field_offsets(DEVICE)
    touched = torch.zeros((cfg.total_rows,), dtype=torch.bool, device=DEVICE)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for step in range(RECSYS_STEPS):
        t0 = time.perf_counter()
        dense, sparse, labels = tensors(gen.batch(b, step), DEVICE)
        t1 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = prog.fn(state, dense, sparse, labels)
        end.record()
        loss = metrics["loss"].item()                    # waits for the step
        t2 = time.perf_counter()
        rows.append({"loss": loss, "accuracy": metrics["accuracy"].item(), "batch_s": t1 - t0,
                     "step_s": t2 - t0, "device_ms": start.elapsed_time(end)})
        touched[(sparse + offsets).long().ravel()] = True
    peak_bytes = torch.cuda.max_memory_allocated()
    # where a step's device time goes: one more step under the profiler (its
    # result is dropped, so the checks below see the 20 steps only)
    profile = profile_step_share(torch, lambda: prog.fn(state, dense, sparse, labels))
    require(all(math.isfinite(r["loss"]) for r in rows), "non-finite recsys loss")
    moved = (state.params["table"] != table0.to(DEVICE)).any(1)
    n_touched = int(touched.sum().item())
    require(not bool(moved[~touched].any()),
            f"{int(moved[~touched].sum().item())} table rows no batch indexed have changed")
    require(bool(moved[touched].all()),
            f"{int((~moved[touched]).sum().item())} of {n_touched} indexed rows did not move")
    del state, table0, moved, touched
    torch.cuda.empty_cache()

    # one step at a small cap: the card against the port on the CPU
    small = capped(RECSYS_PARITY_CAP)
    params = steps.build_cell("dcn-v2", "train_batch", "cpu", model_cfg=small).init(
        torch.Generator().manual_seed(SEED)).params
    batch = ClickLogGenerator(small.vocab_sizes, small.n_dense, seed=SEED).batch(RECSYS_PARITY_BATCH, 0)

    def on(device, dtype=torch.float32):
        cfg_ = dataclasses.replace(small, dtype=dtype, param_dtype=dtype)
        leaves = tree_map(lambda t: t.detach().to(device, dtype).requires_grad_(True), params)
        dense, sparse, labels = tensors(batch, device)
        return cfg_, leaves, dense.to(dtype), sparse, labels

    def loss_and_grads(device, dtype=torch.float32, keep=None):
        cfg_, leaves, dense, sparse, labels = on(device, dtype)
        if keep is None:
            loss, _ = bce_loss(leaves, cfg_, dense, sparse, labels)
        else:   # bce_loss's mean over the kept samples, at the batch's own shape
            logits = forward(leaves, cfg_, dense, sparse).float()
            per = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
            w = keep.to(device, per.dtype)
            loss = (per * w).sum() / w.sum()
        loss.backward()
        return loss.item(), [leaf.grad.cpu().double() for leaf in tree_leaves(leaves)]

    def relu_masks(device):
        """(B, units) the sign of every deep-MLP pre-activation, computed by
        the model's own ops (x0 as forward builds it, then each layer's
        pre-activation by _mlp_apply over the layers up to it)."""
        cfg_, leaves, dense, sparse, _ = on(device)
        with torch.no_grad():
            emb = embedding_lookup(leaves, cfg_, sparse)
            x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1)
            pre = [_mlp_apply(leaves["deep"][: i + 1], x0) for i in range(len(leaves["deep"]))]
        return torch.cat([z > 0 for z in pre], dim=-1).cpu()

    def share(a, c):
        return (a - c).abs().max().item() / c.abs().max().item()

    (loss_gpu, _), (loss_cpu, _) = loss_and_grads(DEVICE), loss_and_grads("cpu")
    require(rel_err(loss_gpu, loss_cpu) <= RECSYS_LOSS_RTOL,
            f"recsys step: card loss {loss_gpu} vs CPU {loss_cpu}")
    keep = (relu_masks(DEVICE) == relu_masks("cpu")).all(dim=1)
    flipped = int((~keep).sum().item())
    require(flipped <= RECSYS_MAX_FLIPPED * RECSYS_PARITY_BATCH,
            f"recsys step: {flipped} samples have a deep-MLP ReLU on the other side on the card")
    (_, g_gpu), (_, g_cpu) = loss_and_grads(DEVICE, keep=keep), loss_and_grads("cpu", keep=keep)
    fp32_share = max(share(a, c) for a, c in zip(g_gpu, g_cpu))
    require(fp32_share <= RECSYS_GRAD_RTOL,
            f"recsys step: an fp32 gradient leaf departs from the CPU's by {fp32_share} of its max")
    (_, g64_gpu), (_, g64_cpu) = (loss_and_grads(DEVICE, torch.float64),
                                  loss_and_grads("cpu", torch.float64))
    grad_share = max(share(a, c) for a, c in zip(g64_gpu, g64_cpu))
    require(grad_share <= RECSYS_GRAD_RTOL,
            f"recsys step: an fp64 gradient leaf departs from the CPU's by {grad_share} of its max")

    step_s = [r["step_s"] for r in rows[1:]]
    batch_s = [r["batch_s"] for r in rows[1:]]
    return {
        "model": "dcn-v2 (embed 16, 3 cross layers over x0=429, MLP 1024-1024-512, "
                 "final 941 -> 1; seeded init)",
        "cell": "train_batch", "batch": b, "steps": RECSYS_STEPS,
        "vocab_cap": RECSYS_ROW_CAP, "table_rows": cfg.total_rows,
        "table_bytes": cfg.total_rows * cfg.embed_dim * 4, "params": cfg.param_count(),
        "allow_tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
        "setup_s": setup_s, "first_step_s": rows[0]["step_s"],
        "median_step_s": statistics.median(step_s), "min_step_s": min(step_s),
        "max_step_s": max(step_s), "median_batch_s": statistics.median(batch_s),
        "host_share": statistics.median(batch_s) / statistics.median(step_s),
        "median_device_ms": statistics.median(r["device_ms"] for r in rows[1:]),
        "model_flops_per_step": prog.static_info["model_flops"],
        "model_tflops_per_s": prog.static_info["model_flops"] / statistics.median(
            r["device_ms"] for r in rows[1:]) * 1e-9,
        "samples_per_s": b / statistics.median(step_s),
        "max_memory_allocated": peak_bytes,
        "losses": [r["loss"] for r in rows], "accuracy": [r["accuracy"] for r in rows],
        "rows_indexed": n_touched,
        "profile": {key: profile[key] for key in ("step_wall_ms", "device_ms", "busy_share",
                                                  "kernel_launches", "top_kernels") if key in profile},
        "parity": {"cap": RECSYS_PARITY_CAP, "batch": RECSYS_PARITY_BATCH,
                   "loss_card": loss_gpu, "loss_cpu": loss_cpu,
                   "loss_rel_err": rel_err(loss_gpu, loss_cpu),
                   "worst_fp64_grad_err_of_max": grad_share,
                   "worst_fp32_grad_err_of_max": fp32_share,
                   "fp32_samples_with_a_flipped_relu": flipped},
    }


def infonce_at(torch, kernel, q, p, labels, valid, require_faster=True):
    """One fused_infonce kernel ("fwd", "dq" or "dp") on CUDA operands: held
    to the plain version (statistics to STATS_RTOL of the largest |logit|,
    a gradient to GRAD_RTOL_FP32 or GRAD_RTOL_BF16 of its largest |g|),
    timed beside it, beside the dense backend (the library call: one matmul
    and torch's logsumexp, or their autograd) and beside its bound. A fp32
    dQ or dP on the "tf32x3" route is also held to ref.py in float64 (at
    most FP64_ERR_RATIO times the plain version's own error) and timed in
    turns with the "fp32" route it took before (faster in every turn); so
    is a fp32 forward on the "tf32x3" route (its lse against float64, the
    "fp32" route through ``ops.stats_on_path``; faster in every turn only
    with ``require_faster``). These launches are counted: read the path's
    counts before."""
    from repro_torch.core.loss import DenseLossBackend
    from repro_torch.core.precision import NEG_INF
    from repro_torch.kernels._timing import device_ms
    from repro_torch.kernels.fused_infonce import ops, ref

    g = torch.Generator(device=q.device).manual_seed(SEED + 7)
    m = q.shape[0]
    g_lse = torch.rand((m,), generator=g, device=q.device)
    g_pos = -torch.rand((m,), generator=g, device=q.device)
    dense = DenseLossBackend()
    route = ops.path_of(kernel, q.dtype, m, q.shape[1])
    extra = {}
    if kernel == "fwd":
        fn = lambda: ops.fused_infonce_fwd(q, p, labels, valid)            # noqa: E731
        plain = lambda: ref.infonce_stats_ref(q, p, labels, valid)         # noqa: E731
        library = lambda: dense.chunk_stats(q, p, labels, valid, temperature=1.0)  # noqa: E731
        (lse, pos, amax), (rl, rp, ra) = fn(), plain()
        live = rp > NEG_INF / 2
        finite = torch.cat([ra, rp[live]])
        tol = STATS_RTOL * max(1.0, finite.abs().max().item())
        err = max((lse - rl).abs().max().item(), (amax - ra).abs().max().item(),
                  (pos[live] - rp[live]).abs().max().item() if live.any() else 0.0)
        require(err <= tol, f"fused_infonce forward at M={m}: err {err} > {tol}")
        if route == "tf32x3":
            what = f"fused_infonce forward at M={m}, N={p.shape[0]}"
            exact = ref.infonce_stats_ref(q, p, labels, valid, dtype=torch.float64)[0]
            extra.update(fp64_lse_ratio(torch, lse, rl, exact, what))
            del exact
            parent = lambda: ops.stats_on_path("fp32", q, p, labels, valid)   # noqa: E731
            pl, pp, pa = parent()
            extra["parent_max_abs_err"] = max(
                (pl - rl).abs().max().item(), (pa - ra).abs().max().item(),
                (pp[live] - rp[live]).abs().max().item() if live.any() else 0.0)
            require(extra["parent_max_abs_err"] <= tol,
                    f"{what}, fp32 route: err {extra['parent_max_abs_err']} > {tol}")
            extra.update(parent_route="fp32",
                         **grad_turns(torch, fn, parent, 3, what, require_faster))
    else:
        lse = ops.fused_infonce_fwd(q, p, labels, valid)[0]
        args = (q, p, labels, valid, lse, g_lse, g_pos)
        fn = (lambda: ops.fused_infonce_dq(*args)) if kernel == "dq" else (   # noqa: E731
            lambda: ops.fused_infonce_dp(*args))

        def backward_of(stats_fn):
            qf = q.detach().requires_grad_(kernel == "dq")
            pf = p.detach().requires_grad_(kernel == "dp")
            sl, sp, _ = stats_fn(qf, pf)
            wrt = qf if kernel == "dq" else pf
            return lambda: torch.autograd.grad((sl, sp), wrt, (g_lse, g_pos), retain_graph=True)

        plain = backward_of(lambda qf, pf: ref.infonce_stats_ref(qf, pf, labels, valid))
        library = backward_of(
            lambda qf, pf: dense.chunk_stats(qf, pf, labels, valid, temperature=1.0))
        want = ref.infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos)[kernel == "dp"]
        tol_rtol = GRAD_RTOL_BF16 if q.dtype == torch.bfloat16 else GRAD_RTOL_FP32
        got = fn()
        err = close_err(got, want, tol_rtol, f"fused_infonce {kernel} at M={m}")
        if route == "tf32x3":
            i = int(kernel == "dp")
            plain_given = ref.infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos, lse=lse)[i]
            given, own = (ref.infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos,
                                                    dtype=torch.float64, lse=l)[i]
                          for l in (lse, None))
            extra.update(fp64_err_ratio(torch, got, want, own, plain_given, given,
                                        f"fused_infonce {kernel} at M={m}"))
            del plain_given, given, own
            parent = lambda: ops.grad_on_path(kernel, "fp32", *args)   # noqa: E731
            extra["parent_max_abs_err"] = close_err(parent(), want, tol_rtol,
                                                    f"fused_infonce {kernel} at M={m}, fp32 route")
            extra.update(parent_route="fp32", **grad_turns(
                torch, fn, parent, 3, f"fused_infonce {kernel} at M={m}"))
        del got, want
    bound_ms, bound_by = infonce_bound_ms(m, p.shape[0], int(valid.sum().item()), q.shape[1],
                                          q.element_size(), kernel, route)
    return {"M": m, "N": p.shape[0], "d": q.shape[1], "dtype": str(q.dtype).replace("torch.", ""),
            "path": route, "max_abs_err": err,
            "ms": device_ms(fn, 10), "plain_ms": device_ms(plain, 3),
            "library_ms": device_ms(library, 3), "bound_ms": bound_ms, "bound_by": bound_by,
            **extra}


def phase_xdev(torch):
    """Cross-device ContAccum on one rank of a one-rank NCCL group: the
    contaccum_xdev program (sharded banks, all-gathered bank columns), the
    contaccum_xdev_ring program (the ring-streamed loss) and the one-device
    contaccum program on the same config, from one state and the same
    batches, step by step in turns; then the fp32 fused_infonce kernels at
    the path's shapes."""
    import os
    import tempfile
    import types

    import numpy as np
    import torch.distributed as dist

    from repro_torch.common.treemath import tree_leaves, tree_map
    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_XDEV, CONTACCUM_XDEV_RING
    from repro_torch.core import dist as port_dist
    from repro_torch.core.memory_bank import init_bank, shard_push_pair
    from repro_torch.core.methods import build_step_program, init_state
    from repro_torch.core.types import ContrastiveConfig, RetrievalBatch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.kernels.fused_infonce import ops
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.optim import adamw, chain, clip_by_global_norm, linear_warmup_linear_decay
    from repro_torch.optim.adamw import GradientTransformation

    cell = CONTACCUM_XDEV
    require(CONTACCUM_XDEV_RING == {**cell, "loss_comm": "ring"} and "precision" not in cell
            and cell["loss_impl"] == "fused", f"the xdev cells changed: {cell}")
    k, bank, precision = cell["accum_steps"], cell["bank_size"], "fp32"
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    t_setup = time.perf_counter()
    enc = make_bert_dual_encoder(BERT_BASE, precision=precision)
    corpus = SyntheticRetrievalCorpus(
        n_passages=XDEV_CORPUS, vocab_size=BERT_BASE.vocab_size, q_len=cell["q_len"],
        p_len=cell["p_len"], n_hard=cell["n_hard"], seed=SEED,
    )
    loader = ShardedLoader(XDEV_CORPUS, XDEV_RANK_BATCH, seed=SEED)

    def on_card(b):
        return RetrievalBatch(*(torch.from_numpy(np.asarray(b[key], np.int64)).to(dev)
                                for key in ("query", "passage_pos", "passage_hard")))

    batches = [on_card(corpus.batch(loader.next_indices())) for _ in range(XDEV_STEPS)]
    sched = linear_warmup_linear_decay(PEAK_LR, WARMUP_STEPS, XDEV_STEPS + WARMUP_STEPS)

    def config(**kw):
        return ContrastiveConfig(method=cell["method"], accumulation_steps=k, bank_size=bank,
                                 loss_impl=cell["loss_impl"], precision=precision,
                                 temperature=1.0, grad_clip_norm=2.0, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            backend = dist.get_backend()
            cfgs = {"all_gather": config(dp_axis="data", shard_banks=True),
                    "ring": config(dp_axis="data", shard_banks=True, loss_comm="ring"),
                    "one_device": config()}
            params0 = enc.init(torch.Generator().manual_seed(SEED), dev)
            # both banks filled to every slot before step 1: pairs the towers
            # encode from the corpus (its first `bank` queries and passages)
            with torch.no_grad():
                reps = [(enc.encode_query(params0, b.query),
                         enc.encode_passage(params0, b.passage_pos))
                        for b in (on_card(corpus.batch(np.arange(lo, lo + 256)))
                                  for lo in range(0, bank, 256))]
                empty = [init_bank(bank, enc.rep_dim, cfgs["one_device"].resolved_bank_dtype(),
                                   device=dev) for _ in range(2)]
                bank_q, bank_p = shard_push_pair(
                    *empty, torch.cat([r[0] for r in reps]), torch.cat([r[1] for r in reps]),
                    step=0, shard_index=0, num_shards=1)
            del reps, empty
            runs = {}
            for name, cfg in cfgs.items():
                sink = {}
                inner = chain(clip_by_global_norm(cfg.grad_clip_norm), adamw(sched))

                def capture(grads, opt_state, params=None, inner=inner, sink=sink):
                    sink["grads"] = grads
                    return inner.update(grads, opt_state, params)

                tx = GradientTransformation(inner.init, capture)
                state = init_state(None, enc, tx, cfg, params=tree_map(torch.clone, params0),
                                   device=dev)
                require(state.bank_q.buf.shape[0] == bank, f"{name}: bank of "
                        f"{state.bank_q.buf.shape[0]} slots on one rank, not {bank}")
                runs[name] = types.SimpleNamespace(
                    update=build_step_program(enc, tx, cfg).update, sink=sink,
                    state=state._replace(bank_q=bank_q, bank_p=bank_p), metrics=[], times=[],
                    launches=dict.fromkeys(("fwd", "dq", "dp"), 0),
                    paths={kn: dict.fromkeys(ops.PATHS, 0) for kn in ("fwd", "dq", "dp")},
                    collectives=dict.fromkeys(port_dist.KINDS, 0))
            del params0
            setup_s = time.perf_counter() - t_setup

            # every fused_infonce call of the three programs on a CUDA kernel:
            # the plain version is counted, and must not run
            plain_calls = []
            real_ref = (ops.infonce_stats_ref, ops.infonce_stats_vjp_ref)

            def counted(fn):
                def call(*a, **kw):
                    plain_calls.append(fn.__name__)
                    return fn(*a, **kw)
                return call

            ops.infonce_stats_ref, ops.infonce_stats_vjp_ref = (counted(f) for f in real_ref)
            # each forward call's shape and the route it took
            fwd_calls = collections.Counter()
            real_fwd = ops._fwd

            def recorded_fwd(q, p, *a, **kw):
                out = real_fwd(q, p, *a, **kw)
                fwd_calls[(q.shape[0], p.shape[0], q.shape[1], out[1])] += 1
                return out

            ops._fwd = recorded_fwd
            torch.cuda.reset_peak_memory_stats()
            grad_checks = []
            try:
                for step in range(XDEV_STEPS):
                    grads = {}
                    for name, r in runs.items():
                        torch.cuda.synchronize()
                        ops.reset_launches()            # this program's step starts here
                        port_dist.reset_collectives()
                        t0 = time.perf_counter()
                        r.state, m = r.update(r.state, batches[step])
                        torch.cuda.synchronize()
                        r.times.append(time.perf_counter() - t0)
                        for kn in ("fwd", "dq", "dp"):      # read just after the step
                            fn = getattr(ops, f"fused_infonce_{kn}")
                            r.launches[kn] += fn.launches
                            for path, n in fn.paths.items():
                                r.paths[kn][path] += n
                        for kind, n in port_dist.collectives.items():
                            r.collectives[kind] += n
                        r.metrics.append({key: float(v) for key, v in m._asdict().items()})
                        grads[name] = r.sink.pop("grads")
                    # the ring's gradient against the all-gather program's,
                    # leaf by leaf
                    worst = 0.0
                    for i, (ga, gb) in enumerate(zip(tree_leaves(grads["all_gather"]),
                                                     tree_leaves(grads["ring"]))):
                        scale = ga.abs().max().item()
                        diff = (ga - gb).abs().max().item()
                        worst = max(worst, diff / scale if scale else diff)
                        require(diff <= GRAD_RTOL_FP32 * scale,
                                f"step {step}: the ring's gradient leaf {i} is {diff} from "
                                f"the all-gather one (> {GRAD_RTOL_FP32} of {scale})")
                    grad_checks.append(worst)
                    del grads
            finally:
                ops.infonce_stats_ref, ops.infonce_stats_vjp_ref = real_ref
                ops._fwd = real_fwd
            peak_bytes = torch.cuda.max_memory_allocated()
            require(not plain_calls, f"the plain fused_infonce version ran: {plain_calls[:5]}")
            # every forward on path_of's route at its shape, the bank rows' on 3xTF32
            fwd_routes = {f"M={m}, N={n}, d={dd}: {path}": count
                          for (m, n, dd, path), count in sorted(fwd_calls.items())}
            require(all(path == ops.path_of("fwd", torch.float32, m, dd) == "tf32x3"
                        for m, n, dd, path in fwd_calls),
                    f"fused_infonce forwards off the tf32x3 route: {fwd_routes}")
            require(sum(fwd_calls.values()) == sum(r.launches["fwd"] for r in runs.values()),
                    f"forward calls {fwd_routes} against launches "
                    f"{[r.launches['fwd'] for r in runs.values()]}")

            for name, r in runs.items():
                losses = [mm["loss"] for mm in r.metrics]
                require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
                for mm in r.metrics:
                    require(mm["bank_fill_q"] == mm["bank_fill_p"] == bank,
                            f"{name}: bank fill {mm['bank_fill_q']}, {mm['bank_fill_p']}")
                    n_neg = XDEV_RANK_BATCH // k * (1 + cell["n_hard"]) + bank - 1
                    require(mm["n_negatives"] == n_neg,
                            f"{name}: n_negatives {mm['n_negatives']} != {n_neg}")
                for kn in ("fwd", "dq", "dp"):   # the forward, dQ and dP on 3xTF32
                    require(r.launches[kn] > 0, f"{name}: no fused_infonce {kn} launch")
                    require(r.paths[kn]["tf32x3"] == r.launches[kn],
                            f"{name}: fused_infonce {kn} took {r.paths[kn]}, not all tf32x3")
            want = {"all_gather": {"fwd": 2, "dq": 1, "dp": 2},
                    "ring": {"fwd": 3, "dq": 2, "dp": 1},
                    "one_device": {"fwd": 2, "dq": 1, "dp": 2}}
            for name, per_chunk in want.items():
                got = runs[name].launches
                require(got == {kn: n * k * XDEV_STEPS for kn, n in per_chunk.items()},
                        f"{name}: fused_infonce launches {got}, not {per_chunk} a chunk")
            for name in ("all_gather", "ring"):
                c = runs[name].collectives
                require(backend == "nccl" and c["all_gather"] > 0 and c["all_reduce"] > 0,
                        f"{name}: collectives {c} on {backend}, not all-gathers and "
                        f"all-reduces through NCCL")
            require(not any(runs["one_device"].collectives.values()),
                    f"the one-device program ran collectives {runs['one_device'].collectives}")
            parity = {}
            for a, b, field, rtol in (("all_gather", "one_device", "loss", XDEV_LOSS_RTOL),
                                      ("all_gather", "one_device", "grad_norm",
                                       XDEV_GRAD_NORM_RTOL),
                                      ("ring", "all_gather", "loss", XDEV_LOSS_RTOL)):
                pairs = [(ma[field], mb[field])
                         for ma, mb in zip(runs[a].metrics, runs[b].metrics)]
                parity[f"{a}_vs_{b}_{field}"] = pairs
                for step, (va, vb) in enumerate(pairs):
                    require(abs(va - vb) <= rtol * abs(vb),
                            f"step {step}: {a} {field} {va} vs {b} {vb} (rtol {rtol})")
            parity["ring_vs_all_gather_grad_worst_share_of_max"] = grad_checks

            # the fp32 kernels at the path's shapes, on its own operands: a
            # chunk's 32 queries against its 64 in-batch and the bank's 8192
            # columns (all_gather), and the ring's 8224 rows against the bank
            # chunk and the in-batch chunk
            r = runs["all_gather"]
            chunk = batches[0]
            lc = XDEV_RANK_BATCH // k
            with torch.no_grad():
                params = r.state.params
                q_loc = enc.encode_query(params, chunk.query[:lc])
                pp = enc.encode_passage(params, chunk.passage_pos[:lc])
                ph = enc.encode_passage(params, chunk.passage_hard[:lc].reshape(lc, -1))
            bq, bp = r.state.bank_q, r.state.bank_p
            n_a = 2 * lc
            p_all = torch.cat([pp, ph, bp.buf])
            valid = torch.ones((p_all.shape[0],), dtype=torch.bool, device=dev)
            valid[n_a:] = bp.valid
            lab_loc = torch.arange(lc, dtype=torch.int32, device=dev)
            lab_bank = (n_a + torch.arange(bank, device=dev)).to(torch.int32)
            rows = torch.cat([q_loc, bq.buf])
            lab_rows = torch.cat([lab_loc, lab_bank])
            ones = torch.ones((n_a,), dtype=torch.bool, device=dev)
            shapes = {
                "local_rows": (q_loc, p_all, lab_loc, valid, ("fwd", "dq", "dp")),
                "bank_rows": (bq.buf, p_all, lab_bank, valid, ("fwd", "dp")),
                "ring_bank_chunk": (rows, bp.buf, lab_rows - n_a, bp.valid, ("fwd", "dq")),
                "ring_inbatch_chunk": (rows, p_all[:n_a].contiguous(), lab_rows, ones,
                                       ("fwd", "dq", "dp")),
            }
            # the forward at one tile of rows or of columns against the
            # other's 8192 is timed beside the "fp32" route but not held
            # faster there: the CUDA-core kernel reads the long operand once,
            # the 3xTF32 route first splits it into planes (PERF.md)
            one_tile = ("local_rows", "ring_inbatch_chunk")
            kernels = {name: {kn: infonce_at(torch, kn, qq.contiguous(), pq.contiguous(), ll, vv,
                                             require_faster=kn != "fwd" or name not in one_tile)
                              for kn in kns}
                       for name, (qq, pq, ll, vv, kns) in shapes.items()}
        finally:
            dist.destroy_process_group()

    def median_s(times):
        return statistics.median(times[1:] if len(times) > 2 else times)

    return {
        "model": "dpr-bert-base (2 x bert-base-uncased, 12 layers, d 768, seeded init, remat full)",
        "cells": ["contaccum_xdev", "contaccum_xdev_ring"], "backend": backend, "world_size": 1,
        "steps": XDEV_STEPS, "rank_batch": XDEV_RANK_BATCH, "accumulation_steps": k,
        "bank_size": bank, "q_len": cell["q_len"], "p_len": cell["p_len"],
        "n_hard": cell["n_hard"], "precision": precision, "loss_impl": cell["loss_impl"],
        "setup_s": setup_s,
        "median_step_s": {name: median_s(r.times) for name, r in runs.items()},
        "step_s": {name: r.times for name, r in runs.items()},
        "losses": {name: [mm["loss"] for mm in r.metrics] for name, r in runs.items()},
        "grad_norms": {name: [mm["grad_norm"] for mm in r.metrics] for name, r in runs.items()},
        "bank_fill": [runs["ring"].metrics[-1]["bank_fill_q"],
                      runs["ring"].metrics[-1]["bank_fill_p"]],
        "n_negatives": runs["ring"].metrics[-1]["n_negatives"],
        "launches": {name: r.launches for name, r in runs.items()},
        "infonce_paths": {name: r.paths for name, r in runs.items()},
        "infonce_fwd_routes": fwd_routes,
        "collectives": {name: r.collectives for name, r in runs.items()},
        "plain_calls": len(plain_calls), "parity": parity,
        "max_memory_allocated": peak_bytes, "fused_infonce_fp32": kernels,
    }


def phase_shard_serve(torch, topk_ops, topk_ref):
    """(a) The serve_topk cell through the port's sharded index in a
    one-rank NCCL group: the index built by the sharded Retriever, requests
    served through rank 0's server and its broadcast of each batch, one
    batch held against the plain search; (b) the D = 4 layout of eval_topk's
    rows replayed as 4 blocks on the one card through the same _local_topk
    and merge_shard_candidates, held bit for bit to the replicated search."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs.dpr_bert_base import BERT_BASE, EVAL_TOPK, SERVE_TOPK
    from repro_torch.core import dist as port_dist
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.kernels._timing import cuda_ms
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.retrieval import (
        IndexStore,
        Retriever,
        RetrieverConfig,
        make_dp_mesh,
        make_server,
        merge_shard_candidates,
    )

    k, precision = SERVE_TOPK["top_k"], SERVE_TOPK["precision"]
    n_index, d, q_len = SERVE_TOPK["n_passages"], BERT_BASE.d_model, SERVE_TOPK["q_len"]
    max_batch, encode_batch = SERVE_TOPK["n_queries"], 256
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    enc = make_bert_dual_encoder(BERT_BASE, precision=precision)
    params = enc.init(torch.Generator().manual_seed(SEED), dev)
    corpus = SyntheticRetrievalCorpus(
        n_passages=N_ENCODED, vocab_size=BERT_BASE.vocab_size, q_len=q_len, p_len=P_LEN,
        seed=SEED,
    )
    setup_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1,
                                timeout=port_dist.GROUP_TIMEOUT)
        try:
            backend, world = dist.get_backend(), dist.get_world_size()
            retriever = Retriever(
                enc, params,
                RetrieverConfig(top_k=k, search_impl=SEARCH_IMPL, precision=precision,
                                index_layout="sharded", encode_batch=encode_batch),
                device=dev, mesh=make_dp_mesh(world),
            )
            port_dist.reset_collectives()
            t0 = time.perf_counter()
            built = retriever.build_index(corpus.passages)
            built.reps.sum().item()                          # waits for the encode
            index_s = time.perf_counter() - t0
            build_collectives = dict(port_dist.collectives)
            require((built.shard, built.shards, built.rows, built.n_total) ==
                    (0, world, N_ENCODED, N_ENCODED),
                    f"sharded build: shard {built.shard} of {built.shards}, {built.rows} rows")
            require(built.reps.dtype == torch.bfloat16 and bool(torch.isfinite(built.reps).all()),
                    "sharded build: rows not finite bf16")
            # the rest of the cell's rows: seeded rows with the encoded rows'
            # per-dimension mean and spread (the serve phase's), kept as the
            # rank's block
            g = torch.Generator(device=dev).manual_seed(SEED)
            stats = built.reps.float()
            fill = torch.randn((n_index - N_ENCODED, d), generator=g, device=dev)
            fill = fill * stats.std(0) + stats.mean(0)
            store = retriever.index = IndexStore(
                reps=torch.cat([built.reps, fill.to(built.reps.dtype)]),
                row_valid=torch.ones((n_index,), dtype=torch.bool, device=dev),
                n_total=n_index, shards=world, shard=0,
            )
            del stats, fill, built

            server = make_server(retriever, max_batch=max_batch, q_len=q_len).start()
            try:
                server.query(corpus.queries[0])             # warm-up, not counted
                server.batch_sizes.clear()
                topk_ops.reset_launches()                   # the main path's run starts here
                port_dist.reset_collectives()
                lat = [0.0] * N_REQUESTS
                answers = [None] * N_REQUESTS

                def one(j):
                    t = time.perf_counter()
                    answers[j] = server.query(corpus.queries[j % N_ENCODED], timeout=120)
                    lat[j] = time.perf_counter() - t

                t0 = time.perf_counter()
                with ThreadPoolExecutor(max_workers=CLIENTS) as pool:
                    list(pool.map(one, range(N_REQUESTS)))
                wall = time.perf_counter() - t0
                launches = topk_ops.fused_topk.launches     # read just after the run
                paths = dict(topk_ops.fused_topk.paths)
                served = dict(port_dist.collectives)
                batches = list(server.batch_sizes)
            finally:
                server.stop()
            stopped = dict(port_dist.collectives)
            require(not server._thread.is_alive(), "server thread did not stop")
            nb = len(batches)
            require(nb > 0, "no coalesced batch was served")
            require(launches == nb and paths["hopper"] == nb,
                    f"fused_topk launched {launches} times ({paths}) for {nb} batches, not "
                    f"once each on the Hopper path")
            require(build_collectives == dict.fromkeys(port_dist.KINDS, 0),
                    f"the sharded build ran collectives: {build_collectives}")
            require(served == {**dict.fromkeys(port_dist.KINDS, 0), "broadcast": nb,
                               "all_gather": 2 * nb},
                    f"collectives {served} for {nb} batches: not one broadcast and two "
                    f"all-gathers (scores, ids) each")
            require(stopped["broadcast"] == nb + 1, f"the stop word: {stopped}")
            for ids, scores in answers:
                require(ids.shape == (k,) and scores.shape == (k,), "answer shape")
                require(bool((ids >= 0).all() and (ids < n_index).all()), "answer id out of range")
                require(bool((scores[:-1] >= scores[1:]).all()), "answer scores not sorted")

            # one coalesced batch of answers against the plain search on the same reps
            tokens = corpus.queries[:max_batch]
            q_reps = retriever.encode_queries(tokens)
            rs, ri = topk_ref.topk_scores_ref(q_reps, store.reps, k + 1,
                                              col_valid=store.row_valid)
            s = torch.as_tensor(np.stack([answers[j][1] for j in range(max_batch)]), device=dev)
            i = torch.as_tensor(np.stack([answers[j][0] for j in range(max_batch)]), device=dev)
            tol = SCORE_RTOL * max(1.0, rs[:, 0].abs().max().item())
            err, clear = check_topk(topk_ref, s, i, rs, ri, tol, "sharded served batch vs plain")
            del rs, ri
            search_ms = cuda_ms(lambda: retriever.search_reps_tensors(q_reps), 10)

            # (b) the D = 4 layout of eval_topk's rows, one block at a time
            n_eval, shards = EVAL_TOPK["n_passages"] - 37, SHARD_REPLAY_SHARDS
            rows = -(-n_eval // shards) * shards
            padded = store.reps[:rows].clone()
            padded[n_eval:] = 0
            whole = IndexStore(reps=padded,
                               row_valid=torch.arange(rows, device=dev) < n_eval,
                               n_total=n_eval, shards=shards)
            blocks = [whole.block(r) for r in range(shards)]
            replicated = IndexStore(reps=padded[:n_eval],
                                    row_valid=torch.ones((n_eval,), dtype=torch.bool, device=dev),
                                    n_total=n_eval)
            topk_ops.reset_launches()
            cands = [retriever._local_topk(q_reps, b) for b in blocks]
            m_s, m_i = merge_shard_candidates(torch.stack([c[0] for c in cands]),
                                              torch.stack([c[1] for c in cands]), k)
            r_s, r_i = retriever._local_topk(q_reps, replicated)
            require(topk_ops.fused_topk.paths["hopper"] == shards + 1,
                    f"replay: fused_topk took {topk_ops.fused_topk.paths}")
            id_diff = int((m_i != r_i).sum().item())
            score_diff = int((m_s != r_s).sum().item())
            require(id_diff == 0 and score_diff == 0,
                    f"the 4-block replay differs from the replicated search: {id_diff} ids, "
                    f"{score_diff} scores (max {(m_s - r_s).abs().max().item()})")
            require(bool((r_i >= 0).all()) and bool((r_i < n_eval).all()), "replay ids")
            replay = {
                "N": n_eval, "shards": shards, "rows": whole.rows,
                "rows_per_shard": whole.rows_per_shard,
                "padding_rows": int((~whole.row_valid).sum().item()),
                "ids_differing": id_diff, "scores_differing": score_diff,
                "ids_from_each_block": [int(((m_i >= b.row_offset)
                                             & (m_i < b.row_offset + whole.rows_per_shard))
                                            .sum().item()) for b in blocks],
                "block_ms": [cuda_ms(lambda b=b: retriever._local_topk(q_reps, b), 10)
                             for b in blocks],
                "merge_ms": cuda_ms(lambda: merge_shard_candidates(
                    torch.stack([c[0] for c in cands]), torch.stack([c[1] for c in cands]), k),
                    10),
                "replicated_ms": cuda_ms(lambda: retriever._local_topk(q_reps, replicated), 10),
            }
            del padded, whole, blocks, replicated
        finally:
            dist.destroy_process_group()
    ms = sorted(x * 1e3 for x in lat)
    return {
        "model": "dpr-bert-base (2 x bert-base-uncased, 12 layers, d 768, seeded init)",
        "cell": "serve_topk", "backend": backend, "world_size": world,
        "precision": precision, "search_impl": SEARCH_IMPL, "top_k": k,
        "index_rows": store.rows, "encoded_rows": N_ENCODED,
        "rows_per_shard": store.rows_per_shard, "bytes_per_device": store.bytes_per_device(),
        "setup_s": setup_s, "index_build_s": index_s, "build_collectives": build_collectives,
        "requests": N_REQUESTS, "clients": CLIENTS, "qps": N_REQUESTS / wall,
        "p50_ms": statistics.median(ms), "p99_ms": ms[int(0.99 * (len(ms) - 1))],
        "batches": nb, "mean_batch": sum(batches) / nb, "collectives": served,
        "collectives_after_stop": stopped, "fused_topk_launches": launches,
        "fused_topk_paths": paths, "batch_max_abs_err": err, "batch_tolerance": tol,
        "batch_clear_slots": clear, "batch_slots": i.numel(),
        "sharded_search_ms_one_batch": search_ms, "replay": replay,
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--serve-turns", action="store_true",
                    help="only build, then serve with plain and flash towers in turns "
                         f"(plain, flash, flash, plain, ...), {SERVE_TURN_PAIRS} runs of each")
    ap.add_argument("--xdev", action="store_true",
                    help="only build, then run the xdev phase (cross-device ContAccum in a "
                         "one-rank NCCL group)")
    ap.add_argument("--shard-serve", action="store_true",
                    help="only build, then run the shard_serve phase (the sharded index "
                         "in a one-rank NCCL group and a 4-block replay)")
    args = ap.parse_args(argv)
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke.py runs from a checkout of the repo: src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_topk import ops, ref
    from repro_torch.kernels._timing import card

    smi = card()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    logs = _build.build(["fused_topk", "fused_infonce", "flash_attention", "embedding_bag"])
    for name, text in logs.items():
        print(f"[{name}] {text}", file=sys.stderr)
    flash_ptxas = flash_instantiations(torch, logs["flash_attention"])
    topk_ptxas = topk_instantiations(logs["fused_topk"])
    infonce_ptxas = infonce_instantiations(logs["fused_infonce"])
    require(all(e["spill_store_bytes"] == e["spill_load_bytes"] == e["local_bytes"] == 0
                for e in flash_ptxas if e["name"] != "flash_fwd_kernel_fp32"),
            f"a bf16 flash_attention kernel spills: {flash_ptxas}")
    emit({"phase": "build", "kernels": sorted(logs), "seconds": time.perf_counter() - t0})
    if args.serve_turns:
        serve_turns(torch, ops, ref, SERVE_TURN_PAIRS)
        print(card(), flush=True)
        return 0
    if args.xdev:
        t0 = time.perf_counter()
        xdev = phase_xdev(torch)
        emit({"phase": "xdev", **xdev, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
        print(card(), flush=True)
        return 0
    if args.shard_serve:
        t0 = time.perf_counter()
        shard_serve = phase_shard_serve(torch, ops, ref)
        emit({"phase": "shard_serve", **shard_serve, "seconds": time.perf_counter() - t0,
              "nvidia_smi": smi})
        print(card(), flush=True)
        return 0

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, ops, ref)
    infonce = phase_infonce_kernels(torch)
    flash_k = phase_flash_kernels(torch)
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    bag_ops.embedding_bag.launches = 0
    bag = phase_embedding_bag_kernels(torch)
    bag_launches = bag_ops.embedding_bag.launches
    emit({"phase": "kernels", "fused_topk": kernels, "fused_infonce": infonce,
          "flash_attention": flash_k, "flash_attention_ptxas": flash_ptxas,
          "fused_topk_ptxas": topk_ptxas, "fused_infonce_ptxas": infonce_ptxas,
          "embedding_bag": bag,
          "embedding_bag_launches": bag_launches, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    from repro_torch.configs.dpr_bert_base import BERT_BASE
    from repro_torch.kernels.flash_attention import ops as flash_ops

    t0 = time.perf_counter()
    serve = phase_serve(torch, ref, BERT_BASE, [("fused_topk", ops.fused_topk, 0, 1),
                                                ("flash_attention", flash_ops.flash_attention, 0, 0)])
    require(serve["paths"]["fused_topk"]["hopper"] == serve["launches"]["fused_topk"],
            f"served batches took {serve['paths']['fused_topk']}, not all the Hopper kernel")
    emit({"phase": "serve", **serve, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    train, banks = phase_train(torch, ops)
    emit({"phase": "train", **train, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    mine = phase_mine(torch, ref, banks)
    del banks
    emit({"phase": "mine", **mine, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    flash = phase_flash(torch, ops, ref)
    emit({"phase": "flash", **flash, "serve_vs_plain": serve_pair(serve, flash["serve"]),
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    lm = phase_lm(torch, ops)
    emit({"phase": "lm", **lm, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    lm_train = phase_lm_train(torch)
    emit({"phase": "lm_train", **lm_train, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    lm_serve = phase_lm_serve(torch)
    emit({"phase": "lm_serve", **lm_serve, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    moe_serve = phase_moe_serve(torch)
    emit({"phase": "moe_serve", **moe_serve, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    moe_train = phase_moe_train(torch)
    emit({"phase": "moe_train", **moe_train, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    recsys = phase_recsys(torch)
    emit({"phase": "recsys", **recsys, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    xdev = phase_xdev(torch)
    emit({"phase": "xdev", **xdev, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    shard_serve = phase_shard_serve(torch, ops, ref)
    emit({"phase": "shard_serve", **shard_serve, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    ev = kernels["eval_topk"]
    topk_by_path = {"serve": serve["launches"]["fused_topk"],
                    "eval": train["eval_fused_topk_launches"], "mine": mine["fused_topk_launches"],
                    "lm_eval": lm["eval_fused_topk_launches"],
                    "shard_serve": shard_serve["fused_topk_launches"]}
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    ms = mine["search"]
    lines = [{
        "name": "fused_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/fused_topk.py:47",
        "launches": sum(topk_by_path.values()), "launches_by_path": topk_by_path,
        "max_abs_err": ev["max_abs_err"],
        "ms": ev["ms"], "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "library_ms": ev["library_ms"],
        "shape": f"eval_topk: Q={ev['Q']}, N={ev['N']}, d={ev['d']}, k={ev['k']}, bf16",
        "mine_shape": {key: ms[key] for key in ("Q", "N", "d", "k", *timed)},
        "lm_eval_shape": {key: kernels["lm_eval"][key] for key in (
            "Q", "N", "d", "k", "path", "parent_route", "parent_ms", *timed)},
    }]
    # each fused_infonce kernel at its largest shape on the train path (dQ
    # runs only for the local queries); the phase line has both shapes
    source = "src/repro_torch/kernels/fused_infonce/csrc/fused_infonce.cu"
    tpu = "src/repro/kernels/fused_infonce/fused_infonce.py"
    from repro_torch.kernels.fused_infonce import ops as infonce_ops

    xdev_fwd_kernels = ("infonce_tf32x3_fwd_kernel", "infonce_stats_merge_kernel")

    for kernel, line, shape, err in (("fwd", 54, "bank_rows", "stats_max_abs_err"),
                                     ("dq", 205, "local_rows", "dq_max_abs_err"),
                                     ("dp", 229, "bank_rows", "dp_max_abs_err")):
        t = infonce[shape][kernel]
        by_path = {"train": train["launches"][kernel], "mine": mine["infonce_launches"][kernel],
                   "lm": lm["infonce_launches"][kernel],
                   "xdev": sum(n[kernel] for n in xdev["launches"].values())}
        lm_shapes = {"lm_shape": infonce["lm_" + shape]}
        if kernel != "dq":   # the split kernels at the LM retriever's local rows
            lm_shapes["lm_local_rows_shape"] = infonce["lm_local_rows"]
        lines.append({
            "name": f"fused_infonce_{kernel}", "route": "cuda", "source": source,
            "replaces": f"{tpu}:{line}", "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "cuda_kernels": [k for k in infonce_ops.HOPPER_KERNELS
                             if f"_{kernel}_" in k or f"<{kernel}>" in k
                             or (kernel == "fwd" and "merge" in k)
                             or (kernel == "dq" and "reduce" in k)],
            "max_abs_err": infonce[shape][err], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": f"M={infonce[shape]['M']}, "
            f"N={infonce[shape]['N']}, d={infonce[shape]['d']}, {infonce[shape]['dtype']}",
            **{name: {"M": sh["M"], "N": sh["N"], "d": sh["d"], "path": sh["paths"][kernel],
                      "max_abs_err": sh[err], **{key: sh[kernel][key] for key in timed[1:]},
                      **{key: sh[kernel][key] for key in ("parent_route", "parent_ms")
                         if key in sh[kernel]}}
               for name, sh in lm_shapes.items()},
            # the fp32 kernels on the xdev path (one rank of contaccum_xdev):
            # the all-gather program's largest shape, then each other shape
            # of the path that runs the kernel (the local rows, the ring's
            # bank and in-batch chunks)
            "xdev_shape": xdev["fused_infonce_fp32"][shape][kernel],
            **{f"xdev_{name}_shape": sh[kernel] for name, sh in xdev["fused_infonce_fp32"].items()
               if kernel in sh and name != shape},
            "xdev_cuda_kernels": [k for k in infonce_ops.TF32X3_KERNELS if "split" in k
                                  or (k in xdev_fwd_kernels) == (kernel == "fwd")],
        })
    # flash_attention at the BERT passage pass (the phase line has every shape)
    fa = flash_k["bert_passage"]
    flash_by_path = {"flash_train": flash["train"]["flash_attention_launches"],
                     "lm": lm["flash_attention_launches"],
                     "lm_train": lm_train["flash_attention_launches"],
                     "lm_serve": lm_serve["flash_attention_launches"],
                     "moe_serve": moe_serve["flash_attention_launches"],
                     "moe_train": moe_train["flash_attention_launches"]}
    lines.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
        "launches": sum(flash_by_path.values()), "launches_by_path": flash_by_path,
        "max_abs_err": fa["max_abs_err"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "shape": f"B={fa['B']}, S={fa['Sq']}, H={fa['H']}, D={fa['D']}, bf16, key mask",
        **{f"{name}_shape": {"B": flash_k[name]["B"], "S": flash_k[name]["Sq"],
                             "H": flash_k[name]["H"], "Hk": flash_k[name]["Hk"],
                             "D": flash_k[name]["D"], "causal": True,
                             "tiles": flash_k[name]["tiles"],
                             **{key: flash_k[name][key] for key in timed}}
           for name in FLASH_LM_PATH_SHAPES},
        **{f"{name}_shape": {key: phase["flash_attention_s32768"][key] for key in (
            "B", "S", "H", "Hk", "D", "causal", "tiles", "plain_not_run", *timed)}
           for name, phase in (("lm_serve", lm_serve), ("moe_serve", moe_serve))},
    })
    # embedding_bag at the dcn-v2 stacked table; no path of the port calls it
    # (the recsys models gather, as in JAX), so its launches are the kernels
    # phase's
    eb = bag["dcn_v2"]
    lines.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:25",
        "launches": bag_launches, "max_abs_err": eb["max_abs_err"], "ms": eb["ms"],
        "plain_ms": eb["plain_ms"], "bound_ms": eb["bound_ms"], "bound_by": eb["bound_by"],
        "library_ms": eb["library_ms"],
        "shape": f"dcn-v2 stacked table {eb['V']} x {eb['D']} fp32, {eb['bags']} bags, "
                 f"L={eb['lookups']}",
    })
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
