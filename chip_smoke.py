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
               and k = 129, 256 and 1000 at both shapes (the row states
               of k > 128 in global memory) plus a k > n_valid case there;
               the fused_infonce forward, dQ and dP kernels at the two
               shapes of a contaccum_bf16 chunk (M=8 local queries with
               some labels out of range, and M=2048 query-bank rows, against
               N=2064 columns of which the last 1000 are masked; d=768,
               bf16), an fp32 case and a small ragged case; kernel, plain,
               library and bound times, forward and backward apart; the
               flash_attention kernel at the BERT query and passage passes
               (B=8, S=32 and 256, H=12, D=64, bf16, ragged key masks, q, k
               and v the strided splits of one fused qkv tensor), a row with
               every key masked, an fp32 case, and the LM prefill shapes no
               path runs yet (internlm2-1.8b: S=4096, H=16, Hk=8, D=128;
               stablelm-3b: S=2048, H=Hk=32, D=80; causal, bf16); kernel,
               plain, library (scaled_dot_product_attention) and bound times;
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
               equal the number of coalesced batches; every answer is
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
               16 x steps (forward, dQ, dP), one step on the dense backend
               against the fused one from the same state and batch, a second
               Trainer resuming from the saved step, and a Top@k eval through
               the fused search kernel.
  6. flash   - the same towers with attention_impl="pallas" (the attention
               of every layer through the flash_attention kernel): their
               passage reps are held against the plain-attention towers on
               the same params, the serve phase runs again on them (12
               launches per encode batch and per coalesced batch, none on
               the plain towers' run); then contaccum_bf16 trains for
               FLASH_TRAIN_STEPS steps (finite losses, exactly 16 chunks x 3
               tower passes x 12 layers x 2 (remat) launches a step), and
               one step with flash towers is held against plain towers from
               the same state and batch.
  7. recsys  - the recsys_train program of launch/steps.py for dcn-v2 at
               its train_batch cell (B=65536, every published width), with
               each field's vocabulary capped at RECSYS_ROW_CAP rows, for
               RECSYS_STEPS steps on ClickLogGenerator batches: step time,
               the host's share (batch generation), peak memory and the
               losses; checks finite losses, table rows no batch indexed
               bit-identical at the end and every indexed row moved, and
               one step at a small cap on the card against the CPU.
Then the kernels line, the nvidia-smi line, and the final
{"ok": true, "device": {...}} line. Any failed check raises and the script
exits non-zero before the final line. Without a CUDA device, or without the
repo's ``src/repro_torch`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"

# H100 SXM data sheet (dense): bf16 tensor-core peak, fp32 peak outside the
# tensor cores, and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
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
N_BANK_MASKED = 1000

# the train phase: steps (16 x 8 = 128 pushes a step wrap the 2048-slot
# banks after 16), the corpus it draws from (and evaluates on), the paper's
# peak learning rate (Appendix B) with a short warmup for a short run
TRAIN_STEPS = 20
N_CORPUS = 4096
PEAK_LR = 2e-5
WARMUP_STEPS = 2
CHECKPOINT_EVERY = 10
# the dense and the fused backends on one step from the same state and
# batch: loss to 1e-3 relative (both sum exact bf16 products in fp32; the
# towers are the same ops); gradient global norm to 2e-2 relative (the fused
# backward rounds the softmax coefficients to bf16, the dense one keeps fp32)
PARITY_LOSS_RTOL = 1e-3
# about 40 ms of sleep at the H100's clock, longer than the host takes to
# queue the timed calls of one fused_infonce measurement
SLEEP_CYCLES = 70_000_000
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
# prefill shapes of the LM configs (src/repro/configs/internlm2_1p8b.py,
# stablelm_3b.py) that no path of the port runs yet: (B, S, H, Hk, D), causal
FLASH_LM_SHAPES = {"internlm2_prefill": (1, 4096, 16, 8, 128),
                   "stablelm_prefill": (1, 2048, 32, 32, 80)}
FLASH_TRAIN_STEPS = 5
# passages whose reps are held against the plain-attention towers
FLASH_PARITY_PASSAGES = 256

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up:
    the calls are queued behind a sleep kernel on the stream, so the events
    bracket the device's work and not the host's time to enqueue it (a call
    of a small kernel costs the host more than the device)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
            s, i = ops.fused_topk(q, p, kk, col_valid=valid)
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

    # eval_topk shape, ragged N, masked columns
    n_q, n = EVAL_TOPK["n_queries"], EVAL_TOPK["n_passages"] - 37
    q = torch.randn((n_q, d), generator=g, device=dev).to(torch.bfloat16)
    p = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand((n,), generator=g, device=dev) > 0.01
    s, i = ops.fused_topk(q, p, k, col_valid=valid)
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
        "ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    del rs, ri
    result["eval_topk_large_k"] = large_k("eval shape", q, p, valid, n_valid)

    # serve_topk shape: one coalesced batch against 2^20 rows
    n_q, n = SERVE_TOPK["n_queries"], SERVE_TOPK["n_passages"]
    q = torch.randn((n_q, d), generator=g, device=dev).to(torch.bfloat16)
    p = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    s, i = ops.fused_topk(q, p, k)
    rs, ri = ref.topk_scores_ref(q, p, k + 1)
    tol = SCORE_RTOL * rs[:, 0].abs().max().item()
    err, clear = check_topk(ref, s, i, rs, ri, tol, "serve shape")
    bound_ms, bound_by = topk_bound_ms(n_q, n, n, d, k, 2)
    result["serve_topk"] = {
        "Q": n_q, "N": n, "d": d, "k": k, "dtype": "bf16", "max_abs_err": err,
        "tolerance": tol, "clear_slots": clear, "slots": i.numel(),
        "ms": cuda_ms(lambda: ops.fused_topk(q, p, k), 10),
        "plain_ms": cuda_ms(lambda: ref.topk_scores_ref(q, p, k), 2),
        "library_ms": cuda_ms(lambda: library_topk(q, p, k), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    result["serve_topk_large_k"] = large_k("serve shape", q, p, None, n)
    del q, p, valid

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

    def read():
        return {name: wrapper.launches for name, wrapper, _, _ in counters}

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
        "launches": launches, "batch_max_abs_err": err, "batch_tolerance": tol,
        "batch_clear_slots": clear, "batch_slots": i.numel(),
        "batch_hits_in_encoded_rows": encoded_hits,
        "fused_search_ms_one_batch": search_ms, "encode_ms_one_batch": encode_ms,
    }


def infonce_bound_ms(m: int, n: int, n_valid: int, d: int, itemsize: int, kernel: str):
    """(bound_ms, bound_by) of one fused_infonce kernel: inputs read once
    (q, p, labels, col_valid; the backward also lse, g_lse, g_pos) and
    outputs written once, over HBM bandwidth; the products over the valid
    columns over the bf16 peak: 2*M*N_valid*d for the forward, 4*M*N_valid*d
    for dQ or dP (the scores again, then the product)."""
    moved = (m + n) * d * itemsize + 4 * m + n
    if kernel == "fwd":
        moved += 3 * 4 * m
        ops = 2.0 * m * n_valid * d
    else:
        moved += 3 * 4 * m + (m if kernel == "dq" else n) * d * itemsize
        ops = 4.0 * m * n_valid * d
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def close_err(x, ref, rtol_of_max, what):
    """Max abs error of x against ref; raises above rtol_of_max of the
    largest |ref|."""
    x, ref = x.float(), ref.float()
    tol = rtol_of_max * ref.abs().max().item()
    err = (x - ref).abs().max().item()
    require(err <= tol, f"{what}: max abs err {err} > {tol}")
    return err


def phase_infonce_kernels(torch):
    """fused_infonce forward, dQ and dP against the plain version and
    against the dense backend (the yardstick), at the path shapes and at an
    fp32 and a small ragged case."""
    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16
    from repro_torch.core.loss import DenseLossBackend
    from repro_torch.core.precision import NEG_INF
    from repro_torch.kernels.fused_infonce import ops, ref

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    d = BERT_BASE.d_model
    local = CONTACCUM_BF16["global_batch"] // CONTACCUM_BF16["accum_steps"]     # 8
    bank = CONTACCUM_BF16["bank_size"]                                          # 2048
    n_path = local * (1 + CONTACCUM_BF16["n_hard"]) + bank                       # 2064
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

    def check(name, q, p, labels, valid, g_lse, g_pos, timed):
        lse, pos, amax = ops.fused_infonce_fwd(q, p, labels, valid)
        dq = ops.fused_infonce_dq(q, p, labels, valid, lse, g_lse, g_pos)
        dp = ops.fused_infonce_dp(q, p, labels, valid, lse, g_lse, g_pos)
        torch.cuda.synchronize()
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
        stats_err = max((lse - rl).abs().max().item(), (amax - ra).abs().max().item(),
                        (pos[live] - rp[live]).abs().max().item())
        require(bool(torch.isfinite(lse).all()), f"{name}: non-finite lse")
        require(stats_err <= stats_tol, f"{name}: lse/pos/amax err {stats_err} > {stats_tol}")
        grad_rtol = GRAD_RTOL_BF16 if q.dtype == torch.bfloat16 else GRAD_RTOL_FP32
        out = {"M": q.shape[0], "N": p.shape[0], "n_valid": int(valid.sum().item()),
               "d": q.shape[1], "dtype": str(q.dtype).replace("torch.", ""),
               "stats_max_abs_err": stats_err, "stats_tolerance": stats_tol,
               "dq_max_abs_err": close_err(dq, rdq, grad_rtol, f"{name} dq"),
               "dp_max_abs_err": close_err(dp, rdp, grad_rtol, f"{name} dp"),
               "grad_rtol_of_max": grad_rtol}
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
    result["fp32"] = check("fp32", *case(64, 1000, d, torch.float32, 100,
                                         torch.randint(0, 900, (64,), generator=g, device=dev)),
                           timed=False)
    result["ragged"] = check("ragged", *case(37, 301, 96, torch.bfloat16, 50,
                                             torch.randint(0, 251, (37,), generator=g, device=dev)),
                             timed=False)
    return result


def contaccum_setup(torch, bert_cfg, total_steps):
    """The contaccum_bf16 cell on towers of ``bert_cfg``, seeded: encoder,
    contrastive config, optimizer (warmup, then linear decay to 0 at
    ``total_steps``), update, initial state, corpus, loader and the batch
    function a Trainer draws from."""
    import types

    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, CONTACCUM_BF16
    from repro_torch.core.methods import build_step_program, init_state
    from repro_torch.core.types import ContrastiveConfig, RetrievalBatch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.optim import adamw, chain, clip_by_global_norm, linear_warmup_linear_decay

    cell = CONTACCUM_BF16
    enc = make_bert_dual_encoder(bert_cfg, precision=cell["precision"])
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
        state=init_state(torch.Generator().manual_seed(SEED), enc, tx, cfg, device=DEVICE),
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
        want = {"fwd": 2 * k * TRAIN_STEPS, "dq": k * TRAIN_STEPS, "dp": 2 * k * TRAIN_STEPS}
        require(launches == want, f"fused_infonce launches {launches} != {want}")

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
        share = profile_step_share(torch, update, state, parity_batch)

        # a second Trainer on the same directory resumes from the saved step
        resumed = Trainer(dataclasses.replace(tcfg, total_steps=TRAIN_STEPS + 1), update,
                          next_batch, loader_state=type(loader.state)())
        _, report2 = resumed.run(state)
        require(report2.steps_run == 1 and report2.history[0]["step"] == TRAIN_STEPS,
                f"resume ran steps {[h['step'] for h in report2.history]}")
        require(np.isfinite(report2.history[0]["loss"]), "resumed step loss not finite")

    # Top@k eval through the fused search kernel
    topk_ops.fused_topk.launches = 0
    t0 = time.perf_counter()
    recalls = evaluate_topk(
        enc, state.params, corpus, ks=(1, 5, 20),
        cfg=RetrieverConfig(top_k=20, search_impl="fused", precision=cell["precision"]),
        device=DEVICE,
    )
    eval_s = time.perf_counter() - t0
    eval_launches = topk_ops.fused_topk.launches
    require(eval_launches > 0, "evaluate_topk did not launch fused_topk")
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
        "n_negatives": last["n_negatives"], "launches": launches,
        "dense_vs_fused": parity, "infonce_share": share,
        "resumed_from_step": report2.history[0]["step"] - 1,
        "eval": recalls, "eval_s": eval_s, "eval_fused_topk_launches": eval_launches,
    }


def profile_step_share(torch, update, state, batch):
    """One step under torch.profiler: its wall time, the device time of its
    kernels (busy share = device / wall), the part in the fused_infonce
    kernels, and the kernels that take the most device time. The device
    fields are None where the profile shows no kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    update(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(ms for _, ms, _ in kernels)
    if kernel_ms <= 0:
        return {"step_wall_ms": wall_ms, "device_ms": None, "infonce_ms": None,
                "share_of_device": None, "busy_share": None, "flash_ms": None,
                "top_kernels": []}
    infonce_ms = sum(ms for key, ms, _ in kernels if "infonce" in key)
    flash_ms = sum(ms for key, ms, _ in kernels if "flash_fwd_kernel" in key)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"step_wall_ms": wall_ms, "device_ms": kernel_ms, "infonce_ms": infonce_ms,
            "share_of_device": infonce_ms / kernel_ms, "busy_share": kernel_ms / wall_ms,
            "flash_ms": flash_ms, "flash_launches": sum(c for key, _, c in kernels
                                                        if "flash_fwd_kernel" in key),
            "kernel_launches": sum(c for _, _, c in kernels),
            "top_kernels": [{"name": key[:80], "ms": ms, "count": c} for key, ms, c in top]}


def flash_bound_ms(b, sq, skv, h, hk, d, causal, masked, itemsize):
    """(bound_ms, bound_by) of one flash_attention call: q, k, v and the key
    mask read once and o written once, over HBM bandwidth; the two products
    (4*B*H*Sq*Skv*D, half of it under a causal mask) over the bf16 tensor
    peak, or the fp32 peak outside the tensor cores for fp32 inputs."""
    moved = (2 * b * sq * h + 2 * b * skv * hk) * d * itemsize + (b * skv if masked else 0)
    ops = 4.0 * b * h * sq * skv * d * (0.5 if causal else 1.0)
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
        res.update({
            "ms": device_ms(lambda: ops.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask), 20),
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
    for name, (bb, s, hq, hk, d) in FLASH_LM_SHAPES.items():
        q = rand((bb, s, hq, d), bf16)
        k, v = rand((bb, s, hk, d), bf16), rand((bb, s, hk, d), bf16)
        result[name] = check(name, q, k, v, causal=True)
    return result


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
    share = profile_step_share(torch, update, state, parity_batch)
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
    profile = profile_step_share(torch, lambda s, batch: prog.fn(s, *batch), state,
                                 (dense, sparse, labels))
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


def main() -> int:
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

    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    logs = _build.build(["fused_topk", "fused_infonce", "flash_attention", "embedding_bag"])
    for name, text in logs.items():
        print(f"[{name}] {text}", file=sys.stderr)
    emit({"phase": "build", "kernels": sorted(logs), "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, ops, ref)
    infonce = phase_infonce_kernels(torch)
    flash_k = phase_flash_kernels(torch)
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    bag_ops.embedding_bag.launches = 0
    bag = phase_embedding_bag_kernels(torch)
    bag_launches = bag_ops.embedding_bag.launches
    emit({"phase": "kernels", "fused_topk": kernels, "fused_infonce": infonce,
          "flash_attention": flash_k, "embedding_bag": bag,
          "embedding_bag_launches": bag_launches, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})

    from repro_torch.configs.dpr_bert_base import BERT_BASE
    from repro_torch.kernels.flash_attention import ops as flash_ops

    t0 = time.perf_counter()
    serve = phase_serve(torch, ref, BERT_BASE, [("fused_topk", ops.fused_topk, 0, 1),
                                                ("flash_attention", flash_ops.flash_attention, 0, 0)])
    emit({"phase": "serve", **serve, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    train = phase_train(torch, ops)
    emit({"phase": "train", **train, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    flash = phase_flash(torch, ops, ref)
    emit({"phase": "flash", **flash, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    t0 = time.perf_counter()
    recsys = phase_recsys(torch)
    emit({"phase": "recsys", **recsys, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    ev = kernels["eval_topk"]
    lines = [{
        "name": "fused_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/fused_topk.py:47",
        "launches": serve["launches"]["fused_topk"], "max_abs_err": ev["max_abs_err"],
        "ms": ev["ms"], "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "library_ms": ev["library_ms"],
    }]
    # each fused_infonce kernel at its largest shape on the train path (dQ
    # runs only for the local queries); the phase line has both shapes
    source = "src/repro_torch/kernels/fused_infonce/csrc/fused_infonce.cu"
    tpu = "src/repro/kernels/fused_infonce/fused_infonce.py"
    for kernel, line, shape, err in (("fwd", 54, "bank_rows", "stats_max_abs_err"),
                                     ("dq", 205, "local_rows", "dq_max_abs_err"),
                                     ("dp", 229, "bank_rows", "dp_max_abs_err")):
        t = infonce[shape][kernel]
        lines.append({
            "name": f"fused_infonce_{kernel}", "route": "cuda", "source": source,
            "replaces": f"{tpu}:{line}", "launches": train["launches"][kernel],
            "max_abs_err": infonce[shape][err], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": f"M={infonce[shape]['M']}, "
            f"N={infonce[shape]['N']}, d={infonce[shape]['d']}, {infonce[shape]['dtype']}",
        })
    # flash_attention at the BERT passage pass (the phase line has every shape)
    fa = flash_k["bert_passage"]
    lines.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
        "launches": flash["train"]["flash_attention_launches"],
        "max_abs_err": fa["max_abs_err"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "shape": f"B={fa['B']}, S={fa['Sq']}, H={fa['H']}, D={fa['D']}, bf16, key mask",
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
