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
               shape (Q=32, N=2^20), plus a tie case and a k > n_valid case;
               kernel, plain, library and bound times.
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
Then the kernels line, the nvidia-smi line, and the final
{"ok": true, "device": {...}} line. Any failed check raises and the script
exits non-zero before the final line. Without a CUDA device, or without the
repo's ``src/repro_torch`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"

# H100 SXM data sheet (dense): bf16 tensor-core peak and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
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
    return result


def phase_serve(torch, ops, ref):
    import numpy as np

    from repro_torch.configs.dpr_bert_base import BERT_BASE, SERVE_TOPK
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.models.towers import make_bert_dual_encoder
    from repro_torch.retrieval import IndexStore, Retriever, RetrieverConfig, make_server

    k, precision = SERVE_TOPK["top_k"], SERVE_TOPK["precision"]
    n_index, d = SERVE_TOPK["n_passages"], BERT_BASE.d_model
    t0 = time.perf_counter()
    enc = make_bert_dual_encoder(BERT_BASE, precision=precision)
    params = enc.init(torch.Generator().manual_seed(SEED), DEVICE)
    retriever = Retriever(
        enc, params,
        RetrieverConfig(top_k=k, search_impl=SEARCH_IMPL, precision=precision,
                        encode_batch=256),
        device=DEVICE,
    )
    corpus = SyntheticRetrievalCorpus(
        n_passages=N_ENCODED, vocab_size=BERT_BASE.vocab_size,
        q_len=SERVE_TOPK["q_len"], p_len=P_LEN, seed=SEED,
    )
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoded = retriever.build_index(corpus.passages).reps
    encoded.sum().item()                              # waits for the encode
    index_s = time.perf_counter() - t0
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
        ops.fused_topk.launches = 0                   # the main path's run starts here
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
        launches = ops.fused_topk.launches           # read just after the run
        batches = list(server.batch_sizes)
    finally:
        server.stop()
    require(not server._thread.is_alive(), "server thread did not stop")
    require(launches == len(batches) > 0,
            f"fused_topk launched {launches} times for {len(batches)} coalesced batches")
    for ids, scores in answers:
        require(ids.shape == (k,) and scores.shape == (k,), "answer shape")
        require(bool((ids >= 0).all() and (ids < n_index).all()), "answer id out of range")
        require(bool((scores[:-1] >= scores[1:]).all()), "answer scores not sorted descending")

    # one coalesced batch of answers against the plain search on the same reps
    tokens = corpus.queries[:max_batch]
    q_reps = retriever.encode_queries(tokens)
    rs, ri = ref.topk_scores_ref(q_reps, store.reps, k + 1, col_valid=store.row_valid)
    s = torch.as_tensor(np.stack([answers[j][1] for j in range(max_batch)]), device=DEVICE)
    i = torch.as_tensor(np.stack([answers[j][0] for j in range(max_batch)]), device=DEVICE)
    tol = SCORE_RTOL * max(1.0, rs[:, 0].abs().max().item())
    err, clear = check_topk(ref, s, i, rs, ri, tol, "served batch vs plain")
    encoded_hits = int((i < N_ENCODED).sum().item())
    search_ms = cuda_ms(lambda: retriever.search_reps_tensors(q_reps), 10)
    encode_ms = cuda_ms(lambda: retriever.encode_queries(tokens), 10)
    ms = sorted(x * 1e3 for x in lat)
    return {
        "model": "dpr-bert-base (2 x bert-base-uncased, 12 layers, d 768, seeded init)",
        "precision": precision, "search_impl": SEARCH_IMPL, "top_k": k,
        "index_rows": n_index, "encoded_rows": N_ENCODED, "p_len": P_LEN,
        "q_len": SERVE_TOPK["q_len"], "index_bytes": store.bytes_per_device(),
        "setup_s": setup_s, "index_build_s": index_s,
        "requests": N_REQUESTS, "clients": CLIENTS, "qps": N_REQUESTS / wall,
        "p50_ms": statistics.median(ms), "p99_ms": ms[int(0.99 * (len(ms) - 1))],
        "batches": len(batches), "mean_batch": sum(batches) / len(batches),
        "fused_topk_launches": launches, "batch_max_abs_err": err, "batch_tolerance": tol,
        "batch_clear_slots": clear, "batch_slots": i.numel(),
        "batch_hits_in_encoded_rows": encoded_hits,
        "fused_search_ms_one_batch": search_ms, "encode_ms_one_batch": encode_ms,
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
    logs = _build.build(["fused_topk"])
    for name, text in logs.items():
        print(f"[{name}] {text}", file=sys.stderr)
    emit({"phase": "build", "kernels": sorted(logs), "seconds": time.perf_counter() - t0})

    kernels = phase_kernels(torch, ops, ref)
    emit({"phase": "kernels", "fused_topk": kernels, "nvidia_smi": smi})

    serve = phase_serve(torch, ops, ref)
    emit({"phase": "serve", **serve, "nvidia_smi": smi})

    ev = kernels["eval_topk"]
    emit({"kernels": [{
        "name": "fused_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/fused_topk.py:47",
        "launches": serve["fused_topk_launches"], "max_abs_err": ev["max_abs_err"],
        "ms": ev["ms"], "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "library_ms": ev["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
