"""Serving entry point of the port: load a trainer checkpoint (or init fresh),
build the passage index, start the dynamic-batching server and send it
single-query requests. Runs on the GPU; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-passages 1024 --n-queries 64

Serve a model trained by the JAX package's launch/train.py (same tiny-bert
tower config):

  PYTHONPATH=src python -m repro.launch.train --steps 100 --checkpoint-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt /tmp/ckpt

bf16 index through the fused CUDA search kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --precision bf16_banks --search-impl fused

Sharded index: ``--dp N`` starts N ranks (``torch.multiprocessing``, a
``FileStore`` in a temporary directory, no network), one a GPU under NCCL
(rank r on ``cuda:r``), or on the CPU under gloo with ``--device cpu`` (one
torch thread a rank). Each rank holds and searches a 1/N block of the
index; rank 0 runs the server and the load test, the other ranks follow
its batches, and rank 0 prints and returns the stats:

  PYTHONPATH=src python -m repro_torch.launch.serve --dp 2 --device cpu \
      --precision bf16_banks --search-impl fused
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dist import GROUP_TIMEOUT, check_rank_devices, spawn_ranks
from repro_torch.core.precision import PRECISION_PRESETS
from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.models.bert import BertConfig
from repro_torch.models.towers import make_bert_dual_encoder
from repro_torch.retrieval import (
    Retriever,
    RetrieverConfig,
    load_trained_params,
    make_dp_mesh,
    make_server,
    serve_followers,
)

Q_LEN = 16


def tiny_bert(vocab: int = 1000) -> BertConfig:
    """The JAX CLIs' tiny tower (``repro.launch.train.tiny_bert``)."""
    return BertConfig(
        name="bert-tiny",
        n_layers=2,
        d_model=64,
        n_heads=4,
        d_ff=128,
        vocab_size=vocab,
        max_position=64,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="trainer checkpoint dir: serve the trained params "
                         "instead of a fresh init")
    ap.add_argument("--dp", type=int, default=0,
                    help="shard the index over N ranks, one a GPU (or gloo ranks "
                         "with --device cpu); 0 = replicated")
    ap.add_argument("--precision", default="fp32",
                    choices=sorted(PRECISION_PRESETS),
                    help="PrecisionPolicy preset: queries encoded/scored in "
                         "compute dtype, index stored in bank dtype, scores fp32")
    ap.add_argument("--search-impl", default="dense",
                    choices=["dense", "fused"],
                    help="blocked matmul + top-k, or the fused CUDA kernel")
    ap.add_argument("--n-passages", type=int, default=1024)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    if args.dp:
        check_rank_devices(args.dp, args.device)
        return spawn_ranks(_serve, args, args.dp, args.device, timeout=GROUP_TIMEOUT)
    return _serve(args)


def _serve(args, rank: int = 0):
    device = resolve_device(args.device)
    if args.dp and device.type == "cuda":
        device = torch.device("cuda", rank)

    enc = make_bert_dual_encoder(tiny_bert(), precision=args.precision)
    if args.ckpt:
        params, step = load_trained_params(args.ckpt)
        print(f"restored trained params from {args.ckpt} (step {step})")
    else:
        params = enc.init(torch.Generator().manual_seed(args.seed), device)
    corpus = SyntheticRetrievalCorpus(
        n_passages=args.n_passages, q_len=Q_LEN, p_len=32, seed=args.seed
    )
    rcfg = RetrieverConfig(
        top_k=args.top_k,
        search_impl=args.search_impl,
        index_layout="sharded" if args.dp else "replicated",
        precision=args.precision,
        encode_batch=128,
    )
    mesh = make_dp_mesh(args.dp) if args.dp else None
    retriever = Retriever(enc, params, rcfg, device=device, mesh=mesh)

    t0 = time.time()
    store = retriever.build_index(corpus.passages)
    print(
        f"index: {store.rows} x {store.reps.shape[1]} ({store.reps.dtype}, "
        f"{store.bytes_per_device()/1024:.0f} KiB a device over {store.shards} "
        f"shard(s), on {device}) built in {time.time()-t0:.2f}s"
    )
    if rank:
        serve_followers(retriever, args.max_batch, Q_LEN)
        return None

    server = make_server(retriever, max_batch=args.max_batch, q_len=Q_LEN).start()
    try:
        t0 = time.time()
        futures = [server.submit(corpus.queries[i]) for i in range(args.n_queries)]
        hits = 0
        for i, fut in enumerate(futures):
            res = fut.get(timeout=60)
            if isinstance(res, Exception):
                raise res
            ids, _ = res
            hits += int(i in ids)
        dt = time.time() - t0
        sizes = server.batch_sizes
        stats = {
            "qps": args.n_queries / dt,
            "recall": hits / args.n_queries,
            "batch_mean": float(np.mean(sizes)),
            "batch_max": int(max(sizes)),
            "index_bytes_per_device": store.bytes_per_device(),
        }
        print(
            f"served {args.n_queries} queries in {dt:.2f}s "
            f"({stats['qps']:.1f} qps), top-{args.top_k} recall "
            f"{stats['recall']:.3f}, mean coalesced batch "
            f"{stats['batch_mean']:.1f} (max {stats['batch_max']})"
        )
        return stats
    finally:
        server.stop()


if __name__ == "__main__":
    main()
