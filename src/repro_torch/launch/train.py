"""Training driver of the port: the paper's dense-retriever training (any
of the methods) on the synthetic corpus, through the fault-tolerant
Trainer, with the flags of ``repro.launch.train``. Runs on the GPU;
``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --method contaccum --loss-impl fused --total-batch 64 --local-batch 8 \\
      --bank 256 --steps 100 --checkpoint-dir /tmp/ckpt

Hard-negative mining (mining/): ``--negatives mined`` runs a
``HardNegativeMiner`` that re-encodes the corpus every ``--mine-every``
steps with a snapshot of the training params and publishes per-query hard
negatives, which the loader joins into every batch as extra
``passage_hard`` columns. It composes with any --method: with a bank method
(e.g. contaccum) the banks keep extending the matrix and every batch also
carries mined columns. The refresh runs on a worker thread (on the GPU on
the miner's own stream, while the training loop runs on a high-priority
stream); ``--mine-sync`` makes each refresh block the loop instead:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --method contaccum --negatives mined --mine-every 50 --mine-topk 32

Data parallel: ``--dp N`` starts N ranks (``torch.multiprocessing``, a
``FileStore`` in a temporary directory, no network), one a GPU under NCCL
(rank r on ``cuda:r``), or on the CPU under gloo with ``--device cpu``
(one torch thread a rank). Each rank trains on its ``total/N`` rows of
every global batch with cross-device in-batch negatives; ``--shard-banks``
gives each rank a bank/N shard of the memory banks instead of the whole
ring, and ``--loss-comm ring`` then streams those shards around the ring
at loss time instead of all-gathering them (core/loss.py). Rank 0 prints;
with ``--checkpoint-dir`` each rank keeps its own state under ``rank<r>/``;
with ``--negatives mined`` each rank runs its own miner over the corpus.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --method contaccum --dp 2 --shard-banks --loss-comm ring \
      --total-batch 16 --local-batch 8 --bank 32 --steps 5 --corpus-size 64
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dist import check_rank_devices, spawn_ranks
from repro_torch.core.methods import (
    available_methods,
    build_step_program,
    init_state,
    method_composition,
    method_needs_mesh,
    method_uses_banks,
)
from repro_torch.core.precision import PRECISION_PRESETS
from repro_torch.core.types import ContrastiveConfig, RetrievalBatch
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.launch.serve import tiny_bert
from repro_torch.models.towers import make_bert_dual_encoder
from repro_torch.optim.adamw import adamw, chain, clip_by_global_norm
from repro_torch.optim.schedules import linear_warmup_linear_decay
from repro_torch.runtime.trainer import (
    PeriodicHook,
    Trainer,
    TrainerConfig,
    TrainerReport,
    priority_stream,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    # mesh-requiring compositions (dpr_xdev) are built through the API
    methods = [m for m in available_methods() if not method_needs_mesh(m)]
    ap.add_argument("--method", default="contaccum", choices=methods)
    ap.add_argument("--loss-impl", default="dense", choices=["dense", "fused"],
                    help="loss backend (core/loss.py): the dense fp32 logits "
                         "block or the fused CUDA kernels")
    ap.add_argument("--precision", default="fp32", choices=sorted(PRECISION_PRESETS),
                    help="PrecisionPolicy preset: fp32, bf16 (bf16 compute), "
                         "bf16_banks (bf16 compute and bank buffers)")
    ap.add_argument("--total-batch", type=int, default=64)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--bank", type=int, default=256)
    ap.add_argument("--dp", type=int, default=0,
                    help="train on N data-parallel ranks, one a GPU (NCCL) or on the "
                         "CPU with --device cpu (gloo); 0 = one process")
    ap.add_argument("--shard-banks", action="store_true",
                    help="shard the memory banks over the ranks (bank/N rows a rank) "
                         "instead of replicating them")
    ap.add_argument("--loss-comm", default="all_gather", choices=["all_gather", "ring"],
                    help="how sharded bank columns reach the loss (needs --shard-banks): "
                         "all_gather materializes the full (bank, d) block per eval; "
                         "ring streams one bank/N shard at a time around the ring with "
                         "an online-softmax merge (exact; transient O(bank*d/N))")
    ap.add_argument("--negatives", default=None, choices=["mined"],
                    help="override the method's negative source: 'mined' runs "
                         "the asynchronous hard-negative miner (mining/) and "
                         "injects its table into every batch; bank methods "
                         "keep their banks on top")
    ap.add_argument("--mine-every", type=int, default=50,
                    help="trainer steps between mining refreshes")
    ap.add_argument("--mine-topk", type=int, default=32,
                    help="mining search depth per query (>= band upper edge)")
    ap.add_argument("--mine-negatives", type=int, default=4,
                    help="mined negatives injected per query per batch")
    ap.add_argument("--mine-band", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                    help="teleportation band [LO, HI) of gold-excluded ranks "
                         "(default [1, mine-topk))")
    ap.add_argument("--mine-margin", type=float, default=0.0,
                    help="drop mined candidates scoring within this margin "
                         "of the gold passage (false-negative guard)")
    ap.add_argument("--mine-sync", action="store_true",
                    help="refresh synchronously: the loop waits for each "
                         "refresh (default: a worker thread, overlapped)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--corpus-size", type=int, default=2048)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    dp = args.dp
    if args.shard_banks and not dp:
        raise SystemExit("--shard-banks needs --dp N (banks shard over the DP mesh)")
    if args.shard_banks and not method_uses_banks(args.method):
        raise SystemExit(f"--shard-banks: method {args.method!r} has no memory banks")
    if args.loss_comm == "ring" and not args.shard_banks:
        raise SystemExit("--loss-comm ring needs --shard-banks (it streams "
                         "the per-device bank shards around the DP ring)")
    if dp:
        check_rank_devices(dp, args.device)
        if args.total_batch % dp:
            raise SystemExit(f"--total-batch {args.total_batch} not divisible by --dp {dp}")
        if args.shard_banks and args.bank % dp:
            raise SystemExit(f"--bank {args.bank} not divisible by --dp {dp}")
        # each rank's state is its own and stays in its process
        return None, TrainerReport(**spawn_ranks(_train_report, args, dp, args.device))
    return _train(args)


def _train_report(args, rank: int):
    """A rank's ``_train``, its report as a dict."""
    return dataclasses.asdict(_train(args, rank)[1])


def _train(args, rank: int = 0):
    dp = args.dp
    device = resolve_device(args.device)
    if dp and device.type == "cuda":
        device = torch.device("cuda", rank)

    source, backprop = method_composition(args.method)
    mine = args.negatives == "mined" or source == "mined"
    # with a bank method the banks stay the source and mined columns ride
    # the batch (contaccum x mined); otherwise the source becomes 'mined'
    negatives = "mined" if mine and not method_uses_banks(args.method) else None

    bank = args.bank if method_uses_banks(args.method) else 0
    # with --dp a rank's batch is total/dp; accumulation chunks split the
    # *local* batch so K still targets --local-batch rows per chunk
    k = max(args.total_batch // max(dp, 1) // args.local_batch, 1)
    cfg = ContrastiveConfig(
        method=args.method,
        negatives=negatives,
        accumulation_steps=k if backprop != "direct" else 1,
        bank_size=bank,
        loss_impl=args.loss_impl,
        precision=args.precision,
        temperature=1.0,
        grad_clip_norm=2.0,
        dp_axis="data" if dp else None,
        shard_banks=bool(args.shard_banks and dp and bank),
        loss_comm=args.loss_comm,
    )
    enc = make_bert_dual_encoder(tiny_bert(), precision=args.precision)
    tx = chain(
        clip_by_global_norm(cfg.grad_clip_norm),
        adamw(linear_warmup_linear_decay(args.lr, args.steps // 10, args.steps)),
    )
    update = build_step_program(enc, tx, cfg).update
    state = init_state(torch.Generator().manual_seed(args.seed), enc, tx, cfg, device=device)

    corpus = SyntheticRetrievalCorpus(
        n_passages=args.corpus_size, q_len=16, p_len=32, seed=args.seed
    )
    loader = ShardedLoader(args.corpus_size, args.total_batch, seed=args.seed)

    miner = None
    injector = None
    hooks = []
    if mine:
        from repro_torch.data.loader import MinedNegativeInjector
        from repro_torch.mining import HardNegativeMiner, MinerConfig

        band = args.mine_band or (1, args.mine_topk)
        mcfg = MinerConfig(
            refresh_every=args.mine_every,
            top_k=args.mine_topk,
            n_negatives=args.mine_negatives,
            depth_lo=band[0],
            depth_hi=band[1],
            margin=args.mine_margin,
            sync=args.mine_sync,
            precision=args.precision,
        )
        # corpus alignment: query i's gold passage IS passage i
        miner = HardNegativeMiner(
            enc, mcfg, queries=corpus.queries, passages=corpus.passages, device=device
        )
        injector = MinedNegativeInjector(
            miner.buffer.read,
            corpus.n_passages,
            seed=args.seed,
            state=loader.state,
            on_step=miner.note_step,
        )
        hooks.append(
            PeriodicHook(every=mcfg.refresh_every, fn=miner.refresh_hook,
                         prefix="mine/", name="mine")
        )

    rows = slice(None)
    if dp:   # this rank's contiguous block of the global batch
        n_local = args.total_batch // dp
        rows = slice(rank * n_local, (rank + 1) * n_local)

    def next_batch(step):
        idx = loader.next_indices()
        b = corpus.batch(idx)
        hard = b["passage_hard"]
        if injector is not None:
            mined_ids = injector.mined_ids(idx, gold=idx, step=step)
            hard = np.concatenate([hard, corpus.passages[mined_ids]], axis=1)
        return RetrievalBatch(
            *(torch.from_numpy(np.asarray(x[rows], np.int64)).to(device)
              for x in (b["query"], b["passage_pos"], hard))
        )

    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and dp:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
    trainer = Trainer(
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_dir=ckpt_dir,
            checkpoint_every=args.checkpoint_every,
        ),
        update,
        next_batch,
        loader_state=loader.state,
        hooks=hooks,
        aux_state=miner,
    )
    # the loop's device work on a high-priority stream: the miner's
    # re-encode runs beside it on its own stream
    with priority_stream(device):
        state, report = trainer.run(state)
    if miner is not None:
        miner.close()
        print(
            f"mining: {miner.refreshes} refreshes, {miner.skipped} skipped, "
            f"last refresh overlapped {miner.last_overlap} steps"
        )
    print(
        f"done: {report.steps_run} steps, {report.restarts} restarts, "
        f"final loss {report.final_metrics.get('loss', float('nan')):.4f}, "
        f"final grad-norm ratio "
        f"{report.final_metrics.get('grad_norm_ratio', float('nan')):.3f}"
    )
    if bank:
        fm = report.final_metrics
        print(f"bank fill: q {fm.get('bank_fill_q', float('nan')):.0f}, "
              f"p {fm.get('bank_fill_p', float('nan')):.0f} of {bank}")
    return state, report


if __name__ == "__main__":
    main()
