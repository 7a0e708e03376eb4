"""Training driver of the port: the paper's dense-retriever training (any
single-device method) on the synthetic corpus, through the fault-tolerant
Trainer, with the flags of ``repro.launch.train``. Runs on the GPU;
``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --method contaccum --loss-impl fused --total-batch 64 --local-batch 8 \\
      --bank 256 --steps 100 --checkpoint-dir /tmp/ckpt

Not yet ported: ``--dp``, ``--shard-banks`` and ``--loss-comm ring``
(multi-device, ROADMAP A8) and ``--negatives mined`` (mining, ROADMAP A7);
they raise.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
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
from repro_torch.runtime.trainer import Trainer, TrainerConfig

_NOT_PORTED = "not yet ported to repro_torch (ROADMAP A7/A8)"


def main(argv=None):
    ap = argparse.ArgumentParser()
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
                    help="data-parallel devices (multi-device: not yet ported)")
    ap.add_argument("--shard-banks", action="store_true",
                    help="shard the banks over the DP mesh (not yet ported)")
    ap.add_argument("--loss-comm", default="all_gather", choices=["all_gather", "ring"],
                    help="how sharded bank columns reach the loss ('ring': not yet ported)")
    ap.add_argument("--negatives", default=None, choices=["mined"],
                    help="asynchronously mined hard negatives (not yet ported)")
    ap.add_argument("--mine-every", type=int, default=50)
    ap.add_argument("--mine-topk", type=int, default=32)
    ap.add_argument("--mine-negatives", type=int, default=4)
    ap.add_argument("--mine-band", type=int, nargs=2, default=None, metavar=("LO", "HI"))
    ap.add_argument("--mine-margin", type=float, default=0.0)
    ap.add_argument("--mine-sync", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--corpus-size", type=int, default=2048)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    if args.dp or args.shard_banks or args.loss_comm == "ring":
        raise NotImplementedError(f"--dp/--shard-banks/--loss-comm ring: {_NOT_PORTED}")
    if args.negatives == "mined" or method_composition(args.method)[0] == "mined":
        raise NotImplementedError(f"mined negatives: {_NOT_PORTED}")
    device = resolve_device(args.device)

    bank = args.bank if method_uses_banks(args.method) else 0
    k = max(args.total_batch // args.local_batch, 1)
    _, backprop = method_composition(args.method)
    cfg = ContrastiveConfig(
        method=args.method,
        accumulation_steps=k if backprop != "direct" else 1,
        bank_size=bank,
        loss_impl=args.loss_impl,
        precision=args.precision,
        temperature=1.0,
        grad_clip_norm=2.0,
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

    def next_batch(step):
        b = corpus.batch(loader.next_indices())
        return RetrievalBatch(
            *(torch.from_numpy(np.asarray(b[key], np.int64)).to(device)
              for key in ("query", "passage_pos", "passage_hard"))
        )

    trainer = Trainer(
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
        ),
        update,
        next_batch,
        loader_state=loader.state,
    )
    state, report = trainer.run(state)
    print(
        f"done: {report.steps_run} steps, {report.restarts} restarts, "
        f"final loss {report.final_metrics.get('loss', float('nan')):.4f}, "
        f"final grad-norm ratio "
        f"{report.final_metrics.get('grad_norm_ratio', float('nan')):.3f}"
    )
    return state, report


if __name__ == "__main__":
    main()
