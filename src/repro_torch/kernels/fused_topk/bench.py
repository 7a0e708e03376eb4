"""Splits the fused_topk CUDA kernel's time on one GPU between its two passes
(the per-split top-k and the merge), with ``torch.profiler``, at the
serve_topk and eval_topk shapes (d=768, bf16, k=100, N=2^20 random index
rows). Prints the profiler's table per shape, beside the card's name and
power limit.

    PYTHONPATH=src python -m repro_torch.kernels.fused_topk.bench

Needs a CUDA device; builds the kernel at first use like any caller.
``chip_smoke.py`` times the kernel as a whole against its plain version.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.kernels._timing import card
from repro_torch.kernels.fused_topk import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.py needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    p = torch.randn((1 << 20, 768), generator=g, device=dev).to(torch.bfloat16)
    for n_q in (32, 2048):
        q = torch.randn((n_q, 768), generator=g, device=dev).to(torch.bfloat16)
        ops.fused_topk(q, p, 100)                     # build and warm up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                ops.fused_topk(q, p, 100)
            torch.cuda.synchronize()
        print(f"Q={n_q}, N={p.shape[0]}, {args.reps} calls, {card()}")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=4))


if __name__ == "__main__":
    main()
