"""Times the fused_topk CUDA kernel on one GPU at the serve_topk shape (Q=32)
and the eval_topk shape (Q=2048), k = 100 and k = 1000, against N = 2^20
random index rows of d = 768, bf16 (and fp32 at k = 100, the CUDA-core
path): the kernel's time, split between its two passes (the per-split
scan and the merge); the library yardstick (``chip_smoke.library_topk``:
``torch.matmul`` + ``torch.topk``) on the same inputs in the same process;
and, where ``ops`` keeps them, the path counters of the calls. One JSON
line per shape, then the card's name and power limit. The LM retriever's
search (internlm2-1.8b reps, d = 2048, against N = 4096 rows; ``--only
lm`` times it alone): its eval (Q = 256, k = 20) and Q = 2048 at k = 100,
each also on the route it took before the streamed Hopper scan
(``parent_ms``: the bf16 rows widened to fp32 in the call, then the fp32
kernel, as ``fp32_widened`` did).

    PYTHONPATH=src python -m repro_torch.kernels.fused_topk.bench [--reps 5] [--only lm]

``--layouts``: the streamed layout's cost beside the resident one at a
width where both fit (d = 1024, N = 4096 and 65536, Q = 256 and 2048),
timed in turns (resident, streamed, streamed, resident), the plan forced
through ``ops.layout_plan``; then the streamed scan at d = 2048 against N
= 1024 to 65536 rows, at Q = 64 (4 blocks: no block waits on another),
256 and 2048 (what grows with each block's tiles against what each block
pays once); one JSON line a shape.

``ms`` is the device time of a call (``_timing.device_ms``: the calls queued
behind a sleep kernel); ``passes_ms`` sums each kernel's device time under
``torch.profiler`` over ``--reps`` calls, by name, divided by the calls:
``split`` for the scan kernels (``topk_scan_kernel``, ``topk_split_kernel``),
``merge`` for the merge kernels (``topk_select_kernel``,
``topk_merge_kernel``), ``other`` for anything else the call launched. It
uses only ``ops.fused_topk``, so it also runs in an older tree of the port
with this file copied into it (``paths`` is then null).

Needs a CUDA device; builds the kernel at first use like any caller.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels._timing import card, cuda_ms, device_ms
from repro_torch.kernels.fused_topk import ops

REPO = Path(__file__).resolve().parents[4]
N_INDEX, D = 1 << 20, 768
#: (name, Q, k, dtype): bf16 (the index dtype of every cell), then the fp32
#: CUDA-core path at k = 100
SHAPES = (("serve_topk", 32, 100, torch.bfloat16), ("serve_topk", 32, 1000, torch.bfloat16),
          ("eval_topk", 2048, 100, torch.bfloat16), ("eval_topk", 2048, 1000, torch.bfloat16),
          ("serve_topk", 32, 100, torch.float32), ("eval_topk", 2048, 100, torch.float32))
#: (name, Q, k, dtype) at the LM retriever's width, against LM_N rows
LM_N, LM_D = 4096, 2048
LM_SHAPES = (("lm_eval", 256, 20, torch.bfloat16), ("lm_q2048", 2048, 100, torch.bfloat16))
PASSES = (("split", ("topk_scan_kernel", "topk_split_kernel")),
          ("merge", ("topk_select_kernel", "topk_merge_kernel")))


def _pass_of(name: str) -> str:
    for label, kernels in PASSES:
        if any(k in name for k in kernels):
            return label
    return "other"


def profile_passes(fn, reps: int) -> dict:
    """Device ms a call of each pass, from torch.profiler over ``reps``
    calls (None where the profile shows no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"split": 0.0, "merge": 0.0, "other": 0.0}
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3 / reps
        out[_pass_of(e.key)] += ms
        kernels[e.key[:60]] = {"ms": ms, "calls": e.count / reps}
    if sum(out.values()) <= 0:
        return {"split": None, "merge": None, "other": None, "kernels": {}}
    return {**out, "kernels": kernels}


def time_layouts(reps: int, smi: str) -> None:
    """Resident against streamed query tiles at d = 1024, in turns; then
    the streamed scan at d = 2048."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    d = 1024
    for n in (4096, 65536):
        p = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
        for n_q, k in ((256, 20), (2048, 100)):
            q = torch.randn((n_q, d), generator=g, device=dev).to(torch.bfloat16)
            times = {ops.RESIDENT: [], ops.STREAMED: []}
            plan = ops.scan_plan
            try:
                for layout in (ops.RESIDENT, ops.STREAMED, ops.STREAMED, ops.RESIDENT):
                    ops.scan_plan = lambda d_, k_, n_q_, lay=layout: ops.layout_plan(d_, lay, k_)
                    times[layout].append(device_ms(lambda: ops.fused_topk(q, p, k), reps))
            finally:
                ops.scan_plan = plan
            print(json.dumps({"layouts": True, "Q": n_q, "N": n, "d": d, "k": k,
                              "resident_ms": times[ops.RESIDENT],
                              "streamed_ms": times[ops.STREAMED], "nvidia_smi": smi}), flush=True)
    for n in (1024, 4096, 16384, 65536):
        p = torch.randn((n, LM_D), generator=g, device=dev).to(torch.bfloat16)
        for n_q, k in ((64, 1), (64, 100), (256, 20), (2048, 1), (2048, 100)):
            q = torch.randn((n_q, LM_D), generator=g, device=dev).to(torch.bfloat16)
            n_tiles = -(-n // ops.BLOCK_N)
            splits = ops.split_plan(n_q, n, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)[0]
            print(json.dumps({"layouts": True, "Q": n_q, "N": n, "d": LM_D, "k": k,
                              "plan": ops.scan_plan(LM_D, k, n_q), "splits": splits,
                              "tiles_per_block": -(-n_tiles // splits),
                              "streamed_ms": device_ms(lambda: ops.fused_topk(q, p, k), reps),
                              "nvidia_smi": smi}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=("lm",), default=None,
                    help="time only the LM retriever's search (d = 2048)")
    ap.add_argument("--layouts", action="store_true",
                    help="only the resident and the streamed layout at d = 1024, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.py needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import library_topk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    smi = card()
    if args.layouts:
        time_layouts(args.reps, smi)
        return
    shapes = [] if args.only else [(*shape, N_INDEX, D) for shape in SHAPES]
    shapes += [(*shape, LM_N, LM_D) for shape in LM_SHAPES]
    data = {}
    for name, n_q, k, dtype, n, d in shapes:
        if (n, d) not in data:
            data = {(n, d): (torch.randn((n, d), generator=g, device=dev), {})}
        index, queries = data[(n, d)]
        if n_q not in queries:
            queries[n_q] = torch.randn((n_q, d), generator=g, device=dev)
        q, p = queries[n_q].to(dtype), index.to(dtype)
        paths = getattr(ops.fused_topk, "paths", None)
        before = dict(paths) if paths is not None else None
        ops.fused_topk(q, p, k)                        # builds at the first call
        torch.cuda.synchronize()
        took = None if paths is None else {
            key: paths[key] - before.get(key, 0) for key in paths if paths[key] != before.get(key, 0)}
        fn = lambda: ops.fused_topk(q, p, k)          # noqa: E731
        row = {
            "shape": name, "Q": n_q, "N": n, "d": d, "k": k,
            "dtype": str(dtype).removeprefix("torch."),
            "ms": device_ms(fn, args.reps),
            "passes_ms": profile_passes(fn, args.reps),
            "library_ms": cuda_ms(lambda: library_topk(q, p, k), args.reps),
            "paths": took, "nvidia_smi": smi,
        }
        if d == LM_D:
            row["parent_ms"] = device_ms(lambda: ops.fused_topk(q.float(), p.float(), k),
                                         args.reps)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
