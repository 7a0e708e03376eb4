"""Times the fused_topk CUDA kernel on one GPU at the serve_topk shape (Q=32)
and the eval_topk shape (Q=2048), k = 100 and k = 1000, against N = 2^20
random index rows of d = 768, bf16 (and fp32 at k = 100, the CUDA-core
path): the kernel's time, split between its two passes (the per-split
scan and the merge); the library yardstick (``chip_smoke.library_topk``:
``torch.matmul`` + ``torch.topk``) on the same inputs in the same process;
and, where ``ops`` keeps them, the path counters of the calls. One JSON
line per shape, then the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.fused_topk.bench [--reps 5]

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.py needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import library_topk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    index = torch.randn((N_INDEX, D), generator=g, device=dev)
    queries = {n_q: torch.randn((n_q, D), generator=g, device=dev)
               for n_q in sorted({n_q for _, n_q, _, _ in SHAPES})}
    smi = card()
    for name, n_q, k, dtype in SHAPES:
        q, p = queries[n_q].to(dtype), index.to(dtype)
        paths = getattr(ops.fused_topk, "paths", None)
        before = dict(paths) if paths is not None else None
        ops.fused_topk(q, p, k)                        # builds at the first call
        torch.cuda.synchronize()
        took = None if paths is None else {
            key: paths[key] - before.get(key, 0) for key in paths if paths[key] != before.get(key, 0)}
        fn = lambda: ops.fused_topk(q, p, k)          # noqa: E731
        row = {
            "shape": name, "Q": n_q, "N": N_INDEX, "d": D, "k": k,
            "dtype": str(dtype).removeprefix("torch."),
            "ms": device_ms(fn, args.reps),
            "passes_ms": profile_passes(fn, args.reps),
            "library_ms": cuda_ms(lambda: library_topk(q, p, k), args.reps),
            "paths": took, "nvidia_smi": smi,
        }
        print(json.dumps(row), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
