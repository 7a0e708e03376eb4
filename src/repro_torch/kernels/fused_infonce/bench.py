"""Times the fused_infonce CUDA kernels on one GPU at the two shapes of a
contaccum_bf16 chunk: M = 8 local queries and M = 2048 query-bank rows, each
against N = 2064 columns (8 positives, 8 hard negatives, 2048 bank rows) of
d = 768; bf16 with the last 1000 bank columns masked (``chip_smoke.py``'s
kernels case), bf16 with every column valid (the train phase after its
warm-up), and fp32 with the mask. For each shape and each of the forward,
dQ and dP: the kernel's device time, its kernels' times by name, the dense
loss backend on the same inputs (``DenseLossBackend.chunk_stats`` and
autograd: the yardstick), TFLOP/s over the valid columns, and the path each
call took where ``ops`` counts them. One JSON line per shape and kernel,
then the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.fused_infonce.bench [--reps 20]

``ms`` is the device time of a call (``_timing.device_ms``: the calls
queued behind a sleep kernel); ``kernels_ms`` sums each kernel's device time
under ``torch.profiler`` over ``--reps`` calls, by name, divided by the
calls. It uses only ``ops`` and the dense backend, so it also runs in an
older tree of the port with this file copied into it (paths are then null).

Needs a CUDA device; builds the kernels at first use like any caller.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core.loss import DenseLossBackend
from repro_torch.kernels._timing import card, device_ms
from repro_torch.kernels.fused_infonce import ops

N_PATH, D, N_MASKED = 2064, 768, 1000
#: (name, M, dtype, masked columns)
SHAPES = (("local_rows", 8, torch.bfloat16, N_MASKED),
          ("bank_rows", 2048, torch.bfloat16, N_MASKED),
          ("local_rows_all_valid", 8, torch.bfloat16, 0),
          ("bank_rows_all_valid", 2048, torch.bfloat16, 0),
          ("local_rows_fp32", 8, torch.float32, N_MASKED),
          ("bank_rows_fp32", 2048, torch.float32, N_MASKED))


def profile_kernels(fn, reps: int) -> dict:
    """Device ms a call of each kernel by name, from torch.profiler over
    ``reps`` calls (empty where the profile shows no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: getattr(e, "self_device_time_total", 0.0) / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _case(m, dtype, n_masked, dev, g):
    q = (torch.randn((m, D), generator=g, device=dev) * 0.2).to(dtype)
    p = (torch.randn((N_PATH, D), generator=g, device=dev) * 0.2).to(dtype)
    valid = torch.ones((N_PATH,), dtype=torch.bool, device=dev)
    if n_masked:
        valid[-n_masked:] = False
    labels = (torch.arange(m, device=dev) if m == 8 else 16 + torch.arange(m, device=dev))
    g_lse = torch.rand((m,), generator=g, device=dev)
    g_pos = -torch.rand((m,), generator=g, device=dev)
    return q, p, labels.to(torch.int32), valid, g_lse, g_pos


def _dense_bwd(dense, which, q, p, labels, valid, g_lse, g_pos):
    qf = q.detach().requires_grad_(which == "dq")
    pf = p.detach().requires_grad_(which == "dp")
    sl, sp, _ = dense.chunk_stats(qf, pf, labels, valid, temperature=1.0)
    wrt = qf if which == "dq" else pf
    return lambda: torch.autograd.grad((sl, sp), wrt, (g_lse, g_pos), retain_graph=True)


def _took(counter, before):
    paths = getattr(counter, "paths", None)
    if paths is None:
        return None
    return {k: v - before.get(k, 0) for k, v in paths.items() if v != before.get(k, 0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dense = DenseLossBackend()
    smi = card()
    for name, m, dtype, n_masked in SHAPES:
        q, p, labels, valid, g_lse, g_pos = _case(m, dtype, n_masked, dev, g)
        lse = ops.fused_infonce_fwd(q, p, labels, valid)[0]
        args_ = (q, p, labels, valid, lse, g_lse, g_pos)
        n_valid = int(valid.sum().item())
        for kernel, fn, library, flop in (
            ("fwd", lambda: ops.fused_infonce_fwd(q, p, labels, valid),
             lambda: dense.chunk_stats(q, p, labels, valid, temperature=1.0), 2.0),
            ("dq", lambda: ops.fused_infonce_dq(*args_),
             _dense_bwd(dense, "dq", q, p, labels, valid, g_lse, g_pos), 4.0),
            ("dp", lambda: ops.fused_infonce_dp(*args_),
             _dense_bwd(dense, "dp", q, p, labels, valid, g_lse, g_pos), 4.0),
        ):
            counter = getattr(ops, f"fused_infonce_{kernel}")
            before = dict(getattr(counter, "paths", {}))
            fn()
            torch.cuda.synchronize()
            took = _took(counter, before)
            ms = device_ms(fn, args.reps)
            print(json.dumps({
                "shape": name, "kernel": kernel, "M": m, "N": N_PATH, "n_valid": n_valid, "d": D,
                "dtype": str(dtype).removeprefix("torch."), "ms": ms,
                "tflops": flop * m * n_valid * D / ms / 1e9,
                "kernels_ms": profile_kernels(fn, args.reps),
                "library_ms": device_ms(library, max(5, args.reps // 4)),
                "paths": took, "nvidia_smi": smi,
            }), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
