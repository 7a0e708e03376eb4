"""Times the fused_infonce CUDA kernels on one GPU at the two shapes of a
contaccum_bf16 chunk: M = 8 local queries and M = 2048 query-bank rows, each
against N = 2064 columns (8 positives, 8 hard negatives, 2048 bank rows) of
d = 768; bf16 with the last 1000 bank columns masked (``chip_smoke.py``'s
kernels case), bf16 with every column valid (the train phase after its
warm-up), fp32 with the mask, and the contaccum_mined chunk's N = 2096 (4
mined columns a query; bf16 masked; ``--only mined``). For each shape and
each of the forward, dQ and dP: the kernel's device time, its kernels' times by name, the plain
version (ref.py, and autograd through it), the dense loss backend on the
same inputs (``DenseLossBackend.chunk_stats`` and autograd: the
yardstick), TFLOP/s over the valid columns, the path each call took where
``ops`` counts them, and the bound: the least time an H100 SXM could take
(inputs read once and outputs written once over 3.35 TB/s, or the
operations over the valid columns over the operand type's peak: 989
TFLOP/s bf16, 67 fp32 without tensor cores). One JSON line per shape and
kernel, then the card's name and power limit. The LM retriever's chunk
(internlm2-1.8b, d = 2048; ``--only lm`` times it alone): the same rows
and columns, masked and all valid; each of its Hopper kernels also on the
``wmma`` kernels it took before (``parent_ms``: ``ops.stats_on_path`` for
the forward, ``ops.grad_on_path`` for dQ at M = 8 and dP; dQ at M = 2048
has no caller and is on ``wmma`` either way). The xdev path's fp32 shapes
(one rank of contaccum_xdev, d = 768, every column valid; ``--only xdev``
times them alone): the bank rows (M = 8192 against N = 8256), the ring's
8224 rows against its 8192-column bank chunk and its 64-column in-batch
chunk, and the 32 local rows against 8256, with the fp32 M = 2048 chunk
(``bank_rows_fp32``); the forward, dQ and dP there run on 3xTF32
("tf32x3"), each timed in turns with the "fp32" route it took before
(``ops.stats_on_path`` for the forward, ``ops.grad_on_path`` for dQ and
dP: parent, new, new, parent; ``ms_turns``, ``parent_ms_turns``), its
bound three times the products at the TF32 peak (495 TFLOP/s) beside the
67 TFLOP/s one of fp32 FMAs (``bound_ms_fp32``).

    PYTHONPATH=src python -m repro_torch.kernels.fused_infonce.bench [--reps 20] [--only lm|mined|xdev]

``ms`` is the device time of a call (``_timing.device_ms``: the calls
queued behind a sleep kernel); ``kernels_ms`` sums each kernel's device time
under ``torch.profiler`` over ``--reps`` calls, by name, divided by the
calls (the Hopper forward's tile kernel, ``infonce_fwd_small_kernel`` or
``infonce_fwd_rows_kernel``, and its merge, which is launched before the
tiles end and so counts some of its wait for them). ``paths`` is the path
each call took (``ops.fused_infonce_fwd.paths``, ``.dq.paths``,
``.dp.paths``). It uses only ``ops``, ``ref`` and the dense backend, so it
also runs in an older tree of the port with this file copied into it
(paths are then null where that tree counts none, and ``parent_ms``
where it has no ``stats_on_path`` or ``grad_on_path``).

Needs a CUDA device; builds the kernels at first use like any caller.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.core.loss import DenseLossBackend
from repro_torch.kernels._timing import card, device_ms
from repro_torch.kernels.fused_infonce import ops, ref

N_PATH, N_MINED, D, LM_D, N_MASKED = 2064, 2096, 768, 2048, 1000
#: an H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s, and the
#: dense operations/s of each operand type (fp32 on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: the TF32 tensor cores' peak: the "tf32x3" route runs each product three times there
PEAK_TF32_FLOPS = 495e12
#: (name, M, N, d, dtype, masked columns)
SHAPES = (("local_rows", 8, N_PATH, D, torch.bfloat16, N_MASKED),
          ("bank_rows", 2048, N_PATH, D, torch.bfloat16, N_MASKED),
          ("local_rows_all_valid", 8, N_PATH, D, torch.bfloat16, 0),
          ("bank_rows_all_valid", 2048, N_PATH, D, torch.bfloat16, 0),
          ("local_rows_fp32", 8, N_PATH, D, torch.float32, N_MASKED),
          ("bank_rows_fp32", 2048, N_PATH, D, torch.float32, N_MASKED),
          ("mined_local_rows", 8, N_MINED, D, torch.bfloat16, N_MASKED),
          ("mined_bank_rows", 2048, N_MINED, D, torch.bfloat16, N_MASKED),
          ("lm_local_rows", 8, N_PATH, LM_D, torch.bfloat16, N_MASKED),
          ("lm_bank_rows", 2048, N_PATH, LM_D, torch.bfloat16, N_MASKED),
          ("lm_local_rows_all_valid", 8, N_PATH, LM_D, torch.bfloat16, 0),
          ("lm_bank_rows_all_valid", 2048, N_PATH, LM_D, torch.bfloat16, 0),
          ("xdev_local_rows", 32, 8256, D, torch.float32, 0),
          ("xdev_bank_rows", 8192, 8256, D, torch.float32, 0),
          ("xdev_ring_bank_chunk", 8224, 8192, D, torch.float32, 0),
          ("xdev_ring_inbatch_chunk", 8224, 64, D, torch.float32, 0))


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


def bound_ms(kernel: str, m: int, n: int, n_valid: int, d: int, dtype, route=None) -> tuple:
    """(bound_ms, bound_by) of one call: q, p, labels, col_valid (and the
    backward's lse, g_lse, g_pos) read once and the outputs written once,
    against 2 m n_valid d operations for the forward and 4 m n_valid d for
    dQ or dP (the scores again, then the product); on the "tf32x3" route
    three times those at the TF32 peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    moved = (m + n) * d * item + 4 * m + n + 3 * 4 * m
    if kernel != "fwd":
        moved += (m if kernel == "dq" else n) * d * item
    flop = (2.0 if kernel == "fwd" else 4.0) * m * n_valid * d
    peak = PEAK_FLOPS[dtype]
    if route == "tf32x3":
        flop, peak = 3 * flop, PEAK_TF32_FLOPS
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, flop / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _case(m, n, d, dtype, n_masked, dev, g):
    q = (torch.randn((m, d), generator=g, device=dev) * 0.2).to(dtype)
    p = (torch.randn((n, d), generator=g, device=dev) * 0.2).to(dtype)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    if n_masked:
        valid[-n_masked:] = False
    # the local rows' own positives, or each bank row's column after a chunk's
    # own (the xdev shapes: row i's label column i, wrapped)
    if dtype == torch.float32 and d == D and n != N_PATH:
        labels = torch.arange(m, device=dev) % n
    else:
        labels = torch.arange(m, device=dev) + (0 if m == 8 else n - 2048)
    g_lse = torch.rand((m,), generator=g, device=dev)
    g_pos = -torch.rand((m,), generator=g, device=dev)
    return q, p, labels.to(torch.int32), valid, g_lse, g_pos


def _bwd(stats, which, q, p, g_lse, g_pos):
    """A call of the gradient of ``stats(q, p)``'s (lse, pos) w.r.t. q
    (``which`` "dq") or p for the cotangents, by autograd."""
    qf = q.detach().requires_grad_(which == "dq")
    pf = p.detach().requires_grad_(which == "dp")
    sl, sp, _ = stats(qf, pf)
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
    ap.add_argument("--only", choices=("lm", "mined", "xdev"), default=None,
                    help="time only the LM retriever's chunk (d = 2048), the "
                         "contaccum_mined chunk (N = 2096) or the xdev path's fp32 shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dense = DenseLossBackend()
    smi = card()
    on_path = {"fwd": getattr(ops, "stats_on_path", None), "dq": getattr(ops, "grad_on_path", None),
               "dp": getattr(ops, "grad_on_path", None)}
    for name, m, n, d, dtype, n_masked in SHAPES:
        if args.only and not name.startswith(args.only) and not (
                args.only == "xdev" and name == "bank_rows_fp32"):
            continue
        q, p, labels, valid, g_lse, g_pos = _case(m, n, d, dtype, n_masked, dev, g)
        lse = ops.fused_infonce_fwd(q, p, labels, valid)[0]
        args_ = (q, p, labels, valid, lse, g_lse, g_pos)
        n_valid = int(valid.sum().item())

        def plain(a, b):
            return ref.infonce_stats_ref(a, b, labels, valid)

        def library(a, b):
            return dense.chunk_stats(a, b, labels, valid, temperature=1.0)

        for kernel, fn, plain_fn, library_fn, flop in (
            ("fwd", lambda: ops.fused_infonce_fwd(q, p, labels, valid),
             lambda: plain(q, p), lambda: library(q, p), 2.0),
            ("dq", lambda: ops.fused_infonce_dq(*args_),
             _bwd(plain, "dq", q.float(), p.float(), g_lse, g_pos),
             _bwd(library, "dq", q, p, g_lse, g_pos), 4.0),
            ("dp", lambda: ops.fused_infonce_dp(*args_),
             _bwd(plain, "dp", q.float(), p.float(), g_lse, g_pos),
             _bwd(library, "dp", q, p, g_lse, g_pos), 4.0),
        ):
            counter = getattr(ops, f"fused_infonce_{kernel}")
            before = dict(getattr(counter, "paths", {}))
            fn()
            torch.cuda.synchronize()
            took = _took(counter, before)
            route = next(iter(took)) if took and len(took) == 1 else None
            bound, bound_by = bound_ms(kernel, m, n, n_valid, d, dtype, route)
            parent_ms, parent, turns = None, on_path[kernel], {}
            if d == LM_D and parent is not None and (kernel != "dq" or m <= ops.SMALL_M):
                call = (functools.partial(parent, "wmma", q, p, labels, valid) if kernel == "fwd"
                        else functools.partial(parent, kernel, "wmma", *args_))
                parent_ms = device_ms(call, args.reps)
            if route == "tf32x3" and parent is not None:
                # the fp32 FMA kernels this call took before, in turns
                call = (functools.partial(parent, "fp32", q, p, labels, valid) if kernel == "fwd"
                        else functools.partial(parent, kernel, "fp32", *args_))
                turns = {"ms_turns": [], "parent_ms_turns": []}
                for key, f in (("parent_ms_turns", call), ("ms_turns", fn), ("ms_turns", fn),
                               ("parent_ms_turns", call)):
                    turns[key].append(device_ms(f, args.reps))
                parent_ms = sum(turns["parent_ms_turns"]) / 2
                turns["bound_ms_fp32"] = bound_ms(kernel, m, n, n_valid, d, dtype)[0]
            ms = sum(turns["ms_turns"]) / 2 if turns else device_ms(fn, args.reps)
            print(json.dumps({
                "shape": name, "kernel": kernel, "M": m, "N": n, "n_valid": n_valid, "d": d,
                "dtype": str(dtype).removeprefix("torch."), "ms": ms,
                "parent_ms": parent_ms, "tflops": flop * m * n_valid * d / ms / 1e9,
                "kernels_ms": profile_kernels(fn, args.reps),
                "plain_ms": device_ms(plain_fn, max(5, args.reps // 4)),
                "library_ms": device_ms(library_fn, max(5, args.reps // 4)),
                "paths": took, "bound_ms": bound, "bound_by": bound_by, **turns,
                "nvidia_smi": smi,
            }), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
