"""Times the bf16 flash_attention kernel under each tile plan (BQ query rows,
BK keys a tile) at the bf16 shapes of ``chip_smoke.py``'s kernels phase and
at the BERT passes of serving (a batch of 32 queries, an index encode batch
of 256 passages) and the LM retriever's passes, beside ``scaled_dot_product_attention`` on the same
inputs, on one GPU.
Each plan's output is held against ref.py (``error_ok``) first. Plans are
timed in turns, forward then backward over the list, and both times are
printed; the plan ``ops.tile_plan`` picks is marked. One JSON line per
shape, then the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench

``--host`` times the host's part of a call instead, at the BERT passes of a
train chunk and of a served batch of queries (strided q, k, v, ragged key
masks): the host's microseconds a call of ``ops.flash_attention`` and of
``ops._launch`` alone (``_timing.host_us``, three means of 500 calls each),
beside the call's device time
and its time with the enqueue; then one query-tower encode of a served
batch at the full dpr-bert-base width with plain and with flash attention
(``_timing.cuda_ms``, as ``chip_smoke.py``'s ``encode_ms_one_batch``).
It uses only ``ops.flash_attention`` and ``ops._launch(q, k, v, kv_mask,
causal, scale)``, so it also runs against an older tree of the port, with
this file and ``kernels/_timing.py`` copied into it.

``--host --against OTHER/src`` compares the host's part of a call with
another tree of the port in one process: it imports that tree's ops beside
this one (each builds and loads its own library) and times the two in
alternating blocks (A B, then B A, 20 times) on the same
tensors, so that drift in the host's speed falls on both alike.

Needs a CUDA device; builds the kernel at first use like any caller. The
plans are run through ``ops._launch``'s ``tiles`` argument, the only way to
run another plan than ``ops.tile_plan``'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import statistics
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels._timing import card, cuda_ms, device_ms, host_us
from repro_torch.kernels.flash_attention import ops, ref

PLANS = ((64, 64), (64, 128), (128, 64), (128, 128))
#: (B, S, H, Hk, D, causal, key mask and q, k, v split from one projection)
SHAPES = {
    "bert_query": (8, 32, 12, 12, 64, False, True),
    "bert_passage": (8, 256, 12, 12, 64, False, True),
    "serve_query": (32, 32, 12, 12, 64, False, True),         # a served batch
    "index_passage": (256, 256, 12, 12, 64, False, True),     # an index encode batch
    "internlm2_prefill": (1, 4096, 16, 8, 128, True, False),
    "internlm2_prefill_2k": (1, 2048, 16, 8, 128, True, False),  # 256 blocks of 128 rows
    "stablelm_prefill": (1, 2048, 32, 32, 80, True, False),
    # the LM retriever's query and passage passes (internlm2-1.8b towers)
    "lm_query": (8, 32, 16, 8, 128, True, False),
    "lm_passage": (8, 256, 16, 8, 128, True, False),
}
#: (B, S) of the host timings: the BERT query and passage passes of a train
#: chunk, and a served batch of queries (serve_topk's 32)
HOST_SHAPES = {"bert_query": (8, 32), "bert_passage": (8, 256), "serve_query": (32, 32)}


def inputs(b, s, h, hk, d, fused, g, dev):
    def rand(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    if fused:
        qkv = rand((b, s, 3 * h * d))
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        return q, k, v, torch.arange(s, device=dev)[None, :] < lengths[:, None]
    return rand((b, s, h, d)), rand((b, s, hk, d)), rand((b, s, hk, d)), None


def host(reps: int, g, dev):
    """The host's part of a call at HOST_SHAPES, then a served batch's
    query-tower encode with plain and flash attention; one JSON line each."""
    from repro_torch.configs.dpr_bert_base import BERT_BASE, SERVE_TOPK
    from repro_torch.models.towers import make_bert_dual_encoder

    h, d = BERT_BASE.n_heads, BERT_BASE.dh
    for name, (b, s) in HOST_SHAPES.items():
        q, k, v, mask = inputs(b, s, h, h, d, True, g, dev)

        def op():
            return ops.flash_attention(q, k, v, kv_mask=mask)

        def launch():
            return ops._launch(q, k, v, mask, False, d ** -0.5)

        print(json.dumps({
            "shape": name, "B": b, "S": s, "H": h, "D": d,
            "op_host_us": [host_us(op, reps) for _ in range(3)],
            "launch_host_us": [host_us(launch, reps) for _ in range(3)],
            "ms": device_ms(op, 20), "ms_with_enqueue": cuda_ms(op, 20),
        }), flush=True)
    n_q = SERVE_TOPK["n_queries"]
    tokens = torch.randint(1, BERT_BASE.vocab_size, (n_q, SERVE_TOPK["q_len"]), generator=g,
                           device=dev)
    encode = {}
    for impl in ("plain", "pallas"):
        cfg = dataclasses.replace(BERT_BASE, attention_impl=impl)
        enc = make_bert_dual_encoder(cfg, precision=SERVE_TOPK["precision"])
        params = enc.init(torch.Generator().manual_seed(0), dev)
        with torch.inference_mode():
            encode[impl] = cuda_ms(lambda: enc.encode_query(params, tokens), 10)
        del params
    print(json.dumps({"encode_queries": n_q, "encode_ms_one_batch": encode}), flush=True)


def other_ops(src: str):
    """``kernels.flash_attention.ops`` of the port in another tree (``src``,
    its ``src/`` directory), imported beside this process's own."""
    def ours():
        return {n: m for n, m in sys.modules.items()
                if n == "repro_torch" or n.startswith("repro_torch.")}

    saved = ours()
    for name in saved:
        del sys.modules[name]
    sys.path.insert(0, src)
    try:
        return importlib.import_module("repro_torch.kernels.flash_attention.ops")
    finally:
        sys.path.remove(src)
        for name in ours():
            del sys.modules[name]
        sys.modules.update(saved)


def host_against(src: str, reps: int, turns: int, g, dev):
    """The host's microseconds a call of this tree's op and of the other
    tree's, in alternating blocks of ``reps`` calls at HOST_SHAPES; one
    JSON line a shape with every block's mean."""
    trees = {"this": ops, "other": other_ops(src)}
    for name, (b, s) in HOST_SHAPES.items():
        q, k, v, mask = inputs(b, s, 12, 12, 64, True, g, dev)
        got = {t: {"op_host_us": [], "launch_host_us": []} for t in trees}
        for turn in range(turns):
            for t in (("this", "other") if turn % 2 == 0 else ("other", "this")):
                mod = trees[t]
                got[t]["op_host_us"].append(
                    host_us(lambda: mod.flash_attention(q, k, v, kv_mask=mask), reps))
                got[t]["launch_host_us"].append(
                    host_us(lambda: mod._launch(q, k, v, mask, False, 0.125), reps))
        print(json.dumps({
            "shape": name, "B": b, "S": s, "reps": reps, "other": src, **got,
            "median_us": {t: {m: statistics.median(x) for m, x in r.items()}
                          for t, r in got.items()},
        }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--host", action="store_true",
                    help="time the host's part of a call and a served batch's encode")
    ap.add_argument("--against", metavar="SRC",
                    help="with --host: the src/ of another tree of the port to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.py needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if args.host and args.against:
        host_against(args.against, 200, 20, g, dev)
        print(card(), flush=True)
        return
    if args.host:
        host(500, g, dev)
        print(card(), flush=True)
        return
    for name, (b, s, h, hk, d, causal, fused) in SHAPES.items():
        q, k, v, mask = inputs(b, s, h, hk, d, fused, g, dev)
        scale = d ** -0.5

        def run(tiles):
            return ops._launch(q, k, v, mask, causal, scale, tiles=tiles)

        errors = {}
        for tiles in PLANS:
            err = ref.flash_attention_error(run(tiles), q, k, v, causal=causal, kv_mask=mask)
            errors["x".join(map(str, tiles))] = err["worst"]
            if not ref.error_ok(err, q.dtype):
                raise SystemExit(f"{name} at tiles {tiles}: kernel departs from ref.py: {err}")
        mask4 = None if mask is None else mask[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask4,
                is_causal=causal, scale=scale, enable_gqa=hk != h)

        times = {"x".join(map(str, t)): [] for t in PLANS}
        for order in (PLANS, PLANS[::-1]):
            for tiles in order:
                times["x".join(map(str, tiles))].append(device_ms(lambda: run(tiles), args.reps))
        print(json.dumps({
            "shape": name, "B": b, "S": s, "H": h, "Hk": hk, "D": d, "causal": causal,
            "key_mask": mask is not None,
            "plan": "x".join(map(str, ops._plan(b, s, s, h, d, q.dtype, q.device.index,
                                                causal))),
            "ms": times, "worst_share_of_allowance": errors,
            "library_ms": device_ms(library, args.reps),
        }), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
