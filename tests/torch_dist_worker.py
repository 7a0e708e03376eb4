"""The ranks of the 4-rank gloo group that tests/test_torch_dist.py starts:
every multi-rank computation of the port that the tests hold to the JAX
package (training and the sharded serving index), run once per rank, each
rank's results saved with ``torch.save``.

Imports no JAX: each rank is a fresh process that loads only torch and the
port. The parent computes the JAX side on one device and passes the inputs
(the JAX initial params and the batches, as numpy) in ``spec``.
"""

import dataclasses
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import params_to_numpy, params_to_torch
from repro_torch.core import dist as port_dist
from repro_torch.core.dist import DistCtx
from repro_torch.core.loss import (
    contrastive_loss,
    sharded_bank_extra_columns,
    sharded_bank_extra_rows,
)
from repro_torch.core.memory_bank import BankState
from repro_torch.core.methods import build_step_program, init_state
from repro_torch.core.types import ContrastiveConfig, DualEncoder, RetrievalBatch
from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.evaluation import evaluate_topk
from repro_torch.launch.serve import make_bert_dual_encoder, tiny_bert
from repro_torch.optim import chain, clip_by_global_norm, sgd
from repro_torch.retrieval import serving
from repro_torch.retrieval import (
    Retriever,
    RetrieverConfig,
    build_index_store,
    make_dp_mesh,
    make_server,
    serve_followers,
)

AXIS = ("pod", "data")


def torch_mlp_encoder(dim_rep: int = 8) -> DualEncoder:
    """The twin of helpers.make_mlp_encoder: tanh MLP towers over vectors."""

    def tower(tp, x):
        return torch.tanh(x @ tp["w1"] + tp["b1"]) @ tp["w2"] + tp["b2"]

    def init(generator, device):
        raise NotImplementedError("the tests carry the JAX params across")

    return DualEncoder(
        init=init,
        encode_query=lambda params, x: tower(params["query"], x),
        encode_passage=lambda params, x: tower(params["passage"], x),
        rep_dim=dim_rep,
    )


def local_rows(x, rank, world):
    """This rank's contiguous block of the global rows (JAX's P("data"))."""
    n = x.shape[0] // world
    return x[rank * n : (rank + 1) * n]


def _bank(b: BankState):
    return {key: getattr(b, key).numpy() for key in ("buf", "valid", "head", "age")}


def trajectory(case, params0, batches, rank, world):
    """One program case over the batches on this rank's rows: per-step
    metrics, the final params and this rank's banks."""
    cfg = ContrastiveConfig(dp_axis=AXIS, temperature=1.0, grad_clip_norm=2.0, **case)
    tx = chain(clip_by_global_norm(cfg.grad_clip_norm), sgd(0.05))
    enc = torch_mlp_encoder()
    state = init_state(None, enc, tx, cfg, params=params_to_torch(params0, "cpu"), device="cpu")
    update = build_step_program(enc, tx, cfg).update
    metrics = []
    for b in batches:
        batch = RetrievalBatch(*(None if x is None else torch.from_numpy(local_rows(x, rank, world))
                                 for x in b))
        state, m = update(state, batch)
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return {"metrics": metrics, "params": params_to_numpy(state.params),
            "bank_q": _bank(state.bank_q), "bank_p": _bank(state.bank_p),
            "step": int(state.step)}


def collectives_case(rank, world, x, c):
    """gather (value, gradient), psum_tree, bool gather and ring_rotate
    (value, gradient, a full circle) on this rank's slices."""
    ctx = DistCtx(AXIS)
    out = {"is_distributed": ctx.is_distributed, "count": ctx.device_count(),
           "index": ctx.shard_index(), "perm": ctx.ring_perm(1)}
    xr = torch.from_numpy(x[rank]).requires_grad_(True)
    y = ctx.gather(xr)
    (y * torch.from_numpy(c[rank])).sum().backward()
    out["gather"], out["gather_grad"] = y.detach().numpy(), xr.grad.numpy()
    tree = {"a": torch.from_numpy(x[rank]), "b": [torch.full((3,), float(rank + 1)),
                                                 torch.tensor(rank, dtype=torch.int64)]}
    summed = ctx.psum_tree(tree)
    out["psum_tree"] = {"a": summed["a"].numpy(), "b0": summed["b"][0].numpy(),
                        "b1": int(summed["b"][1])}
    out["gather_bool"] = ctx.gather(torch.tensor([rank % 2 == 0, True, rank == 3])).numpy()
    s = torch.tensor([float(rank)], requires_grad=True)
    r = ctx.ring_rotate(s, 1)
    (r * float(rank + 1)).sum().backward()
    out["rotate"], out["rotate_grad"] = r.detach().numpy(), s.grad.numpy()
    full = (torch.tensor([float(rank)]), torch.tensor([rank == 1]))
    for _ in range(world):
        full = ctx.ring_rotate(full, 1)
    out["full_circle"] = (full[0].numpy(), full[1].numpy())
    sent = torch.tensor([rank, 7])
    out["broadcast"] = ctx.broadcast(sent, src=0).numpy()
    out["broadcast_kept"] = sent.numpy()            # the caller's tensor is not written
    out["broadcast_bool"] = ctx.broadcast(torch.tensor([rank == 2, False]), src=2).numpy()
    port_dist.reset_collectives()
    ctx.gather(torch.zeros(2))
    ctx.psum(torch.zeros(()))
    ctx.ring_rotate(torch.zeros(2))
    ctx.broadcast(torch.zeros(2))
    out["collectives"] = dict(port_dist.collectives)
    return out


def _store(store):
    return {"reps": store.reps.float().numpy(), "row_valid": store.row_valid.numpy(),
            "n_total": store.n_total, "shards": store.shards, "shard": store.shard,
            "rows": store.rows, "rows_per_shard": store.rows_per_shard,
            "bytes_per_device": store.bytes_per_device()}


def serve_case(rank, world, spec):
    """The sharded index over the group against a replicated Retriever on
    the same rank: the stores, the searches (tiny BERT towers, N rows with
    padding, each (precision, search_impl) of ``spec["layouts"]``), a tie
    across shards on vectors, and through ``spec["serve_layout"]``'s
    retrievers requests through rank 0's server while the others follow,
    and ``evaluate_topk``."""
    corpus = SyntheticRetrievalCorpus(**spec["corpus"])
    queries = corpus.queries[: spec["n_queries"]]
    out, retrievers = {}, {}
    for (precision, impl), params in spec["layouts"].items():
        enc = make_bert_dual_encoder(tiny_bert(), precision=precision)
        cfg = RetrieverConfig(search_impl=impl, precision=precision, **spec["retriever"])
        rep = Retriever(enc, params, cfg, device="cpu")
        sh = Retriever(enc, params, dataclasses.replace(cfg, index_layout="sharded"),
                       device="cpu", mesh=make_dp_mesh(world))
        rep.build_index(corpus.passages)
        sh.build_index(corpus.passages)
        ids_r, s_r = rep.search(queries)
        ids_s, s_s = sh.search(queries)
        out[precision, impl] = {
            "store": _store(sh.index), "replicated": _store(rep.index),
            "ids": ids_s, "scores": s_s, "replicated_ids": ids_r, "replicated_scores": s_r,
            "q_reps": rep.encode_queries(queries).float().numpy(),
        }
        retrievers[precision, impl] = rep, sh
    rep, sh = retrievers[spec["serve_layout"]]
    out["serve"] = _serve_loop(rank, rep, sh, corpus, spec["serve"])
    ks = spec["eval_ks"]
    out["eval"] = evaluate_topk(sh.encoder, sh.params, corpus, ks, retriever=sh)
    out["eval_replicated"] = evaluate_topk(rep.encoder, rep.params, corpus, ks, retriever=rep)
    ties = spec["ties"]
    for impl in ("dense", "fused"):
        r = Retriever(None, None, RetrieverConfig(top_k=ties["k"], search_impl=impl,
                                                  index_layout="sharded"), device="cpu")
        r.index = build_index_store(torch.as_tensor, ties["p"], batch=ties["batch"],
                                    shards=world, shard=rank)
        ids, scores = r.search_reps(torch.as_tensor(ties["q"]))
        out["ties", impl] = {"ids": ids, "scores": scores, "store": _store(r.index)}
    out["mismatch"] = _layout_mismatches(rank, world, ties)
    return out


def _layout_mismatches(rank, world, ties):
    """The error of a search over a store of another layout than the
    Retriever's, by case (None where it searched): each is raised on its
    own rank before any collective."""
    whole = build_index_store(torch.as_tensor, ties["p"], batch=ties["batch"], shards=world)
    cases = {"sharded_given_every_row": ("sharded", whole),
             "sharded_given_another_block": ("sharded", whole.block((rank + 1) % world)),
             "replicated_given_a_block": ("replicated", whole.block(rank))}
    out = {}
    for name, (layout, store) in cases.items():
        r = Retriever(None, None, RetrieverConfig(top_k=ties["k"], index_layout=layout),
                      device="cpu", index=store)
        try:
            r.search_reps(torch.as_tensor(ties["q"]))
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _serve_loop(rank, rep, sh, corpus, spec):
    """Rank 0 queues ``n`` requests, then starts the server (so the batches
    are full but the last), reads every answer and stops the server; the
    other ranks follow. Each rank's collectives are counted from the start;
    rank 0 also reads them before the stop and searches the same padded
    batches on the replicated Retriever."""
    max_batch, q_len, n = spec["max_batch"], corpus.q_len, spec["n"]
    # the wrong role on either side is refused before any collective
    wrong_role = (lambda: make_server(sh, max_batch=max_batch, q_len=q_len)) if rank else (
        lambda: serve_followers(sh, max_batch, q_len))
    refused = []
    for call in (wrong_role, lambda: make_server(sh, max_batch=max_batch)):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
    port_dist.reset_collectives()
    if rank:
        served = serve_followers(sh, max_batch, q_len)
        return {"served": served, "collectives": dict(port_dist.collectives),
                "refused": refused}
    server = make_server(sh, max_batch=max_batch, max_wait_s=0.001, q_len=q_len)
    futures = [server.submit(corpus.queries[i]) for i in range(n)]
    server.start()
    try:
        answers = [f.get(timeout=60) for f in futures]
        during = dict(port_dist.collectives)
    finally:
        server.stop()
    padded = np.concatenate([corpus.queries[:n], np.repeat(corpus.queries[n - 1 : n],
                                                           -n % max_batch, axis=0)])
    want = [rep.search(padded[lo : lo + max_batch]) for lo in range(0, len(padded), max_batch)]
    return {"ids": np.stack([a[0] for a in answers]), "scores": np.stack([a[1] for a in answers]),
            "replicated_ids": np.concatenate([w[0] for w in want])[:n],
            "replicated_scores": np.concatenate([w[1] for w in want])[:n],
            "batch_sizes": list(server.batch_sizes), "collectives_during": during,
            "collectives": dict(port_dist.collectives), "alive": server._thread.is_alive(),
            "refused": refused}


def loss_case(rank, world, spec, comm, backend):
    """contrastive_loss over sharded dual banks whose passage shard needs a
    gradient: this rank's loss share and its gradients w.r.t. its queries,
    positives, hard negatives and passage-bank shard."""
    ctx = DistCtx(AXIS)
    q, pp, ph = (torch.from_numpy(local_rows(spec[k], rank, world)).requires_grad_(True)
                 for k in ("q", "pp", "ph"))
    bq = BankState(*(torch.from_numpy(local_rows(spec["bank_q"][k], rank, world)) if k != "head"
                     else torch.zeros((), dtype=torch.int32) for k in BankState._fields))
    bp = BankState(*(torch.from_numpy(local_rows(spec["bank_p"][k], rank, world)) if k != "head"
                     else torch.zeros((), dtype=torch.int32) for k in BankState._fields))
    bp = bp._replace(buf=bp.buf.clone().requires_grad_(True))
    loss, aux = contrastive_loss(
        q, pp, ph, extra_cols=sharded_bank_extra_columns(bp, ctx, comm),
        extra_rows=sharded_bank_extra_rows(bq, bp, ctx), temperature=spec["temperature"],
        ctx=ctx, backend=backend,
    )
    loss.backward()
    return {"loss_dev": float(loss), "loss": float(aux.loss), "accuracy": float(aux.accuracy),
            "n_negatives": float(aux.n_negatives), "dq": q.grad.numpy(), "dpp": pp.grad.numpy(),
            "dph": ph.grad.numpy(), "dbank_p": bp.buf.grad.numpy()}


def run(rank, world, out_dir, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        result = {"collectives": collectives_case(rank, world, spec["x"], spec["c"]),
                  "serve": serve_case(rank, world, spec["serve"])}
        for name, case in spec["programs"].items():
            result[name] = trajectory(case, spec["params0"], spec["batches"], rank, world)
        for comm in ("all_gather", "ring"):
            for backend in ("dense", "fused"):
                result[f"loss/{comm}/{backend}"] = loss_case(rank, world, spec["loss"], comm,
                                                             backend)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _barrier(store, key, world):
    """Every rank at this point, on the store alone (no collective, so no
    group timeout: the ranks may arrive seconds apart)."""
    store.add(key, 1)
    deadline = time.monotonic() + 120
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"ranks missing at {key!r}")
        time.sleep(0.01)


def idle_run(rank, world, out_dir, spec):
    """A sharded server (tiny BERT towers) that receives no request for
    ``idle_s``, longer than the group's ``timeout_s``, then one request and
    its stop; the other ranks follow. Rank 0 also searches the same padded
    batch on a replicated Retriever."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "idle_store"), world)
    _barrier(store, "started", world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=spec["timeout_s"]))
    try:
        corpus = SyntheticRetrievalCorpus(**spec["corpus"])
        enc = make_bert_dual_encoder(tiny_bert())
        params = enc.init(torch.Generator().manual_seed(0), "cpu")
        cfg = RetrieverConfig(top_k=5, index_layout="sharded", encode_batch=8)
        sh = Retriever(enc, params, cfg, device="cpu", mesh=make_dp_mesh(world))
        sh.build_index(corpus.passages)
        max_batch, q_len = spec["max_batch"], corpus.q_len
        _barrier(store, "built", world)
        port_dist.reset_collectives()
        if rank:
            result = {"served": serve_followers(sh, max_batch, q_len)}
        else:
            serving.KEEPALIVE_S = spec["keepalive_s"]        # this rank's process only
            server = make_server(sh, max_batch=max_batch, max_wait_s=0.001,
                                 q_len=q_len).start()
            try:
                time.sleep(spec["idle_s"])
                ids, scores = server.query(corpus.queries[0], timeout=60)
            finally:
                server.stop()
            rep = Retriever(enc, params, dataclasses.replace(cfg, index_layout="replicated"),
                            device="cpu")
            rep.build_index(corpus.passages)
            want_ids, want_scores = rep.search(np.repeat(corpus.queries[:1], max_batch, axis=0))
            result = {"ids": ids, "scores": scores, "want_ids": want_ids[0],
                      "want_scores": want_scores[0], "alive": server._thread.is_alive(),
                      "batch_sizes": list(server.batch_sizes)}
        result["collectives"] = dict(port_dist.collectives)
        torch.save(result, os.path.join(out_dir, f"idle{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_idle(out_dir, spec, world):
    """``idle_run`` on ``world`` ranks; their results, in rank order."""
    torch.multiprocessing.spawn(idle_run, args=(world, str(out_dir), spec), nprocs=world,
                                join=True)
    return [torch.load(os.path.join(out_dir, f"idle{r}.pt"), weights_only=False)
            for r in range(world)]


def spawn(out_dir, spec, world):
    """Start ``world`` ranks on a FileStore under ``out_dir``; each saves
    ``rank<r>.pt`` there. Returns the ranks' results, in rank order."""
    torch.multiprocessing.spawn(run, args=(world, str(out_dir), spec), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

