"""DistCtx, the sharded bank push, the ring-streamed loss and the sharded
serving index on the card, in a one-rank NCCL group (a FileStore under the
test's temporary directory). Marked ``cuda``: without a GPU every test here skips. No JAX:
the port against itself; the multi-rank semantics are held to the JAX
package on the CPU by tests/test_torch_dist.py.

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dist_cuda.py

At one rank every collective is a copy, so gather, psum and their
gradients are exact. The masked shard push writes the same slots on the
card as on the CPU, bit for bit. The ring's loss (the in-batch chunk and
the bank chunk merged) is held to the all-gather loss on the fused kernels
at 1e-5 relative, and each gradient to 1e-4 of its largest |g| in fp32 and
1e-2 in bf16 (the chip_smoke tolerances: fp32 sums in another order; the
kernels round each softmax coefficient to bf16). The sharded Retriever's
search, served and replayed as 4 blocks, equals the replicated one's bit
for bit on the fused kernel.
"""

import dataclasses

import pytest
import torch

from repro_torch.core import dist as port_dist
from repro_torch.core.dist import DistCtx
from repro_torch.core.loss import (
    contrastive_loss,
    sharded_bank_extra_columns,
    sharded_bank_extra_rows,
)
from repro_torch.core.memory_bank import init_bank, shard_push, shard_push_pair
from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.kernels.fused_infonce import ops
from repro_torch.kernels.fused_topk import ops as topk_ops
from repro_torch.launch.serve import make_bert_dual_encoder, tiny_bert
from repro_torch.retrieval import (
    IndexStore,
    Retriever,
    RetrieverConfig,
    make_dp_mesh,
    make_server,
    merge_shard_candidates,
)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("needs torch.distributed with NCCL")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield torch.device("cuda", 0)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_gather_psum_and_their_gradients_through_nccl(group):
    ctx = DistCtx("data")
    assert ctx.is_distributed and ctx.device_count() == 1 and ctx.shard_index() == 0
    g = torch.Generator(device=group).manual_seed(0)
    x = torch.randn((6, 5), generator=g, device=group).requires_grad_(True)
    c = torch.randn((6, 5), generator=g, device=group)
    port_dist.reset_collectives()
    y = ctx.gather(x)
    (y * c).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, c)
    assert port_dist.collectives == {"all_gather": 1, "all_reduce": 1, "ring": 0, "broadcast": 0}
    valid = torch.tensor([True, False, True], device=group)
    assert torch.equal(ctx.gather(valid), valid)
    assert torch.equal(ctx.psum(x.detach()), x.detach())
    tree = {"a": x.detach(), "b": [c, torch.arange(3, device=group)]}
    out = ctx.psum_tree(tree)
    assert torch.equal(out["a"], x) and torch.equal(out["b"][0], c)
    assert torch.equal(out["b"][1], tree["b"][1])
    pair = (x, valid)
    assert ctx.ring_rotate(pair) is pair                    # a one-rank ring: the identity
    assert port_dist.collectives["all_reduce"] == 1 + 1 + 2   # psum_tree: one a dtype


@pytest.mark.cuda
def test_masked_shard_push_on_the_card_matches_the_cpu(group):
    g = torch.Generator().manual_seed(1)
    for n in (5, 11, 40):                   # partial, wrapping, oversized (> 32 slots)
        x = torch.randn((n, 8), generator=g)
        for shard in range(4):
            cpu = init_bank(8, 8, device="cpu")._replace(head=torch.tensor(27, dtype=torch.int32))
            card = type(cpu)(*(t.to(group) for t in cpu))
            want = shard_push(cpu, x, 3, shard_index=shard, num_shards=4)
            got = shard_push(card, x.to(group), 3, shard_index=shard, num_shards=4)
            for field in ("buf", "valid", "head", "age"):
                assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), (n, shard)
    q, p = torch.randn((6, 8), device=group), torch.randn((6, 8), device=group)
    bq, bp = shard_push_pair(init_bank(4, 8, device=group), init_bank(4, 8, device=group), q, p,
                             shard_index=0, num_shards=1)
    newest = [4, 5, 2, 3]           # 6 rows into 4 slots: the last 4, from slot 2 on
    assert torch.equal(bq.buf, q[newest]) and torch.equal(bp.buf, p[newest]) and bq.valid.all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_loss_matches_all_gather_on_the_fused_kernels(group, dtype):
    """Sharded dual banks at one rank (a bank of 300 slots, 40 of them
    empty; 24 queries with one hard negative): the ring's loss, its aux
    and the gradients w.r.t. the queries, positives and hard negatives
    against the all-gather path's, every statistic on the CUDA kernels."""
    ctx = DistCtx("data")
    g = torch.Generator(device=group).manual_seed(2)
    b, d, cap = 24, 96, 300

    def rand(*shape):
        return (torch.randn(shape, generator=g, device=group) * 0.3).to(dtype)

    q, pp, ph = rand(b, d), rand(b, d), rand(b, d)
    bq = init_bank(cap, d, dtype, device=group)._replace(buf=rand(cap, d))
    bp = init_bank(cap, d, dtype, device=group)._replace(buf=rand(cap, d))
    valid = torch.ones((cap,), dtype=torch.bool, device=group)
    valid[-40:] = False
    bq, bp = bq._replace(valid=valid), bp._replace(valid=valid)
    out = {}
    for comm in ("all_gather", "ring"):
        leaves = [t.clone().requires_grad_(True) for t in (q, pp, ph)]
        ops.reset_launches()
        loss, aux = contrastive_loss(
            *leaves, extra_cols=sharded_bank_extra_columns(bp, ctx, comm),
            extra_rows=sharded_bank_extra_rows(bq, bp, ctx), temperature=0.5, ctx=ctx,
            backend="fused",
        )
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launches = sum(getattr(ops, f"fused_infonce_{k}").launches for k in ("fwd", "dq", "dp"))
        assert launches > 0, comm
        out[comm] = (loss, aux, grads)
    (la, aa, ga), (lr, ar, gr) = out["all_gather"], out["ring"]
    assert abs(lr.item() - la.item()) <= 1e-5 * abs(la.item())
    assert aa.n_negatives.item() == ar.n_negatives.item() == 2 * b + cap - 40 - 1
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, r in zip(ga, gr):
        assert (a.float() - r.float()).abs().max().item() <= rtol * a.float().abs().max().item()


@pytest.mark.cuda
def test_sharded_retriever_matches_replicated_on_the_fused_kernel(group):
    """Tiny bf16 towers over 1000 passages: the one-rank sharded store equals
    the replicated one, and its searches, direct and through the server
    (one broadcast and two all-gathers a batch, one broadcast more at the
    stop), equal the replicated ones bit for bit, every fused_topk launch
    on the Hopper path."""
    enc = make_bert_dual_encoder(tiny_bert(), precision="bf16_banks")
    params = enc.init(torch.Generator().manual_seed(0), group)
    corpus = SyntheticRetrievalCorpus(n_passages=1000, q_len=16, p_len=32, seed=3)
    cfg = RetrieverConfig(top_k=20, search_impl="fused", precision="bf16_banks", encode_batch=128)
    rep = Retriever(enc, params, cfg, device=group)
    sh = Retriever(enc, params, dataclasses.replace(cfg, index_layout="sharded"), device=group,
                   mesh=make_dp_mesh(1))
    rep.build_index(corpus.passages)
    sh.build_index(corpus.passages)
    assert (sh.index.shard, sh.index.shards, sh.index.rows) == (0, 1, 1000)
    assert torch.equal(sh.index.reps, rep.index.reps)
    queries = corpus.queries[:16]
    topk_ops.reset_launches()
    port_dist.reset_collectives()
    ids, scores = sh.search(queries)
    assert port_dist.collectives == {"all_gather": 2, "all_reduce": 0, "ring": 0, "broadcast": 0}
    want_ids, want_scores = rep.search(queries)
    assert (ids == want_ids).all() and (scores == want_scores).all()
    server = make_server(sh, max_batch=16, max_wait_s=0.001, q_len=16)
    futures = [server.submit(q) for q in queries]
    port_dist.reset_collectives()
    server.start()
    try:
        answers = [f.get(timeout=60) for f in futures]
    finally:
        server.stop()
    assert not server._thread.is_alive() and server.batch_sizes == [16]
    assert port_dist.collectives == {"all_gather": 2, "all_reduce": 0, "ring": 0, "broadcast": 2}
    for (got_ids, got_scores), w_ids, w_scores in zip(answers, want_ids, want_scores):
        assert (got_ids == w_ids).all() and (got_scores == w_scores).all()
    assert topk_ops.fused_topk.paths["hopper"] == topk_ops.fused_topk.launches == 3


@pytest.mark.cuda
def test_four_block_replay_equals_the_replicated_search(group):
    """A D = 4 layout of 4099 bf16 rows at d = 768 (4100 padded rows, the
    last block one padding row), each block searched by _local_topk and
    the blocks merged, against the replicated search: ids and scores bit
    for bit, ties included (rows repeated across blocks)."""
    g = torch.Generator(device=group).manual_seed(4)
    n, d, shards, k = 4099, 768, 4, 100
    reps = torch.randn((n, d), generator=g, device=group).to(torch.bfloat16)
    reps[3000:3050] = reps[10:60]                     # ties across blocks 0 and 2
    rows = -(-n // shards) * shards
    whole = IndexStore(reps=torch.cat([reps, reps.new_zeros((rows - n, d))]),
                       row_valid=torch.arange(rows, device=group) < n, n_total=n, shards=shards)
    replicated = IndexStore(reps=reps, row_valid=torch.ones((n,), dtype=torch.bool, device=group),
                            n_total=n)
    r = Retriever(None, None, RetrieverConfig(top_k=k, search_impl="fused"), device=group)
    q = torch.randn((32, d), generator=g, device=group).to(torch.bfloat16)
    q[:4] = reps[10:14]                               # queries that hit the repeated rows
    topk_ops.reset_launches()
    cands = [r._local_topk(q, whole.block(b)) for b in range(shards)]
    got_s, got_i = merge_shard_candidates(torch.stack([c[0] for c in cands]),
                                          torch.stack([c[1] for c in cands]), k)
    want_s, want_i = r._local_topk(q, replicated)
    assert topk_ops.fused_topk.paths["hopper"] == topk_ops.fused_topk.launches == shards + 1
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    assert bool((got_i[:4, 0] == torch.arange(10, 14, device=group)).all())
