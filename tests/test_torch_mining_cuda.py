"""The hard-negative miner on the card: its refresh on its own CUDA stream,
the snapshot on the caller's stream, and the encode graphs. Marked
``cuda``: without a GPU every test here skips. No JAX: the port against
itself.

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_mining_cuda.py

Every comparison is exact: the same kernels on the same inputs give the
same table, bit for bit, whatever thread or stream queues them, and a
tower's encode graph gives what the tower's own call gives.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.kernels.fused_topk import ops as topk_ops
from repro_torch.launch.serve import tiny_bert
from repro_torch.mining import HardNegativeMiner, MinerConfig
from repro_torch.models.towers import make_bert_dual_encoder
from repro_torch.runtime.trainer import priority_stream

N_CORPUS = 2048
#: about 2.5 s at an H100's clock: far longer than the host takes to check
SLEEP_CYCLES = 5_000_000_000
WAIT_S = 120.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, **kw):
    corpus = SyntheticRetrievalCorpus(n_passages=N_CORPUS, q_len=16, p_len=32, seed=0)
    enc = make_bert_dual_encoder(tiny_bert(), precision="bf16_banks")
    cfg = MinerConfig(**{**dict(top_k=32, n_negatives=4, depth_lo=1, depth_hi=32,
                                search_impl="fused", precision="bf16_banks",
                                query_batch=256, encode_batch=256), **kw})
    params = enc.init(torch.Generator().manual_seed(1), dev)

    def miner(**over):
        return HardNegativeMiner(enc, dataclasses.replace(cfg, **over), queries=corpus.queries,
                                 passages=corpus.passages, device=dev)

    return miner, params


@pytest.mark.cuda
def test_async_refresh_on_the_miners_stream_equals_sync(dev):
    make, params = _setup(dev)
    want = make(sync=True).refresh(params, step=3)
    miner = make(sync=False)
    assert miner.stream is not None and miner.stream != torch.cuda.current_stream(dev)
    topk_ops.reset_launches()
    with priority_stream(dev):
        assert miner.refresh_async(params, step=3)
        miner.wait()
    got = miner.buffer.read()
    np.testing.assert_array_equal(got.ids, want.ids)
    assert (got.step, got.version) == (want.step, want.version) == (3, 1)
    assert topk_ops.fused_topk.paths["hopper"] == topk_ops.fused_topk.launches == N_CORPUS // 256
    assert (got.ids >= 0).mean() > 0.9 and not (got.ids == np.arange(N_CORPUS)[:, None]).any()


@pytest.mark.cuda
def test_graph_encodes_equal_direct_encoder_calls(dev):
    """Each tower's graph, replayed on the snapshot the miner refilled at a
    later refresh, gives the encoder's own output on that snapshot, bit for
    bit."""
    make, params = _setup(dev)
    miner = make(sync=True)
    miner.refresh(params, 0)                     # capture
    first = miner.retriever.index.reps.clone()
    with torch.no_grad():
        for tower in params.values():
            for group in tower.values():
                for t in group.values():
                    t.mul_(0.5)
    miner.refresh(params, 1)                     # refill the snapshot, replay
    graphs = miner._graphs
    assert graphs is not None and len(graphs.graphs) == 2
    assert not torch.equal(miner.retriever.index.reps, first)
    tokens = {"passage": miner._passage_tokens[:256], "query": miner._query_tokens[:256]}
    with torch.inference_mode(), torch.cuda.stream(miner.stream):
        for tower, t in tokens.items():
            got = graphs.run(tower, miner._snap, t)
            want = getattr(miner.encoder, f"encode_{tower}")(miner._snap, t)
            assert torch.equal(got, want), tower
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_an_optimizer_write_right_after_refresh_async_does_not_reach_the_table(dev):
    make, params = _setup(dev)
    want = make(sync=True).refresh(params, step=0).ids
    miner = make(sync=False)
    gate = threading.Event()
    orig = miner._mine

    def gated(p, s):
        assert gate.wait(timeout=WAIT_S)
        return orig(p, s)

    miner._mine = gated
    with priority_stream(dev):
        assert miner.refresh_async(params, 0)
        with torch.no_grad():                   # the next step's in-place update
            for tower in params.values():
                for group in tower.values():
                    for t in group.values():
                        t.mul_(-3.0)
        gate.set()
        miner.wait()
    np.testing.assert_array_equal(miner.buffer.read().ids, want)


def _loop_beside_a_refresh(dev, case):
    """One op of the training loop's while a refresh sleeps on the miner's
    stream (about 2.5 s, queued before the refresh's own work), and the
    host's seconds for its output's allocation, its launch and the sync of
    the loop's stream. ``case``: the op is a GEMM launched before on the
    loop's stream (``warm``) or only on another stream (``new_stream``: the
    loop's stream takes its first blocks and its cuBLAS workspace beside the
    refresh), a GEMM whose kernel the process never launched
    (``new_kernel``: float64), or an op compiled at its first call
    (``new_module``: ndtri, a jiterator op)."""
    make, params = _setup(dev)
    miner = make(sync=False)
    queued = threading.Event()
    orig = miner._mine

    def slow(p, s):
        torch.cuda._sleep(SLEEP_CYCLES)         # on the miner's stream, the worker's current
        queued.set()
        return orig(p, s)

    miner._mine = slow
    a = torch.rand((1024, 1024), device=dev)    # on the default stream
    if case == "new_module":
        op = torch.special.ndtri
    else:
        op = lambda x, out: torch.matmul(x, x, out=out)  # noqa: E731
        if case == "new_kernel":
            a = a.double()
    if case == "new_stream":
        op(a, out=torch.empty_like(a))
    torch.cuda.synchronize()
    with priority_stream(dev) as stream:
        assert stream.priority < 0
        if case == "warm":
            op(a, out=torch.empty_like(a))
            stream.synchronize()
        assert miner.refresh_async(params, 0)
        assert queued.wait(timeout=WAIT_S)
        t0 = time.perf_counter()
        out = torch.empty_like(a)
        t1 = time.perf_counter()
        op(a, out=out)
        t2 = time.perf_counter()
        stream.synchronize()                    # the training loop's one sync a step
        t3 = time.perf_counter()
        busy, flying = not miner.stream.query(), miner.in_flight()
    miner.wait()
    torch.testing.assert_close(out, op(a, out=torch.empty_like(a)), rtol=0, atol=0)
    assert miner.refreshes == 1 and miner.refresh_log[0]["encode_s"] > 0
    times = {"case": case, "alloc_s": t1 - t0, "launch_s": t2 - t1, "sync_s": t3 - t2,
             "total_s": t3 - t0, "busy": busy, "flying": flying}
    print(json.dumps(times))
    return times


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["warm", "new_stream"])
def test_a_sync_of_the_trainers_stream_returns_while_a_refresh_is_in_flight(dev, case):
    t = _loop_beside_a_refresh(dev, case)
    assert t["busy"] and t["flying"] and t["total_s"] < 0.5, t


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["new_kernel", "new_module"])
def test_a_kernels_first_launch_waits_for_a_refresh_in_flight(dev, case):
    """The known stall, kept in sight: the first launch in the process of a
    kernel (a cuBLAS GEMM of a new dtype, an op compiled at its first call)
    returns only once the device has drained the miner's queued work, under
    CUDA_MODULE_LOADING=LAZY and EAGER alike. The training loop meets it
    only for a kernel it first launches after the first refresh has started
    (the refresh hook fires after ``refresh_every`` steps)."""
    t = _loop_beside_a_refresh(dev, case)
    assert t["launch_s"] >= 1.0, t
