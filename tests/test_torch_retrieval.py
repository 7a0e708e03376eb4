"""The port's retrieval slice against the JAX package: the corpus copy, the
search backends, ``Retriever.search`` on carried-across params, the batching
server, and serving a JAX-written trainer checkpoint from both CLIs.

Tolerance: fp32 scores within 1e-5 absolute plus 1e-5 relative (the same
function, other summation orders), ids identical on these well-separated
inputs. bf16_banks: reps are rounded to bf16 in both packages at different
places inside the towers, so query and index reps are held to the towers'
bf16 tolerance (0.05, see test_torch_models.py), and the search is then held
to the fp32 tolerance on the port's own bf16 reps.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import save_checkpoint
from repro.data.retrieval import SyntheticRetrievalCorpus as JaxCorpus
from repro.kernels.fused_topk.ops import fused_topk_scores
from repro.launch import serve as jax_serve
from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro.retrieval import Retriever as JaxRetriever
from repro.retrieval import RetrieverConfig as JaxRetrieverConfig
from repro.retrieval.search import DenseSearchBackend as JaxDense
from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.launch import serve
from repro_torch.core.precision import tensor_to_numpy
from repro_torch.retrieval import (
    DenseSearchBackend,
    FusedSearchBackend,
    Retriever,
    RetrieverConfig,
    load_trained_params,
    make_server,
    resolve_search_backend,
)
from repro_torch.runtime.server import BatchingServer


@pytest.mark.parametrize("kw", [
    {},
    {"n_passages": 300, "vocab_size": 30522, "q_len": 32, "p_len": 64, "n_hard": 2, "seed": 7},
])
def test_corpus_copy_gives_the_same_arrays(kw):
    a, b = JaxCorpus(**kw), SyntheticRetrievalCorpus(**kw)
    for name in ("topics", "topic_of", "passages", "queries", "hard"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    idx = np.array([3, 1, 4])
    for key, val in a.batch(idx).items():
        np.testing.assert_array_equal(val, b.batch(idx)[key])
    for x, y in zip(a.eval_split(16), b.eval_split(16)):
        np.testing.assert_array_equal(x, y)


def _rand(q, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(q, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("block", [7, 64, 65536])
@pytest.mark.parametrize("case", ["random", "ties", "masked_k_exceeds_valid"])
def test_dense_and_fused_backends_agree(block, case):
    q, p = _rand(13, 517, 24, seed=1)
    valid, k = None, 10
    if case == "ties":
        rng = np.random.default_rng(2)
        q = rng.integers(-2, 3, size=(7, 8)).astype(np.float32)
        p = rng.integers(-2, 3, size=(200, 8)).astype(np.float32)
        p[50] = p[130] = p[10]
        k = 12
    elif case == "masked_k_exceeds_valid":
        q, p = np.ascontiguousarray(q[:3, :8]), np.ascontiguousarray(p[:6, :8])
        valid = torch.tensor([True, False, True, True, False, True])
        k = 9
    tq, tp = torch.as_tensor(q), torch.as_tensor(p)
    s_d, i_d = DenseSearchBackend(block=block).topk(tq, tp, k, col_valid=valid)
    s_f, i_f = FusedSearchBackend().topk(tq, tp, k, col_valid=valid)
    assert torch.equal(i_d, i_f)
    torch.testing.assert_close(s_d, s_f, rtol=1e-5, atol=1e-5)
    js, ji = JaxDense(block=block).topk(
        jnp.asarray(q), jnp.asarray(p), k,
        col_valid=None if valid is None else jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(i_d.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s_d.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_resolve_search_backend_and_layouts():
    assert resolve_search_backend(None).name == "dense"
    assert resolve_search_backend("fused").name == "fused"
    with pytest.raises(ValueError, match="unknown search_impl"):
        resolve_search_backend("faiss")
    with pytest.raises(ValueError, match="index_layout"):
        Retriever(None, None, RetrieverConfig(index_layout="interleaved"), device="cpu")
    # the sharded layout runs over the default process group: none here
    with pytest.raises(RuntimeError, match="initialized torch.distributed process group"):
        Retriever(None, None, RetrieverConfig(index_layout="sharded"), device="cpu")


def test_retriever_config_takes_the_jax_fields():
    cfg = RetrieverConfig(search_impl="fused", precision="fp32", index_dtype=torch.bfloat16,
                          dp_axis="model", block_q=16, block_n=32)
    assert cfg.resolved_index_dtype() == torch.bfloat16
    assert RetrieverConfig(precision="bf16_banks").resolved_index_dtype() == torch.bfloat16
    assert RetrieverConfig(precision="fp32").resolved_index_dtype() == torch.float32
    backend = cfg.resolve_backend()
    assert isinstance(backend, FusedSearchBackend) and (backend.block_q, backend.block_n) == (16, 32)
    assert resolve_search_backend("fused", block_q=8, block_n=64).block_n == 64
    assert cfg.dp_axis == "model"
    # the sharded layout's DistCtx is built over dp_axis
    with pytest.raises(RuntimeError, match=r"DistCtx\(axis=\('model',\)\)"):
        Retriever(None, None, dataclasses.replace(cfg, index_layout="sharded"), device="cpu")


def test_index_is_stored_in_index_dtype_as_in_jax():
    """An fp32 policy with a bf16 index: both packages store bf16 rows and
    score fp32 queries against them."""
    corpus = SyntheticRetrievalCorpus(n_passages=64, q_len=16, p_len=32, seed=2)
    jenc = jax_dual_encoder(jax_tiny_bert(), precision="fp32")
    params = jenc.init(jax.random.PRNGKey(6))
    jr = JaxRetriever(jenc, params, JaxRetrieverConfig(
        top_k=5, search_impl="dense", precision="fp32", index_dtype=jnp.bfloat16,
        encode_batch=32))
    tr = Retriever(serve.make_bert_dual_encoder(serve.tiny_bert(), precision="fp32"),
                   jax.device_get(params),
                   RetrieverConfig(top_k=5, search_impl="dense", precision="fp32",
                                   index_dtype=torch.bfloat16, encode_batch=32),
                   device="cpu")
    jstore, tstore = jr.build_index(corpus.passages), tr.build_index(corpus.passages)
    assert tstore.reps.dtype == torch.bfloat16 and jstore.reps.dtype == jnp.bfloat16
    assert tstore.bytes_per_device() == 64 * 64 * 2
    # fp32 towers agree to 1e-5, so the bf16 roundings agree but for a rare
    # tie at a rounding boundary: one bf16 ulp at most
    np.testing.assert_allclose(tstore.reps.float().numpy(),
                               np.asarray(jstore.reps.astype(jnp.float32)), rtol=2 ** -7, atol=1e-6)
    ji, js = jr.search(corpus.queries[:6])
    ti, ts = tr.search(corpus.queries[:6])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("k", [129, 300])
def test_fused_backend_takes_k_past_128_as_jax(k):
    """k > 128 on CPU tensors (the plain version) against the JAX kernel in
    interpret mode; 150 of 400 columns masked, so k=300 also runs past the
    valid columns into (-1e30, -1) slots."""
    q, p = _rand(6, 400, 16, seed=k)
    valid = np.random.default_rng(k).random(400) > 0.375
    s, i = FusedSearchBackend(block_q=8, block_n=64).topk(
        torch.as_tensor(q), torch.as_tensor(p), k, col_valid=torch.as_tensor(valid))
    js, ji = fused_topk_scores(jnp.asarray(q), jnp.asarray(p), k, col_valid=jnp.asarray(valid),
                               block_q=8, block_n=64)
    assert i.shape == (6, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    if k > valid.sum():
        assert (i[:, int(valid.sum()):] == -1).all()


def _retrievers(precision, impl, top_k=8):
    jenc = jax_dual_encoder(jax_tiny_bert(), precision=precision)
    params = jenc.init(jax.random.PRNGKey(5))
    jr = JaxRetriever(jenc, params, JaxRetrieverConfig(
        top_k=top_k, search_impl=impl, precision=precision, encode_batch=32,
        score_block=50, block_q=16, block_n=32))
    tr = Retriever(serve.make_bert_dual_encoder(serve.tiny_bert(), precision=precision),
                   jax.device_get(params),
                   RetrieverConfig(top_k=top_k, search_impl=impl, precision=precision,
                                   encode_batch=32, score_block=50),
                   device="cpu")
    return jr, tr


@pytest.mark.parametrize("precision,impl", [("fp32", "dense"), ("fp32", "fused"),
                                            ("bf16_banks", "fused")])
def test_retriever_search_matches_jax(precision, impl):
    corpus = SyntheticRetrievalCorpus(n_passages=120, q_len=16, p_len=32, seed=1)
    jr, tr = _retrievers(precision, impl)
    jr.build_index(corpus.passages)
    store = tr.build_index(corpus.passages)
    want = torch.float32 if precision == "fp32" else torch.bfloat16
    assert store.reps.dtype == want and store.reps.shape == (120, 64)
    assert store.bytes_per_device() == 120 * 64 * (4 if precision == "fp32" else 2)
    queries = corpus.queries[:12]
    ji, js = jr.search(queries)
    ti, ts = tr.search(queries)
    assert ti.dtype == np.int32 and ts.dtype == np.float32 and ti.shape == (12, 8)
    if precision == "fp32":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
        return
    # bf16: the towers agree to bf16 rounding (test_torch_models.py); the
    # search must then agree exactly on the same bf16 reps
    tq = tr.encode_queries(queries)
    jq = np.asarray(jr.encoder.encode_query(jr.params, jnp.asarray(queries)).astype(jnp.float32))
    np.testing.assert_allclose(tq.float().numpy(), jq, rtol=0, atol=0.05)
    np.testing.assert_allclose(store.reps.float().numpy(),
                               np.asarray(jr.index.reps.astype(jnp.float32)), rtol=0, atol=0.05)
    ts, ti = (t.numpy() for t in tr.search_reps_tensors(tq))
    js, ji = fused_topk_scores(jnp.asarray(tensor_to_numpy(tq)),
                               jnp.asarray(tensor_to_numpy(store.reps)), 8,
                               block_q=16, block_n=32)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-5, atol=1e-5)


def test_batching_server_coalesces_backlog():
    """A backed-up queue must give full batches: the coalescing window is
    measured from collect time, not from when the first request arrived."""
    done = threading.Event()

    def serve_fn(batch):
        done.wait()
        return np.arange(len(batch))[:, None], batch.sum(axis=1, keepdims=True)

    srv = BatchingServer(serve_fn, max_batch=8, max_wait_s=0.001)
    futs = [srv.submit(np.full((4,), float(i))) for i in range(32)]
    time.sleep(0.05)
    srv.start()
    done.set()
    try:
        for f in futs:
            f.get(timeout=10)
        assert srv.batch_sizes == [8, 8, 8, 8], srv.batch_sizes
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


def test_batching_server_pads_flushes_and_reraises():
    seen = []

    def serve_fn(batch):
        seen.append(batch.shape)
        if batch[0, 0] < 0:
            raise RuntimeError("bad request")
        return np.tile(batch[:, :1], (1, 3)), batch.sum(axis=1, keepdims=True)

    srv = BatchingServer(serve_fn, max_batch=4, max_wait_s=0.02).start()
    try:
        ids, scores = srv.query(np.full((2,), 7.0), timeout=10)
        assert seen[0] == (4, 2)
        assert ids.shape == (3,) and np.all(ids == 7.0) and scores.shape == (1,)
        with pytest.raises(RuntimeError, match="bad request"):
            srv.query(np.full((2,), -1.0), timeout=10)
    finally:
        srv.stop()


def test_make_server_round_trips_retriever_results():
    corpus = SyntheticRetrievalCorpus(n_passages=40, q_len=16, p_len=32, seed=2)
    _, tr = _retrievers("fp32", "fused", top_k=5)
    with pytest.raises(ValueError, match="no index"):
        make_server(tr)
    tr.build_index(corpus.passages)
    direct_ids, direct_scores = tr.search(corpus.queries[:6])
    srv = make_server(tr, max_batch=6, max_wait_s=0.02).start()
    try:
        futs = [srv.submit(corpus.queries[i]) for i in range(6)]
        for i, f in enumerate(futs):
            ids, scores = f.get(timeout=30)
            np.testing.assert_array_equal(ids, direct_ids[i])
            np.testing.assert_allclose(scores, direct_scores[i], atol=1e-6)
    finally:
        srv.stop()


def test_jax_checkpoint_serves_through_the_port(tmp_path):
    """A checkpoint written by the JAX package loads through the port, and
    both serve CLIs give the same recall on it."""
    params = jax.device_get(jax_dual_encoder(jax_tiny_bert()).init(jax.random.PRNGKey(9)))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 3, {"state": {"params": params}, "opt": {"mu": np.zeros(2)}})
    loaded, step = load_trained_params(ckpt)
    assert step == 3
    np.testing.assert_array_equal(loaded["query"]["layers"]["wqkv"],
                                  params["query"]["layers"]["wqkv"])
    argv = ["--ckpt", ckpt, "--n-passages", "96", "--n-queries", "24", "--top-k", "5"]
    want = jax_serve.main(argv)
    got = serve.main(argv + ["--device", "cpu"])
    assert got["recall"] == want["recall"]
    assert got["index_bytes_per_device"] == want["index_bytes_per_device"]


def test_load_trained_params_rejects_foreign_checkpoint(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"weights": np.zeros((2,))})
    with pytest.raises(ValueError, match="no 'state/params/'"):
        load_trained_params(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_trained_params(str(tmp_path / "nope"))


def test_serve_cli_rejects_dp():
    """--dp 2 on 2 gloo ranks gives --dp 0's recall with half the index
    bytes a device (96 rows: no padding); --dp N needs N cards unless
    --device cpu (none here)."""
    argv = ["--device", "cpu", "--n-passages", "96", "--n-queries", "24", "--top-k", "40",
            "--precision", "bf16_banks", "--search-impl", "fused", "--max-batch", "8"]
    want = serve.main(argv)
    got = serve.main(argv + ["--dp", "2"])
    assert 0 < want["recall"] < 1
    assert got["recall"] == want["recall"]
    assert got["index_bytes_per_device"] * 2 == want["index_bytes_per_device"] == 96 * 64 * 2
    with pytest.raises(SystemExit, match="--dp 2 needs >= 2 devices"):
        serve.main(["--dp", "2"])
