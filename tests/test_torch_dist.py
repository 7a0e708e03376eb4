"""The port's multi-rank training (core/dist.py, the sharded banks and the
ring-streamed loss) and its sharded serving index (retrieval/) against the
JAX package, on a 4-rank gloo group.

One group runs for the whole module (``torch.multiprocessing.spawn`` on a
FileStore under the test's temporary directory, one torch thread a rank;
tests/torch_dist_worker.py): ``DistCtx``'s collectives, every program case
below over 4 steps on each rank's rows of the global batch, and one loss
over sharded dual banks on both backends and both loss_comm settings. The
JAX side runs once, in this process, on one device: the global batch in
chunk-major order (``to_global_chunk_order``, as tests/test_distributed.py
does), dense loss, fp32.

Tolerances are the JAX package's own: against JAX, losses rtol 2e-4 and
params rtol 2e-3 / atol 2e-6 (tests/test_distributed.py); ring against
all-gather, losses rtol 2e-5 / atol 2e-6 and params rtol 1e-4 / atol 1e-6
(tests/test_ring_parity.py, fp32). The one-loss cases hold the loss to 2e-5 and
each gradient to 2e-5 of its largest |g| plus 2e-6.

The sharded index (N = 93 rows of tiny-BERT reps over the 4 ranks: 96
padded rows, 24 a rank) is held bit for bit to a replicated Retriever in
each rank, its blocks, ids and scores, and to JAX's replicated Retriever at
tests/test_torch_retrieval.py's tolerances (fp32: ids equal, scores 1e-5;
bf16_banks: the search on the port's own bf16 reps); ties across shards
and empty slots exactly, on integer vectors.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ContrastiveConfig as JConfig
from repro.core import RetrievalBatch as JBatch
from repro.core import build_step_program as jax_build
from repro.core import init_state as jax_init_state
from repro.core.loss import ExtraColumns as JExtraColumns
from repro.core.loss import ExtraRows as JExtraRows
from repro.core.dist import DistCtx as JDistCtx
from repro.core.loss import contrastive_loss as jax_contrastive_loss
from repro.data.retrieval import SyntheticRetrievalCorpus as JaxCorpus
from repro.kernels.fused_topk.ops import fused_topk_scores
from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro.optim import chain as jchain
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro.retrieval import IndexStore as JIndexStore
from repro.retrieval import Retriever as JaxRetriever
from repro.retrieval import RetrieverConfig as JaxRetrieverConfig
from repro_torch.core.precision import NEG_INF
from repro_torch.retrieval import merge_shard_candidates

import torch_dist_worker
from helpers import make_batch, make_mlp_encoder

D = 4
B = 32
K = 2
STEPS = 4
JAX_TOL = dict(loss=dict(rtol=2e-4), params=dict(rtol=2e-3, atol=2e-6))
RING_TOL = dict(loss=dict(rtol=2e-5, atol=2e-6), params=dict(rtol=1e-4, atol=1e-6))

#: the six compositions of tests/test_distributed.py and dpr_xdev (whose
#: single-device twin is dpr); bank sizes from there: contaccum's 16 wraps
#: mid-trajectory, the rep_cache banks of 128 hold every pushed row
COMPOSITIONS = {
    "dpr": dict(method="dpr"),
    "grad_accum": dict(method="grad_accum", accumulation_steps=K),
    "grad_cache": dict(method="grad_cache", accumulation_steps=K),
    "contaccum": dict(method="contaccum", accumulation_steps=K, bank_size=16),
    "contcache": dict(method="contcache", accumulation_steps=K, bank_size=128),
    "prebatch_cache": dict(method="prebatch_cache", accumulation_steps=K, bank_size=128),
    "dpr_xdev": dict(method="dpr_xdev"),
}
JAX_TWIN = {"dpr_xdev": "dpr"}
#: sharded banks (tests/test_distributed.py:247) and the ring cases
#: (tests/test_ring_parity.py): bank 24 (6 slots a rank) wraps unevenly
SHARDED = [("contaccum", 16), ("contcache", 128)]
RING = [("contaccum", 16), ("contaccum", 24), ("contcache", 128)]
BACKENDS = ("dense", "fused")
#: the sharded index (tests/test_retrieval.py:354 at 4 ranks): 93 % 4 != 0
SERVE_LAYOUTS = [("fp32", "dense"), ("bf16_banks", "fused")]
SERVE_CORPUS = dict(n_passages=93, q_len=16, p_len=32, seed=1)
SERVE_RETRIEVER = dict(top_k=9, encode_batch=32, score_block=16)
N_QUERIES = 17
ROWS, PER_RANK = 96, 24
SERVE_BATCHES = [8, 8, 4]          # 20 requests queued before the server starts
#: ties: 10 integer rows over 4 ranks (12 padded, 3 a rank), k past the valid rows
TIE_ROWS, TIE_K = 10, 12


def _bank_case(method, bank, impl, comm="all_gather"):
    return dict(method=method, accumulation_steps=K, bank_size=bank, loss_impl=impl,
                shard_banks=True, loss_comm=comm)


def _programs():
    progs = dict(COMPOSITIONS)
    for method, bank in RING:       # SHARDED is a part of RING
        for impl in BACKENDS:
            for comm in ("all_gather", "ring"):
                progs[f"{comm}/{method}{bank}/{impl}"] = _bank_case(method, bank, impl, comm)
    return progs


def _batches():
    return [tuple(None if x is None else np.asarray(x)
                  for x in make_batch(jax.random.PRNGKey(100 + i), B, n_hard=1))
            for i in range(STEPS)]


def to_global_chunk_order(batch, k):
    """The single-device twin of D ranks' local chunks: global chunk j is
    the union over ranks of their j-th local chunk, the (D, K, lk) ->
    (K, D, lk) transpose (tests/test_distributed.py:40-58)."""
    if k == 1:
        return batch

    def perm(x):
        lk = x.shape[0] // (D * k)
        y = x.reshape((D, k, lk) + x.shape[1:]).swapaxes(0, 1)
        return y.reshape(x.shape)

    return tuple(None if x is None else perm(x) for x in batch)


def _jax_trajectory(case, params0, batches):
    case = dict(case, method=JAX_TWIN.get(case["method"], case["method"]))
    cfg = JConfig(**case, temperature=1.0, grad_clip_norm=2.0)
    tx = jchain(jclip(cfg.grad_clip_norm), jsgd(0.05))
    enc = make_mlp_encoder()
    state = jax_init_state(jax.random.PRNGKey(0), enc, tx, cfg, params=params0)
    update = jax.jit(jax_build(enc, tx, cfg).update)
    metrics = []
    for b in batches:
        state, m = update(state, JBatch(*to_global_chunk_order(b, cfg.accumulation_steps)))
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return {"metrics": metrics, "params": jax.device_get(state.params),
            "bank_q": jax.device_get(state.bank_q), "bank_p": jax.device_get(state.bank_p)}


def _loss_spec():
    rng = np.random.default_rng(3)
    b, h, c, d = 8, 1, 12, 8
    q = rng.normal(size=(b, d)).astype(np.float32)
    bank_valid = np.ones((c,), bool)
    bank_valid[[1, 6, 10, 11]] = False
    bank = {}
    for name in ("bank_q", "bank_p"):
        bank[name] = {"buf": rng.normal(size=(c, d)).astype(np.float32), "valid": bank_valid,
                      "age": np.zeros((c,), np.int32)}
    bank["bank_q"]["valid"] = bank_valid.copy()
    bank["bank_q"]["valid"][3] = False            # one slot valid in M_p only
    return {"q": q, "pp": (q + 0.5 * rng.normal(size=(b, d))).astype(np.float32),
            "ph": rng.normal(size=(b * h, d)).astype(np.float32),
            **bank, "temperature": 0.7}


def _jax_loss(spec):
    bq, bp = spec["bank_q"], spec["bank_p"]
    c = bq["buf"].shape[0]

    def loss(q, pp, ph, bank_p):
        return jax_contrastive_loss(
            q, pp, ph,
            extra_cols=JExtraColumns(reps=bank_p, valid=jnp.asarray(bp["valid"])),
            extra_rows=JExtraRows(reps=jnp.asarray(bq["buf"]),
                                  labels=jnp.arange(c, dtype=jnp.int32),
                                  weight=jnp.asarray(bq["valid"] & bp["valid"], jnp.float32)),
            temperature=spec["temperature"],
        )

    (value, aux), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(spec[k]) for k in ("q", "pp", "ph")), jnp.asarray(bp["buf"]))
    return {"loss": float(value), "accuracy": float(aux.accuracy),
            "n_negatives": float(aux.n_negatives),
            **dict(zip(("dq", "dpp", "dph", "dbank_p"), (np.asarray(g) for g in grads)))}


def _serve_spec():
    layouts = {lay: jax.device_get(jax_dual_encoder(jax_tiny_bert(), precision=lay[0]).init(
        jax.random.PRNGKey(5))) for lay in SERVE_LAYOUTS}
    rng = np.random.default_rng(4)
    p = rng.integers(-2, 3, size=(TIE_ROWS, 8)).astype(np.float32)
    p[7], p[9] = p[1], p[4]              # rank 2's row = rank 0's, rank 3's = rank 1's
    q = rng.integers(-2, 3, size=(6, 8)).astype(np.float32)
    return {"corpus": SERVE_CORPUS, "n_queries": N_QUERIES, "layouts": layouts,
            "retriever": SERVE_RETRIEVER, "serve_layout": ("bf16_banks", "fused"),
            "serve": {"max_batch": 8, "n": sum(SERVE_BATCHES)},
            "eval_ks": (1, 9), "ties": {"p": p, "q": q, "k": TIE_K, "batch": 4}}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params0 = jax.device_get(make_mlp_encoder().init(jax.random.PRNGKey(0)))
    return {"params0": params0, "batches": _batches(), "programs": _programs(),
            "loss": _loss_spec(),
            "x": rng.normal(size=(D, 2, 3)).astype(np.float32),
            "c": rng.normal(size=(D, 2 * D, 3)).astype(np.float32),
            "serve": _serve_spec()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every rank's results: one 4-rank gloo group for the module."""
    return torch_dist_worker.spawn(tmp_path_factory.mktemp("gloo"), inputs, D)


@pytest.fixture(scope="module")
def jax_loss(inputs):
    return _jax_loss(inputs["loss"])


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX single-device trajectories, by the case they are the twin of."""
    runs = {}

    def get(case):
        case = {k: v for k, v in case.items()
                if k not in ("loss_impl", "shard_banks", "loss_comm")}
        key = repr(sorted(case.items()))
        if key not in runs:
            runs[key] = _jax_trajectory(case, inputs["params0"], inputs["batches"])
        return runs[key]

    return get


def _close_params(got, want, what, **tol):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a, np.float32),
                                                np.asarray(b, np.float32), err_msg=what, **tol),
        got, want)


def _losses(run):
    return [m["loss"] for m in run["metrics"]]


def _global_bank(ranks, name, bank):
    """The ranks' shards of a sharded bank, shard-major: JAX's global ring."""
    shards = [r[name][bank] for r in ranks]
    return {key: np.concatenate([s[key] for s in shards]) for key in ("buf", "valid", "age")} | {
        "head": shards[0]["head"]}


# ------------------------------------------------------------------ DistCtx
def test_dist_ctx_describes_the_group(ranks):
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        assert c["is_distributed"] and c["count"] == D and c["index"] == rank
        assert c["perm"] == [(i, (i + 1) % D) for i in range(D)]
        # one call of each kind, counted once
        assert c["collectives"] == {"all_gather": 1, "all_reduce": 1, "ring": 1, "broadcast": 1}


def test_broadcast_from_any_rank(ranks):
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        assert c["broadcast"].tolist() == [0, 7]
        assert c["broadcast_kept"].tolist() == [rank, 7]
        assert c["broadcast_bool"].tolist() == [True, False]


def test_gather_value_and_gradient(ranks, inputs):
    x, c = inputs["x"], inputs["c"]
    want = x.reshape(D * 2, 3)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["collectives"]["gather"], want)
        # the sum of every rank's cotangent on this rank's slice
        np.testing.assert_allclose(r["collectives"]["gather_grad"],
                                   c[:, 2 * rank : 2 * rank + 2].sum(0), rtol=1e-6, atol=1e-6)
        masks = np.array([[i % 2 == 0, True, i == 3] for i in range(D)])
        np.testing.assert_array_equal(r["collectives"]["gather_bool"], masks.ravel())


def test_psum_tree(ranks, inputs):
    for r in ranks:
        got = r["collectives"]["psum_tree"]
        np.testing.assert_allclose(got["a"], inputs["x"].sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["b0"], np.full((3,), sum(range(1, D + 1)), np.float32))
        assert got["b1"] == sum(range(D))


def test_ring_rotate_value_and_cotangent_ownership(ranks):
    """tests/test_ring_parity.py:309 on the port: rank j receives rank
    (j - 1)'s value; the cotangent written on rank j rides back to the
    shard's owner, so rank i's gradient is rank (i + 1)'s (i + 2); D
    rotations hand every shard back."""
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        assert c["rotate"].tolist() == [float((rank - 1) % D)]
        assert c["rotate_grad"].tolist() == [float((rank + 1) % D + 1)]
        assert c["full_circle"][0].tolist() == [float(rank)]
        assert c["full_circle"][1].tolist() == [rank == 1]


# ------------------------------------------------------------- programs
@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_composition_at_d4_matches_jax_single_device(name, ranks, jax_runs):
    want = jax_runs(COMPOSITIONS[name])
    for rank, r in enumerate(ranks):
        got = r[name]
        np.testing.assert_allclose(_losses(got), _losses(want), err_msg=f"{name} rank {rank}",
                                   **JAX_TOL["loss"])
        _close_params(got["params"], want["params"], f"{name} rank {rank}", **JAX_TOL["params"])
        assert got["step"] == STEPS


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("method,bank", SHARDED)
def test_sharded_banks_match_jax_single_device(method, bank, impl, ranks, jax_runs):
    """tests/test_distributed.py:247 on the port: losses, fills, params and
    the shard-major union of the banks against JAX's replicated ring
    (slot-exact for the scan path; a row set for rep_cache, whose pushes
    are rank-major)."""
    name = f"all_gather/{method}{bank}/{impl}"
    want = jax_runs(_bank_case(method, bank, impl))
    for rank, r in enumerate(ranks):
        got = r[name]
        np.testing.assert_allclose(_losses(got), _losses(want), err_msg=name, **JAX_TOL["loss"])
        np.testing.assert_array_equal(
            [(m["bank_fill_q"], m["bank_fill_p"]) for m in got["metrics"]],
            [(m["bank_fill_q"], m["bank_fill_p"]) for m in want["metrics"]], err_msg=name)
        _close_params(got["params"], want["params"], name, **JAX_TOL["params"])
        assert got["bank_q"]["buf"].shape[0] == bank // D
    for bank_name in ("bank_q", "bank_p"):
        g, w = _global_bank(ranks, name, bank_name), want[bank_name]
        assert int(g["head"]) == int(w.head)
        r_got, r_want = g["buf"][g["valid"]], np.asarray(w.buf)[np.asarray(w.valid)]
        if method == "contaccum":
            np.testing.assert_array_equal(g["valid"], np.asarray(w.valid), err_msg=name)
            np.testing.assert_array_equal(g["age"], np.asarray(w.age), err_msg=name)
        else:
            r_got, r_want = r_got[np.lexsort(r_got.T)], r_want[np.lexsort(r_want.T)]
        np.testing.assert_allclose(r_got, r_want, rtol=2e-4, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("method,bank", RING)
def test_ring_matches_all_gather_trajectories(method, bank, impl, ranks):
    """tests/test_ring_parity.py:301 on the port: the same sharded banks
    with loss_comm='ring' and 'all_gather', through bank wrap and partial
    fill: losses, accuracies, n_negatives, params and the banks."""
    for r in ranks:
        ag = r[f"all_gather/{method}{bank}/{impl}"]
        ring = r[f"ring/{method}{bank}/{impl}"]
        np.testing.assert_allclose(_losses(ring), _losses(ag), **RING_TOL["loss"])
        assert [m["n_negatives"] for m in ring["metrics"]] == \
            [m["n_negatives"] for m in ag["metrics"]]
        np.testing.assert_allclose([m["accuracy"] for m in ring["metrics"]],
                                   [m["accuracy"] for m in ag["metrics"]], atol=1e-6)
        _close_params(ring["params"], ag["params"], "ring", **RING_TOL["params"])
        for bn in ("bank_q", "bank_p"):
            assert int(ring[bn]["head"]) == int(ag[bn]["head"])
            np.testing.assert_array_equal(ring[bn]["valid"], ag[bn]["valid"])


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("method,bank", RING)
def test_ring_matches_jax_single_device(method, bank, impl, ranks, jax_runs):
    want = jax_runs(_bank_case(method, bank, impl))
    for r in ranks:
        got = r[f"ring/{method}{bank}/{impl}"]
        np.testing.assert_allclose(_losses(got), _losses(want), **JAX_TOL["loss"])
        _close_params(got["params"], want["params"], "ring", **JAX_TOL["params"])


# ---------------------------------------------------------- one loss eval
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("comm", ["all_gather", "ring"])
def test_sharded_bank_loss_and_gradients_match_jax(comm, backend, ranks, jax_loss):
    """One loss over sharded dual banks (some slots invalid) whose passage
    shards need a gradient: the global loss, accuracy and n_negatives, and
    each rank's gradients w.r.t. its queries, positives, hard negatives and
    bank shard against the slices of JAX's single-device gradients. On the
    ring the bank's dP rides home with its shard."""
    want = jax_loss
    losses = []
    for rank, r in enumerate(ranks):
        got = r[f"loss/{comm}/{backend}"]
        losses.append(got["loss_dev"])
        for key in ("loss", "accuracy", "n_negatives"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-5, err_msg=key)
        for key in ("dq", "dpp", "dph", "dbank_p"):
            w = torch_dist_worker.local_rows(want[key], rank, D)
            np.testing.assert_allclose(got[key], w, rtol=0,
                                       atol=2e-5 * np.abs(want[key]).max() + 2e-6, err_msg=key)
    # the ranks' shares sum to the global loss
    np.testing.assert_allclose(sum(losses), want["loss"], rtol=2e-5)


def test_xdev_cells_match_the_jax_cells():
    from repro.configs.dpr_bert_base import DPR_SHAPES
    from repro_torch.configs import dpr_bert_base as port_cells

    for name, cell in (("contaccum_xdev", port_cells.CONTACCUM_XDEV),
                       ("contaccum_xdev_ring", port_cells.CONTACCUM_XDEV_RING),
                       ("contcache_xdev", port_cells.CONTCACHE_XDEV)):
        assert cell == DPR_SHAPES[name].params, name


# ------------------------------------------------------ the sharded index
@pytest.mark.parametrize("layout", SERVE_LAYOUTS)
def test_sharded_index_layout(layout, ranks):
    """Each rank holds only its 24-row block of the 96 padded rows, bit-equal
    to the same rows of the replicated store (zeros past row 93, masked);
    bytes_per_device x 4 is the padded matrix's bytes."""
    itemsize = 4 if layout[0] == "fp32" else 2
    for rank, r in enumerate(ranks):
        st, full = r["serve"][layout]["store"], r["serve"][layout]["replicated"]
        assert (full["rows"], full["shards"], full["shard"]) == (93, 1, None)
        assert (st["n_total"], st["shards"], st["shard"], st["rows"], st["rows_per_shard"]) == \
            (93, D, rank, ROWS, PER_RANK)
        assert st["reps"].shape == (PER_RANK, 64)
        lo, hi = rank * PER_RANK, min((rank + 1) * PER_RANK, 93)
        np.testing.assert_array_equal(st["reps"][: hi - lo], full["reps"][lo:hi])
        assert not st["reps"][hi - lo :].any()
        np.testing.assert_array_equal(st["row_valid"], np.arange(lo, lo + PER_RANK) < 93)
        assert st["bytes_per_device"] * D == ROWS * 64 * itemsize


@pytest.mark.parametrize("layout", SERVE_LAYOUTS)
def test_sharded_search_equals_replicated_bit_for_bit(layout, ranks):
    for r in ranks:
        got = r["serve"][layout]
        assert got["ids"].shape == (N_QUERIES, 9) and got["ids"].dtype == np.int32
        assert ((got["ids"] >= 0) & (got["ids"] < 93)).all()
        np.testing.assert_array_equal(got["ids"], got["replicated_ids"])
        np.testing.assert_array_equal(got["scores"], got["replicated_scores"])
        np.testing.assert_array_equal(got["ids"], ranks[0]["serve"][layout]["ids"])


@pytest.mark.parametrize("layout", SERVE_LAYOUTS)
def test_sharded_search_matches_jax(layout, ranks, inputs):
    """Against JAX's replicated Retriever on the same params: fp32 ids equal
    and scores within 1e-5; bf16 towers to bf16 rounding, then the search
    on the port's own bf16 reps (tests/test_torch_retrieval.py:180)."""
    precision, impl = layout
    corpus = JaxCorpus(**SERVE_CORPUS)
    queries = corpus.queries[:N_QUERIES]
    jr = JaxRetriever(jax_dual_encoder(jax_tiny_bert(), precision=precision),
                      inputs["serve"]["layouts"][layout],
                      JaxRetrieverConfig(search_impl=impl, precision=precision, block_q=8,
                                         block_n=16, **SERVE_RETRIEVER))
    jr.build_index(corpus.passages)
    ji, js = jr.search(queries)
    port = ranks[0]["serve"][layout]
    if precision != "fp32":
        jq = np.asarray(jr.encoder.encode_query(jr.params, jnp.asarray(queries)).astype(jnp.float32))
        np.testing.assert_allclose(port["q_reps"], jq, rtol=0, atol=0.05)
        np.testing.assert_allclose(port["replicated"]["reps"],
                                   np.asarray(jr.index.reps.astype(jnp.float32)), rtol=0, atol=0.05)
        js, ji = fused_topk_scores(jnp.asarray(port["q_reps"]).astype(jnp.bfloat16),
                                   jnp.asarray(port["replicated"]["reps"]).astype(jnp.bfloat16),
                                   9, block_q=8, block_n=16)
    for r in ranks:
        np.testing.assert_array_equal(r["serve"][layout]["ids"], np.asarray(ji))
        np.testing.assert_allclose(r["serve"][layout]["scores"], np.asarray(js),
                                   rtol=1e-5, atol=1e-5)


def _shard_candidates(scores, valid, k, d):
    """Each of d shards' stable top-k over its row block of (Q, N) scores,
    ids global: (NEG_INF, -1) past a shard's valid rows."""
    q, n = scores.shape
    per = n // d
    out_s = np.full((d, q, k), NEG_INF, np.float32)
    out_i = np.full((d, q, k), -1, np.int32)
    for r in range(d):
        blk = np.where(valid[r * per : (r + 1) * per], scores[:, r * per : (r + 1) * per], NEG_INF)
        order = np.argsort(-blk, axis=1, kind="stable")[:, :k]
        top = np.take_along_axis(blk, order, axis=1)
        m = top.shape[1]
        out_s[r, :, :m] = top
        out_i[r, :, :m] = np.where(top > NEG_INF / 2, order + r * per, -1)
    return out_s, out_i


@pytest.mark.parametrize("case", ["ties_across_shards", "k_exceeds_valid"])
def test_merge_matches_jax_merge_shards(case):
    """merge_shard_candidates against JAX's Retriever._merge_shards (the
    psum of a zeroed (Q, D, k) buffer, then lax.top_k) run under
    jax.vmap(axis_name="data") over the 4 shards, and against the stable
    top-k of the whole score matrix."""
    rng = np.random.default_rng(11)
    n, q, k = 4 * 5, 6, 4
    scores = rng.integers(-1, 2, size=(q, n)).astype(np.float32)   # many ties
    valid = np.ones((n,), bool)
    if case == "k_exceeds_valid":
        k = 9
        valid[:] = False
        valid[[2, 5, 11, 13, 19]] = True            # 5 valid rows, 3 shards hold some
    cand_s, cand_i = _shard_candidates(scores, valid, k, 4)
    got_s, got_i = merge_shard_candidates(torch.from_numpy(cand_s), torch.from_numpy(cand_i), k)

    def jax_merge(s, i):
        return JaxRetriever._merge_shards(SimpleNamespace(shards=4), s, i,
                                          jax.lax.axis_index("data"), JDistCtx("data"))

    js, ji = jax.vmap(jax_merge, axis_name="data")(jnp.asarray(cand_s), jnp.asarray(cand_i))
    for shard in range(4):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji[shard]))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(js[shard]))
    want_s, want_i = _shard_candidates(scores, valid, k, 1)
    np.testing.assert_array_equal(got_i.numpy(), want_i[0])
    np.testing.assert_array_equal(got_s.numpy(), want_s[0])
    if case == "k_exceeds_valid":
        assert (got_i[:, 5:] == -1).all() and (got_s[:, 5:] == NEG_INF).all()


@pytest.mark.parametrize("impl", BACKENDS)
def test_sharded_search_ties_and_empty_slots_match_jax(impl, ranks, inputs):
    """Integer rows, two of them duplicated across shards, 12 slots for 10
    valid rows (each rank 3 rows, rank 3 one real and two padding): every
    rank's sharded search equals JAX's replicated one exactly, the lower
    global id first in each tie and -1 in the empty slots."""
    t = inputs["serve"]["ties"]
    jr = JaxRetriever(make_mlp_encoder(), None,
                      JaxRetrieverConfig(top_k=TIE_K, search_impl=impl, score_block=16,
                                         block_q=8, block_n=16),
                      index=JIndexStore(reps=jnp.asarray(t["p"]),
                                        row_valid=jnp.ones((TIE_ROWS,), bool), n_total=TIE_ROWS))
    ji, js = (np.asarray(x) for x in jr.search_reps(jnp.asarray(t["q"])))
    assert (ji[:, TIE_ROWS:] == -1).all()
    for row in ji:                       # both copies returned, the lower id first
        pos = {int(i): j for j, i in enumerate(row)}
        assert pos[1] < pos[7] and pos[4] < pos[9]
    for rank, r in enumerate(ranks):
        got = r["serve"]["ties", impl]
        assert got["store"]["rows_per_shard"] == 3 and got["store"]["shard"] == rank
        np.testing.assert_array_equal(got["ids"], ji)
        np.testing.assert_array_equal(got["scores"], js)


def test_serving_loop_across_ranks(ranks):
    """Requests through rank 0's server give the replicated Retriever's
    answers for the same padded batches; each batch costs every rank one
    broadcast and two all-gathers (scores, ids); the stop word is one more
    broadcast and ends every follower. The wrong role is refused on every
    rank before any collective."""
    lead = ranks[0]["serve"]["serve"]
    b = len(SERVE_BATCHES)
    assert lead["batch_sizes"] == SERVE_BATCHES and not lead["alive"]
    np.testing.assert_array_equal(lead["ids"], lead["replicated_ids"])
    np.testing.assert_array_equal(lead["scores"], lead["replicated_scores"])
    each = {"all_gather": 2 * b, "all_reduce": 0, "ring": 0}
    assert lead["collectives_during"] == {**each, "broadcast": b}
    assert lead["collectives"] == {**each, "broadcast": b + 1}
    for r in ranks[1:]:
        follower = r["serve"]["serve"]
        assert follower["served"] == b
        assert follower["collectives"] == {**each, "broadcast": b + 1}
    # rank 0 cannot follow, another rank cannot serve, and a server needs q_len
    for r in ranks:
        role, q_len = r["serve"]["serve"]["refused"]
        assert "rank 0 of a sharded Retriever runs the server" in role
        assert "needs q_len" in q_len


@pytest.mark.parametrize("case,held,searched", [
    ("sharded_given_every_row", "every row", "sharded Retriever searches block {r} of 4"),
    ("sharded_given_another_block", "block {n} of 4", "sharded Retriever searches block {r} of 4"),
    ("replicated_given_a_block", "block {r} of 4", "replicated Retriever searches every row"),
])
def test_search_refuses_an_index_of_another_layout(case, held, searched, ranks):
    """A store set from outside (``index=``) is held to the Retriever's
    layout: a sharded search over every row would return each id D times,
    a replicated one over a block would miss the other rows."""
    for rank, r in enumerate(ranks):
        fmt = dict(r=rank, n=(rank + 1) % D)
        assert r["serve"]["mismatch"][case] == (
            f"the index holds {held.format(**fmt)}, but this {searched.format(**fmt)}")


#: the idle server: 2 gloo ranks whose group times out after 3 s, no
#: request for 6 s, a keep-alive word every 0.25 s
IDLE = dict(timeout_s=3, idle_s=6.0, keepalive_s=0.25, max_batch=4,
            corpus=dict(n_passages=32, q_len=16, p_len=32, seed=2))


def test_idle_sharded_server_outlives_the_group_timeout(tmp_path):
    """Followers wait for the next batch inside a broadcast that the group's
    timeout bounds; the server's keep-alive words, skipped by the followers,
    keep an idle gap twice that timeout from ending the ranks. The one
    request after it gets the replicated answer, and every rank counts the
    same broadcasts: the keep-alives, the batch and the stop word."""
    lead, follower = torch_dist_worker.spawn_idle(tmp_path, IDLE, 2)
    assert follower["served"] == 1 and lead["batch_sizes"] == [1] and not lead["alive"]
    np.testing.assert_array_equal(lead["ids"], lead["want_ids"])
    np.testing.assert_array_equal(lead["scores"], lead["want_scores"])
    keepalives = lead["collectives"]["broadcast"] - 2
    assert keepalives >= IDLE["idle_s"] / IDLE["timeout_s"]
    assert lead["collectives"] == follower["collectives"] == {
        "all_gather": 2, "all_reduce": 0, "ring": 0, "broadcast": keepalives + 2}


def test_evaluate_topk_through_the_sharded_retriever(ranks):
    want = ranks[0]["serve"]["eval_replicated"]
    assert set(want) == {"top@1", "top@9", "recall@1", "recall@9"}
    for r in ranks:
        assert r["serve"]["eval"] == r["serve"]["eval_replicated"] == want
