"""The port's hard-negative mining (repro_torch/mining, the loader's
injector and prefetch thread, the mined cells and launch/train.py's
``--negatives mined``) against the JAX package's (src/repro/mining,
src/repro/data/loader.py), following tests/test_mining.py, on tiny BERT
towers whose params are carried across with repro_torch/compat.py and on
the same numpy corpus.

Tolerances:
  * config checks, teleportation filtering, fallback ids, tables of the
    port against itself (sync, async, restored): exact;
  * one refresh against JAX's: the searches agree by ``topk_mismatch``
    (scores within ``score_atol`` = 1e-5 of the largest |score|, fp32 in
    another summation order; no id mismatch at a clear slot), and the
    published rows agree exactly wherever every search slot of the row is
    clear;
  * training trajectories with a sync miner: per-step loss within rtol
    1e-5 over 6 SGD steps (fp32, the StepProgram parity tolerance), and
    the same refresh rows and final table.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ContrastiveConfig as JConfig
from repro.core import RetrievalBatch as JBatch
from repro.core import build_step_program as jax_build
from repro.core import init_state as jax_init_state
from repro.data import loader as jloader
from repro.data.retrieval import SyntheticRetrievalCorpus as JCorpus
from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.mining import HardNegativeMiner as JMiner
from repro.mining import MinerConfig as JMinerConfig
from repro.mining import NegativeTable as JTable
from repro.mining import teleport_filter as jax_teleport_filter
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro.optim import chain as jchain
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro.retrieval.retriever import Retriever as JRetriever
from repro.runtime.trainer import PeriodicHook as JHook
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.compat import params_to_torch
from repro_torch.configs import dpr_bert_base as port_cells
from repro_torch.core.methods import build_step_program, init_state
from repro_torch.core.types import ContrastiveConfig, RetrievalBatch
from repro_torch.data.loader import (
    LoaderState,
    MinedNegativeInjector,
    PrefetchIterator,
    ShardedLoader,
)
from repro_torch.data.retrieval import SyntheticRetrievalCorpus
from repro_torch.kernels.fused_topk.ref import topk_mismatch
from repro_torch.launch import train as port_train
from repro_torch.launch.serve import tiny_bert
from repro_torch.mining import (
    HardNegativeMiner,
    MinerConfig,
    NegativeTable,
    NegativeTableBuffer,
    empty_table,
    teleport_filter,
)
from repro_torch.models.towers import make_bert_dual_encoder
from repro_torch.optim import chain, clip_by_global_norm, sgd
from repro_torch.retrieval import Retriever, RetrieverConfig
from repro_torch.retrieval.index import encode_corpus
from repro_torch.runtime.trainer import PeriodicHook, Trainer, TrainerConfig

N_CORPUS = 64
WAIT_S = 60.0  # bound on every join and event wait


def _corpora(seed=0):
    kw = dict(n_passages=N_CORPUS, q_len=16, p_len=32, seed=seed)
    return JCorpus(**kw), SyntheticRetrievalCorpus(**kw)


def _miner_kw(**kw):
    base = dict(refresh_every=3, top_k=8, n_negatives=2, depth_lo=1, depth_hi=8,
                sync=True, query_batch=24, encode_batch=32)
    base.update(kw)
    return base


def _jax_params(seed=0):
    return jax.device_get(jax_dual_encoder(jax_tiny_bert()).init(jax.random.PRNGKey(seed)))


def _port_miner(seed=0, **kw):
    _, corpus = _corpora(seed)
    enc = make_bert_dual_encoder(tiny_bert())
    miner = HardNegativeMiner(enc, MinerConfig(**_miner_kw(**kw)), queries=corpus.queries,
                              passages=corpus.passages, device="cpu")
    return miner, params_to_torch(_jax_params(seed), "cpu")


def _gated(miner):
    """Hold the miner's worker at the start of ``_mine`` until the returned
    event is set."""
    gate = threading.Event()
    orig = miner._mine

    def gated(p, s):
        assert gate.wait(timeout=WAIT_S)
        return orig(p, s)

    miner._mine = gated
    return gate


# ----------------------------------------------------------- config / table
CONFIGS = [
    {},
    dict(depth_lo=5, depth_hi=5),
    dict(depth_lo=-1),
    dict(top_k=4, depth_hi=8),
    dict(depth_lo=1, depth_hi=2, n_negatives=4),
    dict(n_negatives=0),
    dict(refresh_every=0),
    dict(margin=-0.1),
    dict(margin=0.5),
    dict(staleness_budget=-1),
    dict(staleness_budget=3),
    dict(query_batch=0),
    dict(top_k=64, depth_lo=10, depth_hi=40, n_negatives=30),
    dict(search_impl="fused", precision="bf16_banks"),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_validate_accepts_and_rejects_the_same_configs(kw):
    outcomes = []
    for cls in (JMinerConfig, MinerConfig):
        try:
            cls(**kw).validate()
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_config_has_the_jax_fields_and_defaults():
    port = {f.name: f.default for f in dataclasses.fields(MinerConfig)}
    assert port == {f.name: f.default for f in dataclasses.fields(JMinerConfig)}


def test_retriever_config_passes_the_same_fields_through():
    kw = dict(top_k=16, search_impl="fused", precision="bf16_banks", encode_batch=64)
    j, t = JMinerConfig(**kw).retriever_config(), MinerConfig(**kw).retriever_config()
    for field in ("top_k", "search_impl", "index_layout", "precision", "index_dtype",
                  "encode_batch", "dp_axis"):
        assert getattr(t, field) == getattr(j, field), field


def test_table_swap_is_shape_stable_and_immutable():
    buf = NegativeTableBuffer(empty_table(4, 2))
    t = NegativeTable(ids=np.zeros((4, 2), np.int32), step=1, version=1)
    assert buf.swap(t).version == 0 and buf.read() is t
    with pytest.raises(ValueError, match="shape changed"):
        buf.swap(NegativeTable(ids=np.zeros((4, 3), np.int32)))
    with pytest.raises(ValueError):  # published tables are read-only
        buf.read().ids[0, 0] = 7


def test_mined_cells_match_the_jax_cells():
    from repro.configs.dpr_bert_base import DPR_SHAPES

    for name, cell in (("paper_batch_mined", port_cells.PAPER_BATCH_MINED),
                       ("contaccum_mined", port_cells.CONTACCUM_MINED)):
        assert cell == DPR_SHAPES[name].params, name


# ------------------------------------------------------- teleportation band
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("band,margin,n_out", [((0, 5), 0.0, 3), ((1, 8), 0.0, 4),
                                               ((2, 6), 0.05, 4), ((0, 12), 0.2, 6)])
def test_teleport_filter_gives_the_same_ids(seed, band, margin, n_out):
    rng = np.random.default_rng(seed)
    q, k, n = 40, 12, 30
    ids = np.stack([rng.permutation(n)[:k] for _ in range(q)]).astype(np.int32)
    ids[rng.random((q, k)) < 0.1] = -1                     # empty slots
    scores = -np.sort(-rng.normal(size=(q, k)), axis=1).astype(np.float32)
    pick = ids[np.arange(q), rng.integers(0, k, q)]        # gold retrieved in about half the rows
    gold = np.where((rng.random(q) < 0.5) & (pick >= 0), pick, rng.integers(0, n, q))
    kw = dict(depth_lo=band[0], depth_hi=band[1], margin=margin, n_out=n_out)
    got = teleport_filter(ids, scores, gold, **kw)
    np.testing.assert_array_equal(got, jax_teleport_filter(ids, scores, gold, **kw))
    assert got.dtype == np.int32 and not (got == gold[:, None]).any()


def test_teleport_filter_band_and_margin():
    ids = np.array([[7, 0, 3, 9, 5, 2]])
    scores = np.array([[0.9, 0.8, 0.7, 0.6, 0.5, 0.4]], np.float32)
    gold = np.array([0])
    run = lambda lo, hi, m: teleport_filter(ids, scores, gold, depth_lo=lo, depth_hi=hi,
                                            margin=m, n_out=3).tolist()
    assert run(0, 5, 0.0) == [[3, 9, 5]]
    assert run(2, 4, 0.0) == [[9, 5, -1]]
    assert run(0, 5, 0.15) == [[9, 5, 2]]
    assert run(0, 5, 0.25) == [[5, 2, -1]]


# ------------------------------------------------- injector + loader state
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 123)])
def test_injector_fallback_ids_are_jax_s(seed, step):
    idx = np.random.default_rng(seed).permutation(N_CORPUS)[:16]
    ids = np.full((N_CORPUS, 3), -1, np.int32)
    ids[::2, 1] = np.arange(0, N_CORPUS, 2)[::-1]          # half the rows mined in slot 1
    table = NegativeTable(ids=ids, step=4, version=2)
    jtable = JTable(ids=ids, step=4, version=2)
    state, jstate = LoaderState(), jloader.LoaderState()
    got = MinedNegativeInjector(lambda: table, N_CORPUS, seed=seed, state=state).mined_ids(
        idx, gold=idx, step=step)
    want = jloader.MinedNegativeInjector(lambda: jtable, N_CORPUS, seed=seed,
                                         state=jstate).mined_ids(idx, gold=idx, step=step)
    np.testing.assert_array_equal(got, want)
    assert (got != idx[:, None]).all() and (got >= 0).all()
    assert state.to_dict() == jstate.to_dict() == {"epoch": 0, "step": 0, "mined_step": 4,
                                                   "mined_version": 2}


def test_injector_width_and_step_reshuffle():
    buf = NegativeTableBuffer(empty_table(N_CORPUS, 2))
    inj = MinedNegativeInjector(buf.read, N_CORPUS, n_negatives=3, seed=1)
    idx = np.arange(8)
    a, b = inj.mined_ids(idx, gold=idx, step=5), inj.mined_ids(idx, gold=idx, step=5)
    assert a.shape == (8, 3) and np.array_equal(a, b)
    assert not np.array_equal(a, inj.mined_ids(idx, gold=idx, step=6))


def test_loader_state_round_trips_mined_stamps():
    st = LoaderState(epoch=2, step=7, mined_step=40, mined_version=3)
    assert LoaderState.from_dict(st.to_dict()) == st
    legacy = LoaderState.from_dict({"epoch": 1, "step": 2})
    assert (legacy.mined_step, legacy.mined_version) == (-1, 0)


def test_prefetch_close_surfaces_unseen_worker_exception():
    consumed = threading.Event()
    n = {"calls": 0}

    def fn():
        n["calls"] += 1
        if n["calls"] == 1:
            return {"x": np.zeros(1)}
        consumed.wait(timeout=WAIT_S)
        raise RuntimeError("worker died after the consumer stopped reading")

    it = PrefetchIterator(fn, depth=1)
    assert "x" in next(it)
    consumed.set()
    deadline = time.monotonic() + WAIT_S
    while it._exc is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="worker died"):
        it.close()


def test_prefetch_delivers_in_order_and_close_does_not_replay():
    n = {"calls": 0}

    def fn():
        n["calls"] += 1
        if n["calls"] > 3:
            raise RuntimeError("boom")
        return n["calls"]

    it = PrefetchIterator(fn, depth=2)
    assert [next(it) for _ in range(3)] == [1, 2, 3]
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    it.close()  # already delivered: close stays quiet


# ------------------------------------------------------------ one refresh
def test_encode_corpus_takes_device_tokens():
    _, corpus = _corpora()
    enc = make_bert_dual_encoder(tiny_bert())
    params = params_to_torch(_jax_params(), "cpu")
    fn = lambda toks: enc.encode_passage(params, torch.as_tensor(np.asarray(toks)).long())
    want = encode_corpus(fn, corpus.passages[:20], batch=8)
    got = encode_corpus(lambda t: enc.encode_passage(params, t),
                        torch.from_numpy(corpus.passages[:20]).long(), batch=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("search_impl", ["dense", "fused"])
def test_one_sync_refresh_matches_jax(search_impl):
    jcorpus, corpus = _corpora()
    jparams = _jax_params()
    kw = _miner_kw(search_impl=search_impl)
    miner = HardNegativeMiner(make_bert_dual_encoder(tiny_bert()), MinerConfig(**kw),
                              queries=corpus.queries, passages=corpus.passages, device="cpu")
    table = miner.refresh(params_to_torch(jparams, "cpu"), step=7)
    jenc = jax_dual_encoder(jax_tiny_bert())
    jminer = JMiner(jenc, JMinerConfig(**dict(kw, search_impl="dense")),
                    queries=jcorpus.queries, passages=jcorpus.passages)
    jtable = jminer.refresh(jparams, step=7)
    assert (table.step, table.version) == (jtable.step, jtable.version) == (7, 1)

    # the searches: JAX's at k + 1 slots is the reference
    k = kw["top_k"]
    jr = JRetriever(jenc, jparams, dataclasses.replace(jminer.cfg.retriever_config(), top_k=k + 1))
    jr.build_index(jcorpus.passages)
    rid, rsc = jr.search(jcorpus.queries)
    ids, scores = miner.retriever.search(corpus.queries)
    score_atol = 1e-5 * float(np.abs(rsc).max())
    err, bad, clear = topk_mismatch(torch.from_numpy(scores), torch.from_numpy(ids),
                                    torch.from_numpy(rsc.copy()), torch.from_numpy(rid.copy()), score_atol)
    assert err <= score_atol and bad == 0 and clear >= 0.9 * ids.size, (err, bad, clear)

    # the tables: equal on every row whose search slots are all clear
    s = rsc.astype(np.float64)
    sep = (s[:, :-1] - s[:, 1:]) > 2 * score_atol
    rows_clear = sep.all(axis=1)
    assert rows_clear.sum() >= N_CORPUS // 2
    np.testing.assert_array_equal(table.ids[rows_clear], jtable.ids[rows_clear])


def test_miner_never_mines_gold():
    miner, params = _port_miner()
    table = miner.refresh(params, step=0)
    assert (table.ids >= 0).any()
    for i in range(table.n_queries):
        assert i not in table.ids[i]


def test_bert_compute_copy_gives_the_same_reps():
    _, corpus = _corpora()
    enc = make_bert_dual_encoder(tiny_bert(), precision="bf16_banks")
    params = params_to_torch(_jax_params(), "cpu")
    snap = enc.compute_copy(params)
    assert snap["passage"]["layers"]["w1"].dtype == torch.bfloat16
    assert snap["passage"]["embed"]["word"].dtype == torch.float32
    toks = torch.from_numpy(corpus.passages[:8]).long()
    for fn in (enc.encode_passage, enc.encode_query):
        torch.testing.assert_close(fn(snap, toks), fn(params, toks), rtol=0, atol=0)


# ---------------------------------------------------------- async pipeline
def test_async_matches_sync_at_refresh_barrier():
    m_sync, params = _port_miner(sync=True)
    m_async, _ = _port_miner(sync=False)
    t_sync = m_sync.refresh(params, step=7)
    assert m_async.refresh_async(params, step=7)
    m_async.wait()
    t_async = m_async.buffer.read()
    np.testing.assert_array_equal(t_sync.ids, t_async.ids)
    assert (t_sync.step, t_sync.version) == (t_async.step, t_async.version)


def test_a_write_to_the_params_after_refresh_async_does_not_reach_the_table():
    m_sync, params = _port_miner()
    want = m_sync.refresh(params, step=0).ids
    miner, params = _port_miner(sync=False)
    gate = _gated(miner)
    assert miner.refresh_async(params, 0)
    with torch.no_grad():                       # the optimizer's next in-place write
        for tower in params.values():
            for group in tower.values():
                for t in group.values():
                    t.mul_(-3.0)
    gate.set()
    miner.wait()
    np.testing.assert_array_equal(miner.buffer.read().ids, want)


def test_async_requests_skip_while_in_flight():
    miner, params = _port_miner(sync=False)
    gate = _gated(miner)
    assert miner.refresh_async(params, 0)
    assert miner.in_flight()
    assert not miner.refresh_async(params, 1)
    assert miner.skipped == 1
    gate.set()
    miner.wait()
    assert not miner.in_flight() and miner.refreshes == 1
    assert [r["version"] for r in miner.refresh_log] == [1]


def test_async_worker_exception_reraises_on_consumer_side():
    miner, params = _port_miner(sync=False)

    def boom(p, s):
        raise RuntimeError("index rebuild exploded")

    miner._mine = boom
    assert miner.refresh_async(params, 0)
    with pytest.raises(RuntimeError, match="index rebuild exploded"):
        miner.wait()
    del miner._mine  # the class implementation again
    miner.refresh(params, 1)
    assert miner.buffer.read().version == 1
    miner._mine = boom
    miner.refresh_async(params, 2)
    miner._thread.join(timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="exploded"):
        miner.refresh_async(params, 3)          # the next consumer call raises it
    miner.close()


def test_async_overlap_counts_training_steps():
    miner, params = _port_miner(sync=False)
    gate = _gated(miner)
    miner.refresh_async(params, step=10)
    for s in range(10, 15):
        miner.note_step(s)
    gate.set()
    miner.wait()
    assert miner.last_overlap == 4
    assert miner.refresh_log[-1]["steps_overlapped"] == 4
    assert set(miner.refresh_log[-1]) >= {"encode_s", "search_s", "filter_s", "wall_s"}


def test_checkpoint_save_ignores_in_flight_refresh_and_restores():
    miner, params = _port_miner(sync=False)
    t1 = miner.refresh(params, step=0)
    gate = _gated(miner)
    miner.refresh_async(params, step=5)
    saved = miner.state_to_save()
    assert saved["meta"].tolist() == [0, 1]
    gate.set()
    miner.wait()
    assert miner.buffer.read().version == 2
    restored, _ = _port_miner(sync=False)
    restored.load_saved_state(saved)
    t_r = restored.buffer.read()
    np.testing.assert_array_equal(t_r.ids, t1.ids)
    assert (t_r.step, t_r.version) == (0, 1)
    assert restored.refresh(params, step=9).version == 2


# ------------------------------------------------------ training trajectory
def _cell(name):
    if name == "contaccum_mined":
        return dict(method="contaccum", accumulation_steps=2, bank_size=16), None
    return dict(method="mined", accumulation_steps=1, bank_size=0), "mined"


def _jax_train(name, steps=6, seed=0):
    jcorpus, _ = _corpora(seed)
    enc = jax_dual_encoder(jax_tiny_bert())
    miner = JMiner(enc, JMinerConfig(**_miner_kw()), queries=jcorpus.queries,
                   passages=jcorpus.passages)
    loader = jloader.ShardedLoader(N_CORPUS, 16, seed=seed)
    inj = jloader.MinedNegativeInjector(miner.buffer.read, N_CORPUS, seed=seed,
                                        state=loader.state, on_step=miner.note_step)
    kw, negatives = _cell(name)
    cfg = JConfig(**kw, negatives=negatives, temperature=1.0)
    tx = jchain(jclip(2.0), jsgd(0.05))
    state = jax_init_state(jax.random.PRNGKey(seed), enc, tx, cfg)
    params0 = jax.device_get(state.params)

    def next_batch(step):
        idx = loader.next_indices()
        b = jcorpus.batch(idx)
        hard = np.concatenate([b["passage_hard"], jcorpus.passages[
            inj.mined_ids(idx, gold=idx, step=step)]], axis=1)
        return JBatch(jnp.asarray(b["query"]), jnp.asarray(b["passage_pos"]), jnp.asarray(hard))

    trainer = JTrainer(JTrainerConfig(total_steps=steps, log_every=1000),
                       jax.jit(jax_build(enc, tx, cfg).update), next_batch,
                       loader_state=loader.state, aux_state=miner,
                       hooks=[JHook(every=3, fn=miner.refresh_hook, prefix="mine/", name="mine")])
    _, report = trainer.run(state)
    miner.close()
    return params0, report, miner, loader


def _port_train(name, params0, steps=6, seed=0, ckpt_dir=None, sync=True):
    _, corpus = _corpora(seed)
    enc = make_bert_dual_encoder(tiny_bert())
    miner = HardNegativeMiner(enc, MinerConfig(**_miner_kw(sync=sync)), queries=corpus.queries,
                              passages=corpus.passages, device="cpu")
    loader = ShardedLoader(N_CORPUS, 16, seed=seed)
    inj = MinedNegativeInjector(miner.buffer.read, N_CORPUS, seed=seed,
                                state=loader.state, on_step=miner.note_step)
    kw, negatives = _cell(name)
    cfg = ContrastiveConfig(**kw, negatives=negatives, temperature=1.0)
    tx = chain(clip_by_global_norm(2.0), sgd(0.05))
    state = init_state(None, enc, tx, cfg, params=params_to_torch(params0, "cpu"), device="cpu")

    def next_batch(step):
        idx = loader.next_indices()
        b = corpus.batch(idx)
        hard = np.concatenate([b["passage_hard"], corpus.passages[
            inj.mined_ids(idx, gold=idx, step=step)]], axis=1)
        return RetrievalBatch(*(torch.from_numpy(np.asarray(x, np.int64))
                                for x in (b["query"], b["passage_pos"], hard)))

    trainer = Trainer(TrainerConfig(total_steps=steps, log_every=1000, checkpoint_dir=ckpt_dir,
                                    checkpoint_every=4),
                      build_step_program(enc, tx, cfg).update, next_batch,
                      loader_state=loader.state, aux_state=miner,
                      hooks=[PeriodicHook(every=3, fn=miner.refresh_hook, prefix="mine/",
                                          name="mine")])
    _, report = trainer.run(state)
    miner.close()
    return report, miner, loader


@pytest.mark.parametrize("name", ["contaccum_mined", "paper_batch_mined"])
def test_sync_trajectory_matches_jax(name):
    params0, jreport, jminer, jl = _jax_train(name)
    report, miner, loader = _port_train(name, params0)
    np.testing.assert_allclose([h["loss"] for h in report.history],
                               [h["loss"] for h in jreport.history], rtol=1e-5)
    mine_rows = [(h["step"], h["mine/table_version"], h["mine/refreshes"])
                 for h in report.history if "mine/table_version" in h]
    assert mine_rows == [(h["step"], h["mine/table_version"], h["mine/refreshes"])
                         for h in jreport.history if "mine/table_version" in h]
    assert mine_rows == [(2, 1.0, 1.0), (5, 2.0, 2.0)]
    np.testing.assert_array_equal(miner.buffer.read().ids, jminer.buffer.read().ids)
    assert loader.state.to_dict() == jl.state.to_dict()


def test_trainer_round_trips_miner_state_and_loader_stamps(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    params0 = _jax_params()
    _, m1, l1 = _port_train("paper_batch_mined", params0, steps=6, ckpt_dir=ckpt)
    t1 = m1.buffer.read()
    assert l1.state.mined_step >= 0 and t1.version == 2
    r2, m2, l2 = _port_train("paper_batch_mined", params0, steps=6, ckpt_dir=ckpt)
    assert r2.steps_run == 0
    t2 = m2.buffer.read()
    np.testing.assert_array_equal(t2.ids, t1.ids)
    assert (t2.step, t2.version) == (t1.step, t1.version)
    assert (l2.state.mined_step, l2.state.mined_version) == (
        l1.state.mined_step, l1.state.mined_version)


# -------------------------------------------------------------- launch/train
LAUNCH_FLAGS = ["--method", "contaccum", "--negatives", "mined", "--mine-every", "1",
          "--mine-topk", "8", "--mine-negatives", "2", "--total-batch", "16",
          "--local-batch", "8", "--bank", "32", "--corpus-size", "64"]


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_train_launcher_mines_on_the_cpu(sync, capsys):
    flags = LAUNCH_FLAGS + ["--steps", "2", "--device", "cpu"] + (["--mine-sync"] if sync else [])
    _, report = port_train.main(flags)
    out = capsys.readouterr().out
    rows = [h for h in report.history if "mine/table_version" in h]
    assert [h["step"] for h in rows] == [0, 1]
    assert f"mining: {2 if sync else 2 - int(rows[1]['mine/skipped'])} refreshes" in out
    if sync:
        assert [h["mine/table_staleness"] for h in rows] == [0.0, 0.0]
    assert np.isfinite([h["loss"] for h in report.history]).all()


def test_train_launcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks what happens without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(LAUNCH_FLAGS + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HardNegativeMiner(make_bert_dual_encoder(tiny_bert()), MinerConfig(),
                          queries=np.zeros((4, 8), np.int32), passages=np.zeros((4, 8), np.int32))


def test_retriever_takes_params_later_and_device_tokens():
    _, corpus = _corpora()
    enc = make_bert_dual_encoder(tiny_bert())
    r = Retriever(enc, None, RetrieverConfig(top_k=5, search_impl="fused"), device="cpu")
    r.params = params_to_torch(_jax_params(), "cpu")
    r.build_index(torch.from_numpy(corpus.passages))
    ids_t, sc_t = r.search(torch.from_numpy(corpus.queries[:10]))
    r.build_index(corpus.passages)
    ids_n, sc_n = r.search(corpus.queries[:10])
    np.testing.assert_array_equal(ids_t, ids_n)
    np.testing.assert_array_equal(sc_t, sc_n)


def test_cpu_runs_without_streams_or_graphs():
    from repro_torch.runtime.trainer import priority_stream

    miner, params = _port_miner()
    assert miner.stream is None and miner._graphs is None
    with priority_stream("cpu") as stream:
        assert stream is None
        assert miner.refresh(params, 0).version == 1
    assert set(miner.refresh_log[0]) == {"step", "version", "encode_s", "search_s", "filter_s",
                                         "wall_s", "steps_overlapped"}
