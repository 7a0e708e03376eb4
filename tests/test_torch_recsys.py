"""The port's recsys family (models/recsys.py, data/recsys.py,
configs/base.py with the four recsys configs, and launch/steps.py) against
the JAX package on the same numpy inputs, JAX params carried across with
compat.py.

Tolerances: fp32 values and gradients to 1e-5 relative (the same ops, sums
in another order); the three train steps as stated at that test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import RECSYS_SHAPES as JAX_RECSYS_SHAPES
from repro.data.recsys import ClickLogGenerator as JaxClickLogGenerator
from repro.launch import steps as jax_steps
from repro.models import recsys as J
from repro.optim.adamw import apply_updates as jax_apply_updates
from repro.optim.schedules import linear_warmup_linear_decay as jax_schedule
from repro_torch.common.treemath import tree_leaves, tree_map
from repro_torch.compat import params_to_numpy, params_to_torch
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import CRITEO_VOCABS, RECSYS_SHAPES
from repro_torch.data.recsys import ClickLogGenerator
from repro_torch.launch import steps
from repro_torch.models import recsys as T
from repro_torch.optim.schedules import linear_warmup_linear_decay

RTOL, ATOL = 1e-5, 1e-6

RECSYS_CASES = [
    dict(name="dlrm-ut", n_dense=4, vocab_sizes=(50, 30, 20), embed_dim=8,
         interaction="dot", bot_mlp=(16, 8), top_mlp=(16, 8, 1)),
    dict(name="dcn-ut", n_dense=4, vocab_sizes=(50, 30, 20), embed_dim=8,
         interaction="cross", n_cross_layers=2, top_mlp=(16, 8)),
    dict(name="deepfm-ut", n_dense=0, vocab_sizes=(50, 30, 20, 10), embed_dim=6,
         interaction="fm", top_mlp=(16, 16)),
]
IDS = [c["name"] for c in RECSYS_CASES]


def _setup(kw, b=16, seed=0):
    jc, tc = J.RecsysConfig(**kw), T.RecsysConfig(**kw)
    jp = jax.device_get(J.init_recsys(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, jc.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, b) for v in jc.vocab_sizes], 1).astype(np.int32)
    sparse[0] = np.array(jc.vocab_sizes) - 1          # each field's last row: still in range
    labels = (rng.random(b) < 0.3).astype(np.float32)
    return jc, tc, jp, params_to_torch(jp, "cpu"), dense, sparse, labels


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", RECSYS_CASES, ids=IDS)
def test_lookup_forward_and_loss_match_jax(kw):
    jc, tc, jp, tp, dense, sparse, labels = _setup(kw)
    td, ts, tl = map(torch.from_numpy, (dense, sparse, labels))
    _close(T.embedding_lookup(tp, tc, ts).numpy(), J.embedding_lookup(jp, jc, sparse))
    _close(T.forward(tp, tc, td, ts).numpy(), J.forward(jp, jc, dense, sparse))
    loss, aux = T.bce_loss(tp, tc, td, ts, tl)
    jloss, jaux = J.bce_loss(jp, jc, dense, sparse, labels)
    _close(loss.item(), jloss)
    assert aux["accuracy"].item() == float(jaux["accuracy"])


@pytest.mark.parametrize("kw", RECSYS_CASES, ids=IDS)
def test_loss_gradients_match_jax(kw):
    jc, tc, jp, tp, dense, sparse, labels = _setup(kw, seed=1)
    want = jax.grad(lambda p: J.bce_loss(p, jc, dense, sparse, labels)[0])(jp)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, _ = T.bce_loss(leaves, tc, *map(torch.from_numpy, (dense, sparse, labels)))
    loss.backward()
    want_leaves = jax.tree_util.tree_leaves(want)
    got = tree_leaves(tree_map(lambda t: t.grad, leaves))
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("kw", RECSYS_CASES, ids=IDS)
def test_score_candidates_match_jax_and_forward(kw):
    jc, tc, jp, tp, dense, sparse, _ = _setup(kw, seed=2)
    cands = np.arange(10, dtype=np.int32)
    got = T.score_candidates(tp, tc, torch.from_numpy(dense[:1]), torch.from_numpy(sparse[:1]),
                             torch.from_numpy(cands))
    _close(got.numpy(), J.score_candidates(jp, jc, dense[:1], sparse[:1], cands))
    sp = np.tile(sparse[:1], (10, 1))
    sp[:, 0] = cands
    full = T.forward(tp, tc, torch.from_numpy(np.tile(dense[:1], (10, 1))), torch.from_numpy(sp))
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("kw", RECSYS_CASES, ids=IDS)
def test_multi_hot_embedding_bag_matches_jax(kw):
    jc, tc, jp, tp, *_ = _setup(kw, seed=3)
    rng = np.random.default_rng(3)
    mh = np.stack([rng.integers(0, v, (4, 5)) for v in jc.vocab_sizes], 1).astype(np.int32)
    lengths = rng.integers(0, 6, (4, jc.n_sparse)).astype(np.int32)     # 0: an empty bag
    got = T.embedding_bag(tp, tc, torch.from_numpy(mh), torch.from_numpy(lengths))
    _close(got.numpy(), J.embedding_bag(jp, jc, mh, lengths))


def test_dot_interaction_pairs_in_jax_order():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(3, 5, 4)).astype(np.float32)
    bot = rng.normal(size=(3, 4)).astype(np.float32)
    for b in (None, bot):
        want = J._dot_interaction(emb, b)
        got = T._dot_interaction(torch.from_numpy(emb), None if b is None else torch.from_numpy(b))
        _close(got.numpy(), want)


@pytest.mark.parametrize("kw", RECSYS_CASES, ids=IDS)
def test_init_has_the_jax_layout_and_param_count(kw):
    jc, tc = J.RecsysConfig(**kw), T.RecsysConfig(**kw)
    jp = jax.device_get(J.init_recsys(jax.random.PRNGKey(0), jc))
    tp = T.init_recsys(torch.Generator().manual_seed(0), tc, device="cpu")
    a = [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
         for k, v in jax.tree_util.tree_leaves_with_path(jp)]
    b = [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
         for k, v in jax.tree_util.tree_leaves_with_path(params_to_numpy(tp))]
    assert a == b
    assert tc.param_count() == jc.param_count() and tc.total_rows == jc.total_rows
    table = tp["table"]
    assert float(table.min()) >= -0.05 and float(table.max()) < 0.05
    assert torch.equal(tc.field_offsets(), torch.from_numpy(np.array(jc.field_offsets())))


def test_lookup_fn_is_used_and_mesh_lookups_raise():
    kw = RECSYS_CASES[1]
    _, tc, _, tp, dense, sparse, _ = _setup(kw)
    seen = []

    def lookup(table, flat):
        seen.append(flat.shape)
        return table[flat.long()] * 2

    doubled = dataclasses.replace(tc, lookup_fn=lookup)
    emb = T.embedding_lookup(tp, doubled, torch.from_numpy(sparse))
    assert seen == [sparse.shape]
    assert torch.equal(emb, 2 * T.embedding_lookup(tp, tc, torch.from_numpy(sparse)))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        T.make_psum_scatter_lookup(None)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        T.embedding_lookup(tp, dataclasses.replace(tc, lookup_sharding="model"),
                           torch.from_numpy(sparse))


@pytest.mark.parametrize("seed,step,b", [(0, 0, 64), (3, 7, 33)])
def test_click_log_generator_gives_the_jax_arrays(seed, step, b):
    vocabs = CRITEO_VOCABS[:5] + (1000,) * 3
    want = JaxClickLogGenerator(vocabs, 13, seed).batch(b, step)
    got = ClickLogGenerator(vocabs, 13, seed).batch(b, step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


def _cells(shapes):
    return {name: dataclasses.astuple(cell) for name, cell in shapes.items()}


def test_configs_and_shapes_equal_jax():
    assert list_archs() == ["dcn-v2", "deepfm", "dlrm-mlperf", "dlrm-rm2"]
    assert _cells(RECSYS_SHAPES) == _cells(JAX_RECSYS_SHAPES)
    for arch_id in list_archs():
        mine, theirs = get_arch(arch_id), jax_get_arch(arch_id)
        assert (mine.family, _cells(mine.shapes), mine.micro_batches) == (
            theirs.family, _cells(theirs.shapes), theirs.micro_batches)
        a, b = dataclasses.asdict(mine.model_cfg), dataclasses.asdict(theirs.model_cfg)
        for key in ("dtype", "param_dtype"):
            assert str(a.pop(key)).replace("torch.", "") == np.dtype(b.pop(key)).name
        assert a == b, arch_id
        assert mine.model_cfg.param_count() == theirs.model_cfg.param_count()


@pytest.mark.parametrize("arch_id", ["dcn-v2", "deepfm", "dlrm-mlperf", "dlrm-rm2"])
def test_mlp_flops_equal_jax(arch_id):
    mine = steps._recsys_mlp_flops(get_arch(arch_id).model_cfg)
    assert mine > 0 and mine == jax_steps._recsys_mlp_flops(jax_get_arch(arch_id).model_cfg)


@pytest.mark.parametrize("step", [0, 1, 1000, 2000, 2001, 100_000, 200_000, 250_000])
def test_make_tx_schedule_matches_jax(step):
    mine = linear_warmup_linear_decay(1e-3, 2000, 200_000)(step)
    theirs = jax_schedule(1e-3, 2000, 200_000)(jnp.asarray(step))
    np.testing.assert_allclose(mine.item(), float(theirs), rtol=1e-6, atol=0)


def test_make_tx_updates_match_jax():
    """Five updates of one leaf: clip at 1.0, then AdamW on the schedule."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(6,)).astype(np.float32)
    jtx, ttx = jax_steps._make_tx("dcn-v2", lr=1e-3), steps._make_tx("dcn-v2", lr=1e-3)
    jstate, tstate = jtx.init({"w": jnp.asarray(p)}), ttx.init({"w": torch.from_numpy(p)})
    for _ in range(5):
        g = (rng.normal(size=(6,)) * 3).astype(np.float32)
        ju, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, {"w": jnp.asarray(p)})
        tu, tstate = ttx.update({"w": torch.from_numpy(g)}, tstate, {"w": torch.from_numpy(p)})
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]), rtol=1e-5, atol=1e-12)


def test_three_train_steps_match_jax():
    """recsys_train of launch/steps.py on a tiny dcn-v2 against the same
    three steps built in JAX from bce_loss and _make_tx. Losses to 1e-5
    relative (the same fp32 ops). Params to 1e-5 relative plus 1e-3 of
    the largest move: an AdamW step divides m by sqrt(v), so a gradient
    element near 0, where the two sum orders differ most, moves its param
    by up to lr either way."""
    tiny = dict(name="dcn-v2", n_dense=13, vocab_sizes=(50, 30, 20, 7), embed_dim=8,
                interaction="cross", n_cross_layers=2, top_mlp=(16, 8))
    jc, tc = J.RecsysConfig(**tiny), T.RecsysConfig(**tiny)
    prog = steps.build_cell("dcn-v2", "train_batch", "cpu", model_cfg=tc)
    assert prog.kind == "recsys_train"
    jp = jax.device_get(J.init_recsys(jax.random.PRNGKey(7), jc))
    jtx, ttx = jax_steps._make_tx("dcn-v2", lr=1e-3), steps._make_tx("dcn-v2", lr=1e-3)
    tp = params_to_torch(jp, "cpu")
    state = steps.TrainState(torch.zeros((), dtype=torch.int32), tp, ttx.init(tp))
    jopt = jtx.init(jp)
    gen = ClickLogGenerator(tc.vocab_sizes, tc.n_dense, seed=1)
    p0 = jp
    for step in range(3):
        batch = gen.batch(32, step)
        (jloss, _), g = jax.value_and_grad(
            lambda p: J.bce_loss(p, jc, batch["dense"], batch["sparse"], batch["labels"]),
            has_aux=True)(jp)
        updates, jopt = jtx.update(g, jopt, jp)
        jp = jax_apply_updates(jp, updates)
        state, metrics = prog.fn(state, *(torch.from_numpy(batch[k])
                                          for k in ("dense", "sparse", "labels")))
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-5)
    assert int(state.step) == 3
    for got, want, start in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jp),
                                jax.tree_util.tree_leaves(p0)):
        moved = float(np.abs(np.asarray(want) - np.asarray(start)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3 * moved)


def test_cells_build_on_meta_and_other_kinds_raise():
    cells = steps.list_cells()
    assert len(cells) == 16 and ("dcn-v2", "train_batch") in cells
    prog = steps.build_cell("dcn-v2", "train_batch", "cpu")
    state, dense, sparse, labels = prog.args
    assert state.params["table"].device.type == "meta"
    assert tuple(state.params["table"].shape) == (187_767_808, 16)
    assert (tuple(dense.shape), tuple(sparse.shape), tuple(labels.shape)) == (
        (65536, 13), (65536, 26), (65536,))
    assert prog.static_info["params"] == jax_get_arch("dcn-v2").model_cfg.param_count()
    serve = steps.build_cell("deepfm", "serve_p99", "cpu")
    assert tuple(serve.args[1].shape) == (512, 0)
    retr = steps.build_cell("dlrm-rm2", "retrieval_cand", "cpu")
    assert retr.static_info["padded"] == {"n_candidates": [1_000_000, 1_000_000]}
    with pytest.raises(KeyError):
        steps.build_cell("dcn-v2", "prefill_32k", "cpu")
    for kind, item in (("train", "A9a"), ("gnn_full", "A9e"), ("contrastive", "A10")):
        with pytest.raises(NotImplementedError, match=item):
            steps._BUILDERS[kind](get_arch("dcn-v2"), steps.ShapeCell("x", kind, {}), "cpu")


def test_serve_and_retrieval_programs_run_on_the_cpu():
    small = dataclasses.replace(get_arch("dlrm-rm2").model_cfg, vocab_sizes=(40,) * 26)
    serve = steps.build_cell("dlrm-rm2", "serve_p99", "cpu", model_cfg=small)
    params = serve.init(torch.Generator().manual_seed(0))
    gen = ClickLogGenerator(small.vocab_sizes, small.n_dense, seed=0).batch(8, 0)
    logits = serve.fn(params, torch.from_numpy(gen["dense"]), torch.from_numpy(gen["sparse"]))
    assert logits.shape == (8,) and bool(torch.isfinite(logits).all())
    retr = steps.build_cell("dlrm-rm2", "retrieval_cand", "cpu", model_cfg=small)
    scores = retr.fn(params, torch.from_numpy(gen["dense"][:1]),
                     torch.from_numpy(gen["sparse"][:1]), torch.arange(40, dtype=torch.int32))
    assert scores.shape == (40,)
    np.testing.assert_allclose(scores[gen["sparse"][0, 0]].item(), logits[0].item(),
                               rtol=2e-5, atol=1e-6)
