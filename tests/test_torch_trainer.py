"""The port's training loop against the JAX package's: checkpoints that
restore across the two packages, restore-and-replay after an injected fault,
the training driver's per-step loss against the JAX driver's, and the tiny
BERT's [CLS] gradients (with and without ``remat="full"``).

Tolerances:
  * checkpoints: bit-exact (a checkpoint is a copy of the arrays);
  * the driver: per-step loss within rtol 1e-4 over 4 AdamW steps (fp32 on
    both sides; fp32 summation-order noise, about 1e-6 relative per op, is
    what AdamW's normalised first steps carry forward);
  * [CLS] gradients, fp32: rtol 1e-4, atol 1e-6 of the gradient scale (the
    same arithmetic through 2 layers in another summation order); remat
    against no remat: rtol 1e-6 (the recomputed forward is the same ops).
"""

import io
import contextlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint.checkpoint import save_checkpoint as jax_save
from repro.core import ContrastiveConfig as JConfig
from repro.core import init_state as jax_init_state
from repro.launch import train as jax_train
from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro.optim import adamw as jadamw_fn
from repro.optim import chain as jchain
from repro.optim import clip_by_global_norm as jclip
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    flatten_with_paths,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.compat import params_to_torch
from repro_torch.core.methods import build_step_program, init_state
from repro_torch.core.types import ContrastiveConfig, RetrievalBatch
from repro_torch.launch import train as port_train
from repro_torch.launch.serve import tiny_bert
from repro_torch.models.towers import make_bert_dual_encoder
from repro_torch.optim import adamw, chain, clip_by_global_norm, sgd
from repro_torch.runtime.trainer import PeriodicHook, StepFailure, Trainer, TrainerConfig


def _jax_state(bank=8):
    enc = jax_dual_encoder(jax_tiny_bert())
    cfg = JConfig(method="contaccum", accumulation_steps=2, bank_size=bank)
    tx = jchain(jclip(2.0), jadamw_fn(1e-3))
    return jax.device_get(jax_init_state(jax.random.PRNGKey(3), enc, tx, cfg))


def _port_state(bank=8, precision="fp32", seed=0):
    enc = make_bert_dual_encoder(tiny_bert(), precision=precision)
    cfg = ContrastiveConfig(method="contaccum", accumulation_steps=2, bank_size=bank,
                            precision=precision)
    tx = chain(clip_by_global_norm(2.0), adamw(1e-3))
    return enc, tx, cfg, init_state(torch.Generator().manual_seed(seed), enc, tx, cfg, device="cpu")


def _assert_same_tree(port_tree, jax_tree):
    got = dict(flatten_with_paths(port_tree))
    want = {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]), err_msg=key)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    loader = np.asarray([1, 2, -1, 0], np.int64)
    jax_save(str(tmp_path), 7, {"state": jstate, "loader": loader})
    _, _, _, template = _port_state()
    restored, step = restore_checkpoint(
        str(tmp_path), {"state": template, "loader": np.zeros(4, np.int64)})
    assert step == 7 and latest_step(str(tmp_path)) == 7
    np.testing.assert_array_equal(restored["loader"], loader)
    _assert_same_tree(restored["state"], jstate)


def test_port_checkpoint_restores_in_jax(tmp_path):
    _, _, _, state = _port_state(seed=4)
    save_checkpoint(str(tmp_path), 3, {"state": state, "loader": np.arange(4, dtype=np.int64)})
    template = _jax_state()
    restored, step = jax_restore(str(tmp_path), {"state": template, "loader": np.zeros(4, np.int64)})
    assert step == 3
    _assert_same_tree(state, restored["state"])


def test_bf16_banks_round_trip_and_manager_keeps_the_newest(tmp_path):
    _, _, _, state = _port_state(precision="bf16_banks")
    state = state._replace(bank_q=state.bank_q._replace(
        buf=torch.randn(state.bank_q.buf.shape).to(torch.bfloat16)))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, {"state": state})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000000002", "step_000000000003"]
    restored, step = mgr.restore_latest({"state": state})
    assert step == 3 and restored["state"].bank_q.buf.dtype == torch.bfloat16
    assert torch.equal(restored["state"].bank_q.buf, state.bank_q.buf)
    # a step without its manifest is incomplete and skipped
    (tmp_path / "step_000000000003" / "manifest.json").unlink()
    assert latest_step(str(tmp_path)) == 2


def _tiny_run(tmp_path, total, fault_at=None, every=2):
    enc, tx, cfg, state = _port_state(bank=8)
    update = build_step_program(enc, tx, cfg).update
    rng = np.random.default_rng(0)
    data = [rng.integers(10, 1000, size=(3, 4, 8)) for _ in range(total)]
    faults = {fault_at} if fault_at is not None else set()

    def next_batch(step):
        q, p, h = (torch.from_numpy(x) for x in data[step])
        return RetrievalBatch(q, p, h[:, None])

    def fault_hook(step):
        if step in faults:
            faults.discard(step)
            raise StepFailure(f"injected fault at step {step}")

    seen = []
    trainer = Trainer(
        TrainerConfig(total_steps=total, checkpoint_dir=str(tmp_path), checkpoint_every=every,
                      log_every=100),
        update, next_batch, fault_hook=fault_hook,
        hooks=[PeriodicHook(every=2, fn=lambda s, step: seen.append(step) or {"x": 1.0},
                            prefix="h/")],
    )
    return trainer.run(state), seen


def test_restart_after_injected_fault_replays_to_the_same_state(tmp_path):
    (clean, clean_report), _ = _tiny_run(tmp_path / "a", 6)
    (state, report), seen = _tiny_run(tmp_path / "b", 6, fault_at=3)
    assert report.restarts == 1 and clean_report.restarts == 0
    assert [h["step"] for h in report.history] == [0, 1, 2, 2, 3, 4, 5]   # step 2 replayed
    assert seen == [1, 3, 5] and "h/x" in report.history[-1]
    for a, b in zip(flatten_with_paths(state), flatten_with_paths(clean)):
        assert a[0] == b[0]
        torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    np.testing.assert_allclose([h["loss"] for h in report.history[4:]],
                               [h["loss"] for h in clean_report.history[3:]], rtol=0)


def test_train_driver_tracks_the_jax_driver(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --method contaccum
    --loss-impl fused`` on tiny_bert, started from the JAX driver's step-0
    checkpoint (the JAX and torch generators draw different initial
    weights), against the JAX driver's run from the same initial state: the
    same batches in the same order, the same optimizer; per-step loss
    within rtol 1e-4."""
    flags = ["--method", "contaccum", "--loss-impl", "fused", "--total-batch", "16",
             "--local-batch", "8", "--bank", "32", "--corpus-size", "64"]
    with contextlib.redirect_stdout(io.StringIO()):
        jax_train.main(flags + ["--steps", "0", "--checkpoint-dir", str(tmp_path / "init")])
        _, jreport = jax_train.main(flags + ["--steps", "5"])
        shutil.copytree(tmp_path / "init", tmp_path / "port")
        _, treport = port_train.main(flags + ["--steps", "5", "--device", "cpu",
                                              "--checkpoint-dir", str(tmp_path / "port")])
    jl = [h["loss"] for h in jreport.history]
    tl = [h["loss"] for h in treport.history]
    assert [h["step"] for h in treport.history] == [1, 2, 3, 4]       # resumed after step 0
    np.testing.assert_allclose(tl, jl[:4], rtol=1e-4)
    assert np.isfinite(tl).all()


def test_train_driver_refuses_what_is_not_ported():
    """launch/train.py's refusals of flag combinations it cannot run, with
    the JAX package's launch/train.py SystemExit messages: the three that JAX reaches here (one
    device) against JAX's own, the --dp ones (JAX stops at its device count
    first) as JAX words them; --dp 2 on the GPU without two cards."""
    for extra, msg in (
        (["--shard-banks"], "--shard-banks needs --dp N (banks shard over the DP mesh)"),
        (["--shard-banks", "--method", "grad_accum"], "--shard-banks needs --dp N"),
        (["--loss-comm", "ring"], "--loss-comm ring needs --shard-banks (it streams "
                                  "the per-device bank shards around the DP ring)"),
    ):
        with pytest.raises(SystemExit) as port_exit:
            port_train.main(extra + ["--device", "cpu"])
        with pytest.raises(SystemExit) as jax_exit:
            jax_train.main(extra)
        assert str(port_exit.value) == str(jax_exit.value)
        assert str(port_exit.value).startswith(msg)
    for extra, msg in (
        (["--dp", "2", "--shard-banks", "--method", "grad_accum"],
         "--shard-banks: method 'grad_accum' has no memory banks"),
        (["--dp", "3", "--total-batch", "16"], "--total-batch 16 not divisible by --dp 3"),
        (["--dp", "2", "--shard-banks", "--bank", "33"], "--bank 33 not divisible by --dp 2"),
    ):
        with pytest.raises(SystemExit, match=f"^{msg}$"):
            port_train.main(extra + ["--device", "cpu"])
    have = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"^--dp {have + 1} needs >= {have + 1} devices"):
        port_train.main(["--dp", str(have + 1)])


def test_train_dp2_sharded_ring_run_matches_one_process(capfd):
    """launch/train.py --dp 2 --shard-banks --loss-comm ring on two gloo
    ranks: finite losses, full banks reported, and per-step losses within
    rtol 2e-4 (the JAX package's multi-device tolerance) of one process
    training on the same global chunks of 16."""
    flags = ["--device", "cpu", "--method", "contaccum", "--loss-impl", "fused",
             "--total-batch", "16", "--bank", "32", "--steps", "4", "--corpus-size", "64"]
    _, dp_report = port_train.main(flags + ["--dp", "2", "--shard-banks", "--loss-comm", "ring",
                                            "--local-batch", "8"])
    out = capfd.readouterr().out
    _, one_report = port_train.main(flags + ["--local-batch", "16"])
    losses = [h["loss"] for h in dp_report.history]
    assert dp_report.steps_run == 4 and np.isfinite(losses).all()
    assert "bank fill: q 32, p 32 of 32" in out
    assert dp_report.final_metrics["bank_fill_q"] == dp_report.final_metrics["bank_fill_p"] == 32
    np.testing.assert_allclose(losses, [h["loss"] for h in one_report.history], rtol=2e-4)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_tiny_bert_cls_grads_match_jax(remat):
    rng = np.random.default_rng(1)
    tokens = rng.integers(10, 1000, size=(3, 12)).astype(np.int32)
    w = rng.normal(size=(3, 64)).astype(np.float32)
    jenc = jax_dual_encoder(jax_tiny_bert())
    jparams = jenc.init(jax.random.PRNGKey(2))
    jgrads = jax.grad(lambda p: jnp.sum(jenc.encode_query(p, jnp.asarray(tokens)) * w))(jparams)

    import dataclasses

    tenc = make_bert_dual_encoder(dataclasses.replace(tiny_bert(), remat=remat))
    params = params_to_torch(jax.device_get(jparams), "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params["query"]["layers"].items()}
    emb = {k: v.requires_grad_(True) for k, v in params["query"]["embed"].items()}
    out = tenc.encode_query(params, torch.from_numpy(tokens).long())
    (out * torch.from_numpy(w)).sum().backward()
    jq = jax.device_get(jgrads["query"])
    for name, t in list(leaves.items()) + list(emb.items()):
        want = jq["layers"][name] if name in leaves else jq["embed"][name]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-6 * scale, err_msg=name)


def test_remat_gives_the_same_grads_as_none():
    import dataclasses

    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(10, 1000, size=(2, 9))).long()
    grads = {}
    for remat in ("none", "full"):
        enc = make_bert_dual_encoder(dataclasses.replace(tiny_bert(), remat=remat))
        params = enc.init(torch.Generator().manual_seed(5), "cpu")
        w = params["passage"]["layers"]["w1"].requires_grad_(True)
        enc.encode_passage(params, tokens).square().sum().backward()
        grads[remat] = w.grad
    torch.testing.assert_close(grads["full"], grads["none"], rtol=1e-6, atol=1e-7)


def test_sgd_state_is_an_int32_count():
    tx = sgd(0.1)
    assert tx.init({"w": torch.zeros(2)}).dtype == torch.int32


def test_evaluate_topk_matches_jax():
    """Top@k over the synthetic corpus with carried-across tiny-BERT params:
    the same recalls (fp32 scores summed in another order; the ranks of the
    eval's queries do not move at this size)."""
    from repro.data.retrieval import SyntheticRetrievalCorpus as JCorpus
    from repro.evaluation import evaluate_topk as jax_eval
    from repro.evaluation import recall_at as jax_recall_at
    from repro_torch.data.retrieval import SyntheticRetrievalCorpus
    from repro_torch.evaluation import evaluate_topk, recall_at
    from repro_torch.retrieval import RetrieverConfig

    jparams = jax_dual_encoder(jax_tiny_bert()).init(jax.random.PRNGKey(4))
    want = jax_eval(jax_dual_encoder(jax_tiny_bert()), jparams,
                    JCorpus(n_passages=128, q_len=16, p_len=32, seed=1), ks=(1, 5, 20))
    got = evaluate_topk(make_bert_dual_encoder(tiny_bert()), jax.device_get(jparams),
                        SyntheticRetrievalCorpus(n_passages=128, q_len=16, p_len=32, seed=1),
                        ks=(1, 5, 20), cfg=RetrieverConfig(search_impl="fused"), device="cpu")
    assert got == pytest.approx(want, abs=1e-9)
    ids = np.array([[3, 1, -1], [0, 2, 5]])
    assert recall_at(ids, np.array([1, 5]), (1, 2, 3)) == jax_recall_at(ids, np.array([1, 5]), (1, 2, 3))


def test_loader_copy_gives_the_original_index_stream():
    from repro.data.loader import LoaderState as JState
    from repro.data.loader import ShardedLoader as JLoader
    from repro_torch.data.loader import LoaderState, ShardedLoader

    for kw in (dict(), dict(host_id=1, n_hosts=2)):
        a, b = ShardedLoader(50, 8, seed=3, **kw), JLoader(50, 8, seed=3, **kw)
        for _ in range(9):                                   # crosses an epoch
            np.testing.assert_array_equal(a.next_indices(), b.next_indices())
        assert a.state.to_dict() == b.state.to_dict()
    assert LoaderState.from_dict({"epoch": 2, "step": 1}) == LoaderState(2, 1, -1, 0)
    assert JState.from_dict({"epoch": 2, "step": 1}).to_dict() == LoaderState(2, 1).to_dict()
