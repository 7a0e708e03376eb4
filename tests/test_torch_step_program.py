"""The port's StepProgram (core/step_program.py) against the JAX package's:
multi-step trajectories of the 10 single-device compositions on a torch twin
of ``tests/helpers.make_mlp_encoder``, carrying the same params and batches
across, on both of the port's loss backends. Then the claims of
``tests/test_paper_claims.py`` that need no mesh, run on the port.

Tolerance: fp32, rtol 1e-5 and atol 1e-6 on every metric, param and bank
after 3 SGD steps (the same arithmetic in another summation order; SGD keeps
the fp32 noise from being amplified, as the JAX package's own parity tests
do). The JAX side runs its dense backend: its fused backend is held to the
dense one by tests/test_fused_infonce.py, and the port's fused backend on
the CPU is its plain version behind the same autograd Function as the CUDA
kernels. One composition (contaccum) is also held to the JAX fused backend,
and once more with tiny BERT towers whose attention is the flash kernel
(``attention_impl="pallas"``: its plain version here, the JAX Pallas kernel
in interpret mode), under the same tolerances.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ContrastiveConfig as JConfig
from repro.core import RetrievalBatch as JBatch
from repro.core import build_step_program as jax_build
from repro.core import init_state as jax_init_state
from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro.optim import chain as jchain
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro_torch.compat import params_to_numpy, params_to_torch
from repro_torch.core.methods import (
    COMPOSITIONS,
    available_methods,
    build_step_program,
    init_state,
    make_update_fn,
    method_needs_mesh,
    method_uses_banks,
)
from repro_torch.core.types import ContrastiveConfig, DualEncoder, RetrievalBatch
from repro_torch.launch.serve import tiny_bert
from repro_torch.models.towers import make_bert_dual_encoder
from repro_torch.optim import adamw, chain, clip_by_global_norm, sgd

from helpers import make_batch, make_mlp_encoder

RTOL, ATOL = 1e-5, 1e-6
SINGLE_DEVICE = [m for m in sorted(COMPOSITIONS) if m != "dpr_xdev"]
FIELDS = ("loss", "accuracy", "grad_norm", "grad_norm_query", "grad_norm_passage",
          "grad_norm_ratio", "n_negatives", "bank_fill_q", "bank_fill_p")


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


def _kw(method):
    kw = dict(method=method, accumulation_steps=1, bank_size=0)
    if method not in ("dpr", "mined"):
        kw["accumulation_steps"] = 4
    if method_uses_banks(method):
        kw["bank_size"] = 12
    return kw


def _batches(n, b=16, n_hard=2, seed=100):
    return [make_batch(jax.random.PRNGKey(seed + i), b, n_hard=n_hard) for i in range(n)]


def _torch_batch(jb):
    return RetrievalBatch(*(None if x is None else torch.from_numpy(np.array(x)) for x in jb))


def _jax_trajectory(kw, batches, loss_impl="dense", enc=None):
    enc = enc or make_mlp_encoder()
    cfg = JConfig(**kw, loss_impl=loss_impl)
    tx = jchain(jclip(cfg.grad_clip_norm), jsgd(0.1))
    state = jax_init_state(jax.random.PRNGKey(0), enc, tx, cfg)
    params0 = jax.device_get(state.params)
    update = jax.jit(jax_build(enc, tx, cfg).update)
    metrics = []
    for b in batches:
        state, m = update(state, JBatch(*b))
        metrics.append(jax.device_get(m))
    return params0, jax.device_get(state), metrics


def _port_trajectory(kw, params0, batches, loss_impl, enc=None):
    enc = enc or torch_mlp_encoder()
    cfg = ContrastiveConfig(**kw, loss_impl=loss_impl)
    tx = chain(clip_by_global_norm(cfg.grad_clip_norm), sgd(0.1))
    state = init_state(None, enc, tx, cfg, params=params_to_torch(params0, "cpu"), device="cpu")
    update = build_step_program(enc, tx, cfg).update
    metrics = []
    for b in batches:
        state, m = update(state, _torch_batch(b))
        metrics.append(m)
    return state, metrics


def _assert_trajectories_close(jstate, jmetrics, tstate, tmetrics, what):
    for step, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        for field in FIELDS:
            np.testing.assert_allclose(float(getattr(tm, field)), float(getattr(jm, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{what} step {step} {field}")
    got, want = params_to_numpy(tstate.params), jstate.params
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what), got, want)
    for bank in ("bank_q", "bank_p"):
        t, j = getattr(tstate, bank), getattr(jstate, bank)
        np.testing.assert_allclose(t.buf.numpy(), np.asarray(j.buf), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        assert int(t.head) == int(j.head)
    assert int(tstate.step) == int(jstate.step)


@pytest.mark.parametrize("method", SINGLE_DEVICE)
def test_composition_trajectory_matches_jax_on_both_backends(method):
    kw = _kw(method)
    batches = _batches(3)
    params0, jstate, jmetrics = _jax_trajectory(kw, batches)
    for loss_impl in ("dense", "fused"):
        tstate, tmetrics = _port_trajectory(kw, params0, batches, loss_impl)
        _assert_trajectories_close(jstate, jmetrics, tstate, tmetrics, f"{method}/{loss_impl}")


def test_contaccum_fused_trajectory_matches_jax_fused():
    kw = _kw("contaccum")
    batches = _batches(2, n_hard=1, seed=7)
    params0, jstate, jmetrics = _jax_trajectory(kw, batches, loss_impl="fused")
    tstate, tmetrics = _port_trajectory(kw, params0, batches, "fused")
    _assert_trajectories_close(jstate, jmetrics, tstate, tmetrics, "contaccum/fused")


def test_contaccum_step_with_flash_attention_towers_matches_jax():
    """One ContAccum step (2 chunks, banks of 8, one hard negative) of the
    tiny BERT dual encoder with attention_impl="pallas" on both sides:
    every metric (loss and grad_norm_ratio among them), the updated params
    and the banks."""
    rng = np.random.default_rng(12)
    b, q_len, p_len = 4, 8, 16
    batch = tuple(rng.integers(10, 1000, size=shape).astype(np.int32)
                  for shape in ((b, q_len), (b, p_len), (b, 1, p_len)))
    kw = dict(method="contaccum", accumulation_steps=2, bank_size=8)
    jenc = jax_dual_encoder(dataclasses.replace(jax_tiny_bert(), attention_impl="pallas"))
    params0, jstate, jmetrics = _jax_trajectory(kw, [batch], "fused", enc=jenc)
    tenc = make_bert_dual_encoder(dataclasses.replace(tiny_bert(), attention_impl="pallas"))
    tstate, tmetrics = _port_trajectory(kw, params0, [batch], "fused", enc=tenc)
    _assert_trajectories_close(jstate, jmetrics, tstate, tmetrics, "contaccum/flash towers")


def test_registry_and_multi_device_paths_raise():
    """The registry, and build_step_program's refusals: the multi-device ones with
    the JAX package's ValueError messages (dpr_xdev or shard_banks without a
    dp_axis, loss_comm='ring' without sharded banks or on a source without
    banks, an unknown loss_comm); a dp_axis with no process group raises."""
    assert available_methods() == sorted(COMPOSITIONS)
    assert method_needs_mesh("dpr_xdev") and not method_needs_mesh("contaccum")
    enc, tx = torch_mlp_encoder(), sgd(0.1)
    for kw in (dict(method="dpr_xdev"), dict(bank_size=4, shard_banks=True),
               dict(bank_size=4, loss_comm="ring"), dict(method="dpr", loss_comm="ring"),
               dict(method="prebatch_cache", bank_size=4, loss_comm="ring"),
               dict(bank_size=4, loss_comm="psum")):
        with pytest.raises(ValueError) as jax_err:
            jax_build(make_mlp_encoder(), jsgd(0.1), JConfig(**kw))
        with pytest.raises(ValueError) as port_err:
            build_step_program(enc, tx, ContrastiveConfig(**kw))
        assert str(port_err.value) == str(jax_err.value), kw
    with pytest.raises(RuntimeError, match="process group"):
        build_step_program(enc, tx, ContrastiveConfig(method="dpr_xdev", dp_axis="data"))
    with pytest.raises(RuntimeError, match="process group"):
        init_state(None, enc, tx, ContrastiveConfig(bank_size=4, dp_axis="data",
                                                    shard_banks=True), params={}, device="cpu")
    with pytest.raises(ValueError, match="equal non-zero capacities"):
        build_step_program(enc, tx, ContrastiveConfig(bank_size_q=4, bank_size_p=8))
    with pytest.raises(ValueError, match="unknown method"):
        build_step_program(enc, tx, ContrastiveConfig(method="nope"))


# ---------------------------------------------------------------- paper claims
def _claims_state(cfg, tx, seed=0):
    params0 = jax.device_get(make_mlp_encoder().init(jax.random.PRNGKey(seed)))
    enc = torch_mlp_encoder()
    return enc, init_state(None, enc, tx, cfg, params=params_to_torch(params0, "cpu"),
                           device="cpu")


def _train_ratio_trace(cfg, n_steps, lr):
    tx = chain(clip_by_global_norm(cfg.grad_clip_norm), adamw(lr))
    enc, state = _claims_state(cfg, tx)
    update = make_update_fn(enc, tx, cfg)
    ratios = []
    for i in range(n_steps):
        state, m = update(state, _torch_batch(make_batch(jax.random.PRNGKey(1000 + i), 16)))
        ratios.append(float(m.grad_norm_ratio))
    return np.array(ratios)


def test_claim_gradient_norm_imbalance_passage_only_bank():
    """Sec. 3.3 / Fig. 5 on the port: a passage-only bank makes the two
    encoders' gradient norms diverge; the dual bank keeps them balanced
    (the same thresholds as tests/test_paper_claims.py)."""
    base = dict(method="contaccum", accumulation_steps=2, bank_size=64)
    dual = _train_ratio_trace(ContrastiveConfig(**base), 120, 1e-2)
    p_only = _train_ratio_trace(ContrastiveConfig(**base, use_query_bank=False), 120, 1e-2)
    imb_dual = np.abs(np.log(dual[-20:])).mean()
    imb_ponly = np.abs(np.log(p_only[-20:])).mean()
    assert imb_dual < 0.8, np.exp(imb_dual)
    assert imb_ponly > imb_dual + 0.4, (imb_ponly, imb_dual)
    assert imb_ponly > 0.9, imb_ponly


def test_claim_dpr_baseline_is_balanced():
    ratios = _train_ratio_trace(ContrastiveConfig(method="dpr"), 30, 5e-3)
    assert 0.5 < ratios[-10:].mean() < 2.0


def test_claim_similarity_mass_of_past_representations():
    """Appendix C: banked passages keep similarity mass comparable to the
    current in-batch passages."""
    cfg = ContrastiveConfig(method="contaccum", accumulation_steps=1, bank_size=32)
    tx = chain(clip_by_global_norm(2.0), adamw(1e-3))
    enc, state = _claims_state(cfg, tx)
    update = make_update_fn(enc, tx, cfg)
    for i in range(8):
        state, _ = update(state, _torch_batch(make_batch(jax.random.PRNGKey(i), 8)))
    batch = _torch_batch(make_batch(jax.random.PRNGKey(99), 8))
    with torch.no_grad():
        q = enc.encode_query(state.params, batch.query)
        p_now = enc.encode_passage(state.params, batch.passage_pos)
        sims = torch.softmax(q @ torch.cat([p_now, state.bank_p.buf]).T, dim=-1)
    mass_now = float(sims[:, :8].sum(1).mean()) / 8
    mass_bank = float(sims[:, 8:].sum(1).mean()) / 32
    assert mass_bank > 0.1 * mass_now, (mass_bank, mass_now)


def test_claim_contaccum_competitive_with_gradaccum():
    """Table 1, directional, on the port: with the same local batch the
    extra negatives do not hurt final training accuracy."""

    def final_acc(cfg, steps=80):
        tx = chain(clip_by_global_norm(2.0), adamw(5e-3))
        enc, state = _claims_state(cfg, tx)
        update = make_update_fn(enc, tx, cfg)
        accs = []
        for i in range(steps):
            state, m = update(state, _torch_batch(make_batch(jax.random.PRNGKey(i % 17), 16)))
            accs.append(float(m.accuracy))
        return np.mean(accs[-10:])

    acc_ga = final_acc(ContrastiveConfig(method="grad_accum", accumulation_steps=4))
    acc_ca = final_acc(ContrastiveConfig(method="contaccum", accumulation_steps=4, bank_size=64))
    assert acc_ca > 0.5 * acc_ga, (acc_ca, acc_ga)
