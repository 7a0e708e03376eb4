"""The port's contrastive_loss (core/loss.py) and plain InfoNCE functions
(core/infonce.py) against the JAX package's, on the same numpy inputs:
loss, accuracy, row and negative counts, and the gradient w.r.t. every input
block, on both backends, with masked extra columns (bank warm-up) and
fractionally weighted extra rows.

Tolerance: fp32, rtol 1e-5 and atol 1e-6 on values and gradients (the same
fp32 arithmetic summed in another order; ROADMAP Queue C). Accuracy is
compared exactly (random logits have no ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import infonce as jax_infonce
from repro.core.loss import ExtraColumns as JCols
from repro.core.loss import ExtraRows as JRows
from repro.core.loss import DenseLossBackend as JDense
from repro.core.loss import FusedLossBackend as JFused
from repro.core.loss import contrastive_loss as jax_loss
from repro.core.loss import contrastive_step_loss as jax_step_loss
from repro.core.memory_bank import init_bank as jax_init_bank
from repro.core.memory_bank import push_pair as jax_push_pair
from repro_torch.core import infonce
from repro_torch.core.dist import DistCtx
from repro_torch.core.loss import (
    DenseLossBackend,
    ExtraColumns,
    ExtraRows,
    contrastive_loss,
    contrastive_step_loss,
    resolve_loss_backend,
)
from repro_torch.core.memory_bank import init_bank, push_pair

RTOL, ATOL = 1e-5, 1e-6
JAX_BACKENDS = {"dense": JDense(), "fused": JFused(block_m=8, block_n=16, interpret=True)}


def _inputs(seed=5, b=8, d=16, c=10, r=6, hard=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(
        q=f(b, d), pp=f(b, d), ph=f(hard * b, d), cols=f(c, d), rows=f(r, d),
        valid=np.arange(c) < 7,                          # 3 masked warm-up slots
        labels=np.arange(r).astype(np.int32),            # into the extra columns
        weight=rng.random(r).astype(np.float32),         # fractional weights
    )


def _jax_run(x, backend, extras, temperature):
    def loss(q, pp, ph, cr, rr):
        return jax_loss(
            q, pp, ph,
            extra_cols=JCols(reps=cr, valid=jnp.asarray(x["valid"])) if extras else None,
            extra_rows=JRows(reps=rr, labels=jnp.asarray(x["labels"]),
                             weight=jnp.asarray(x["weight"])) if extras else None,
            temperature=temperature, backend=JAX_BACKENDS[backend],
        )

    args = [jnp.asarray(x[k]) for k in ("q", "pp", "ph", "cols", "rows")]
    (l, aux), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    return float(l), aux, [np.asarray(g) for g in grads]


def _port_run(x, backend, extras, temperature, sharded=False):
    ts = [torch.from_numpy(x[k]).requires_grad_(True) for k in ("q", "pp", "ph", "cols", "rows")]
    q, pp, ph, cr, rr = ts
    l, aux = contrastive_loss(
        q, pp, ph,
        extra_cols=ExtraColumns(reps=cr, valid=torch.from_numpy(x["valid"]),
                                sharded=sharded) if extras else None,
        extra_rows=ExtraRows(reps=rr, labels=torch.from_numpy(x["labels"]),
                             weight=torch.from_numpy(x["weight"]),
                             sharded=sharded) if extras else None,
        temperature=temperature, backend=backend,
    )
    grads = torch.autograd.grad(l, ts, allow_unused=True)
    grads = [np.zeros_like(x[k]) if g is None else g.numpy()
             for g, k in zip(grads, ("q", "pp", "ph", "cols", "rows"))]
    return float(l.detach()), aux, grads


@pytest.mark.parametrize("extras", [True, False])
@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_contrastive_loss_matches_jax(backend, extras):
    x = _inputs()
    jl, jaux, jg = _jax_run(x, backend, extras, 0.7)
    tl, taux, tg = _port_run(x, backend, extras, 0.7)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for field in ("loss", "accuracy", "n_rows", "n_negatives"):
        np.testing.assert_allclose(float(getattr(taux, field)), float(getattr(jaux, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_array_equal(taux.q_global.numpy(), np.asarray(jaux.q_global))
    for name, a, b in zip(("dq", "dpp", "dph", "dcols", "drows"), tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    if extras:
        assert not tg[3][7:].any()                     # masked columns: zero gradient


def test_step_loss_over_banks_matches_jax_both_backends():
    """Dual banks mid-warm-up (5 of 8 slots filled): contrastive_step_loss
    on both backends against the JAX package's, and the two port backends
    against each other."""
    rng = np.random.default_rng(3)
    d = 8
    jq, jp = jax_init_bank(8, d), jax_init_bank(8, d)
    tq, tp = init_bank(8, d, device="cpu"), init_bank(8, d, device="cpu")
    for _ in range(2):
        aq, ap = rng.normal(size=(3, d)).astype(np.float32), rng.normal(size=(3, d)).astype(np.float32)
        jq, jp = jax_push_pair(jq, jp, jnp.asarray(aq), jnp.asarray(ap))
        tq, tp = push_pair(tq, tp, torch.from_numpy(aq), torch.from_numpy(ap))
    q, pp = (rng.normal(size=(4, d)).astype(np.float32) for _ in range(2))
    want, jaux = jax_step_loss(jnp.asarray(q), jnp.asarray(pp), None, jq, jp)
    for backend in ("dense", "fused"):
        got, aux = contrastive_step_loss(torch.from_numpy(q), torch.from_numpy(pp), None,
                                         tq, tp, backend=backend)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(aux.n_negatives), float(jaux.n_negatives))
    assert float(aux.n_negatives) == 4 + 6 - 1


def test_infonce_functions_match_jax():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, pp, ph = f(6, 8), f(6, 8), f(12, 8)
    bq, bp = f(5, 8), f(5, 8)
    bqv, bpv = np.array([1, 1, 0, 1, 0], bool), np.array([1, 0, 1, 1, 1], bool)
    outs = [
        (infonce.in_batch_loss(*map(torch.from_numpy, (q, pp, ph)), temperature=0.5),
         jax_infonce.in_batch_loss(*map(jnp.asarray, (q, pp, ph)), temperature=0.5)),
        (infonce.extended_loss(*map(torch.from_numpy, (q, pp, ph, bq, bqv, bp, bpv))),
         jax_infonce.extended_loss(*map(jnp.asarray, (q, pp, ph, bq, bqv, bp, bpv)))),
        (infonce.extended_loss(*map(torch.from_numpy, (q, pp, ph)), None, None,
                               *map(torch.from_numpy, (bp, bpv))),
         jax_infonce.extended_loss(*map(jnp.asarray, (q, pp, ph)), None, None,
                                   *map(jnp.asarray, (bp, bpv)))),
    ]
    for got, want in outs:
        for field in got._fields:
            np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=field)
    logits = infonce.similarity_logits(torch.from_numpy(q), torch.from_numpy(pp), temperature=2.0,
                                       col_mask=torch.from_numpy(bqv[:5].repeat(2)[:6]))
    want = jax_infonce.similarity_logits(jnp.asarray(q), jnp.asarray(pp), temperature=2.0,
                                         col_mask=jnp.asarray(bqv[:5].repeat(2)[:6]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_chunk_stats_match_jax_both_backends():
    """The ring's per-chunk statistics (ported now, used by the ring later):
    out-of-chunk labels give pos = 0."""
    rng = np.random.default_rng(6)
    q, p = rng.normal(size=(5, 8)).astype(np.float32), rng.normal(size=(12, 8)).astype(np.float32)
    labels = np.array([0, 11, -3, 70, 4], np.int32)
    valid = rng.random(12) > 0.3
    for name in ("dense", "fused"):
        got = resolve_loss_backend(name).chunk_stats(
            torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(labels),
            torch.from_numpy(valid), temperature=0.8)
        want = JAX_BACKENDS[name].chunk_stats(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(labels), jnp.asarray(valid),
            temperature=0.8)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        assert got[1][2].item() == 0.0 and got[1][3].item() == 0.0


def test_backend_resolution_and_sharded_blocks_raise():
    """Backend names resolve or raise. The sharded blocks on one device (no
    axis): a shard is the whole bank, the ring a ring of one chunk (the
    in-batch block and the bank merged by merge_row_stats), and sharded
    rows enter at full weight, so the loss, its aux and every gradient
    equal JAX's over the plain blocks, on both backends. A context with an
    axis and no process group raises."""
    assert isinstance(resolve_loss_backend(None), DenseLossBackend)
    with pytest.raises(ValueError, match="unknown loss_impl"):
        resolve_loss_backend("sparse")
    x = _inputs()
    for backend in ("dense", "fused"):
        jl, jaux, jg = _jax_run(x, backend, True, 0.7)
        tl, taux, tg = _port_run(x, backend, True, 0.7, sharded=True)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
        for field in ("loss", "accuracy", "n_rows", "n_negatives"):
            np.testing.assert_allclose(float(getattr(taux, field)), float(getattr(jaux, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=field)
        for name, a, b in zip(("dq", "dpp", "dph", "dcols", "drows"), tg, jg):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{backend} {name}")
    with pytest.raises(RuntimeError, match="process group"):
        DistCtx("data")
