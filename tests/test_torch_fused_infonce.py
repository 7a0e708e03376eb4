"""The port's fused_infonce_stats on CPU tensors (its plain version, ref.py,
through the same autograd Function the CUDA kernels sit behind) against the
JAX package's (the Pallas kernels in interpret mode, as tests/
test_fused_infonce.py runs them off-TPU), on the same numpy inputs.

Tolerances:
  * fp32: lse, pos, amax and dQ, dP within rtol 1e-5 and atol 1e-5 (the
    same fp32 products summed in another order; ROADMAP Queue C);
  * bf16 (identical bf16 inputs on both sides): the statistics within the
    fp32 tolerance (both widen the inputs and sum exact products in fp32);
    dQ, dP within 2e-2 of the largest gradient, because the JAX kernel
    rounds each softmax coefficient to bf16 before its product and the
    port's plain version keeps it in fp32 (2^-8 relative each), then both
    round the result to bf16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fused_infonce.ops import fused_infonce_stats as jax_stats
from repro.kernels.fused_infonce.ops import merge_row_stats as jax_merge
from repro.kernels.fused_infonce.ref import infonce_stats_ref as jax_stats_ref
from repro_torch.core.precision import NEG_INF
from repro_torch.kernels.fused_infonce import ops
from repro_torch.kernels.fused_infonce.ref import infonce_stats_ref

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

RTOL = ATOL = 1e-5


def _problem(seed, m, n, d, mask_p=0.0, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(m, d))).astype(np.float32).astype(dtype)
    p = (scale * rng.normal(size=(n, d))).astype(np.float32).astype(dtype)
    labels = rng.integers(0, n, size=(m,)).astype(np.int32)
    valid = rng.random(n) >= mask_p
    valid[labels] = True
    g_lse = rng.random(m).astype(np.float32)
    g_pos = -rng.random(m).astype(np.float32)
    return q, p, labels, valid, g_lse, g_pos


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _jax(q, p, labels, valid, g_lse, g_pos, inv_tau, block=(8, 16)):
    args = (jnp.asarray(q), jnp.asarray(p))

    def f(q_, p_):
        return jax_stats(q_, p_, jnp.asarray(labels), None if valid is None else jnp.asarray(valid),
                         inv_tau, block[0], block[1], True)

    out, vjp = jax.vjp(f, *args)
    dq, dp = vjp((jnp.asarray(g_lse), jnp.asarray(g_pos), jnp.zeros_like(out[2])))
    return [np.asarray(x, np.float32) for x in (*out, dq, dp)]


def _port(q, p, labels, valid, g_lse, g_pos, inv_tau):
    qt = _t(q).requires_grad_(True)
    pt = _t(p).requires_grad_(True)
    lse, pos, amax = ops.fused_infonce_stats(
        qt, pt, torch.from_numpy(labels), None if valid is None else torch.from_numpy(valid),
        inv_tau,
    )
    dq, dp = torch.autograd.grad((lse, pos), (qt, pt), (_t(g_lse), _t(g_pos)))
    assert dq.dtype == qt.dtype and dp.dtype == pt.dtype
    return [_np(x) for x in (lse, pos, amax, dq, dp)]


CASES = {
    # name: (m, n, d, mask_p, inv_tau)
    "ragged": (13, 37, 24, 0.0, 1.0),
    "masked": (9, 70, 16, 0.4, 1.0),
    "inv_tau": (5, 33, 8, 0.2, 2.5),
    "one_row": (1, 17, 32, 0.3, 1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stats_and_vjp_match_jax_fp32(name):
    m, n, d, mask_p, inv_tau = CASES[name]
    q, p, labels, valid, g_lse, g_pos = _problem(sorted(CASES).index(name), m, n, d, mask_p)
    want = _jax(q, p, labels, valid, g_lse, g_pos, inv_tau)
    got = _port(q, p, labels, valid, g_lse, g_pos, inv_tau)
    for g, w, what in zip(got, want, ("lse", "pos", "amax", "dq", "dp")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


def test_stats_and_vjp_match_jax_bf16():
    q, p, labels, valid, g_lse, g_pos = _problem(7, 21, 45, 32, 0.3, ml_dtypes.bfloat16)
    want = _jax(q, p, labels, valid, g_lse, g_pos, 1.0)
    got = _port(q, p, labels, valid, g_lse, g_pos, 1.0)
    for g, w, what in zip(got[:3], want[:3], ("lse", "pos", "amax")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)
    for g, w, what in zip(got[3:], want[3:], ("dq", "dp")):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), what


def test_fully_masked_chunk_is_finite_and_gradient_free():
    q, p, labels, _, g_lse, g_pos = _problem(8, 6, 20, 8)
    valid = np.zeros(20, bool)
    want = _jax(q, p, labels, valid, g_lse, g_pos, 1.0)
    got = _port(q, p, labels, valid, g_lse, g_pos, 1.0)
    lse, pos, amax, dq, dp = got
    assert np.isfinite(lse).all() and (lse < NEG_INF / 2).all()
    assert (pos == np.float32(NEG_INF)).all() and (amax == np.float32(NEG_INF)).all()
    assert not dq.any() and not dp.any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_out_of_range_labels_give_zero_pos_like_the_kernel():
    """Labels outside [0, N) (a column chunk that does not own the row's
    positive): the port and the JAX kernel give pos = 0 and no one-hot
    gradient; the JAX package's dense reference gathers a clipped column
    instead, which is the one rule ref.py does not share with it. (The JAX
    kernel pads N to its column block and masks the padding, so a label in
    [N, padded N) reads a masked column there and gets -1e30; this label is
    past the padding.)"""
    q, p, labels, valid, g_lse, g_pos = _problem(9, 6, 25, 16, 0.2)
    labels[1], labels[4] = -2, 25 + 40
    want = _jax(q, p, labels, valid, g_lse, g_pos, 1.0)
    got = _port(q, p, labels, valid, g_lse, g_pos, 1.0)
    assert got[1][1] == 0.0 and got[1][4] == 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    ref_pos = np.asarray(jax_stats_ref(jnp.asarray(q), jnp.asarray(p), jnp.asarray(labels),
                                       jnp.asarray(valid))[1])
    assert ref_pos[4] != 0.0                      # the clipped gather of the JAX reference
    port_ref_pos = _np(infonce_stats_ref(_t(q), _t(p), torch.from_numpy(labels),
                                         torch.from_numpy(valid))[1])
    assert port_ref_pos[1] == 0.0 and port_ref_pos[4] == 0.0


def test_merge_row_stats_over_a_split_column_set():
    """Stats of two column chunks, each with chunk-local labels, merge into
    the stats of the whole set, in value and in gradient, as in JAX."""
    q, p, labels, valid, g_lse, g_pos = _problem(10, 7, 50, 12, 0.3)
    cut = 23
    qt = _t(q).requires_grad_(True)
    pt = _t(p).requires_grad_(True)
    lab = torch.from_numpy(labels)
    vt = torch.from_numpy(valid)
    chunks = [
        ops.fused_infonce_stats(qt, pt[:cut].contiguous(), lab, vt[:cut].contiguous()),
        ops.fused_infonce_stats(qt, pt[cut:].contiguous(), lab - cut, vt[cut:].contiguous()),
    ]
    owns = torch.stack([lab < cut, lab >= cut])
    lse, pos, amax = ops.merge_row_stats(
        torch.stack([c[0] for c in chunks]), torch.stack([c[1] for c in chunks]),
        owns, torch.stack([c[2] for c in chunks]))
    full = ops.fused_infonce_stats(qt, pt, lab, vt)
    for a, b in zip((lse, pos, amax), full):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    g_merged = torch.autograd.grad((lse - pos).sum(), (qt, pt))
    g_full = torch.autograd.grad((full[0] - full[1]).sum(), (qt, pt))
    for a, b in zip(g_merged, g_full):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    jl, jp, ja = jax_merge(
        jnp.asarray(np.stack([_np(c[0]) for c in chunks])),
        jnp.asarray(np.stack([_np(c[1]) for c in chunks])),
        jnp.asarray(owns.numpy()),
        jnp.asarray(np.stack([_np(c[2]) for c in chunks])),
    )
    for a, b in zip((lse, pos, amax), (jl, jp, ja)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_bank_rows_get_no_q_gradient_and_loss_helpers_match():
    """A detached q (the query-bank buffer) needs no dQ; the loss helpers
    are the mean of lse - pos."""
    q, p, labels, valid, _, _ = _problem(11, 10, 30, 8)
    pt = _t(p).requires_grad_(True)
    lse, pos, _ = ops.fused_infonce_stats(_t(q), pt, torch.from_numpy(labels), None)
    (gp,) = torch.autograd.grad((lse - pos).mean(), (pt,))
    assert gp.shape == pt.shape
    lab = torch.arange(10, dtype=torch.int32)
    loss = ops.fused_infonce_loss(_t(q), _t(p)[:10].contiguous(), lab, temperature=0.5)
    rl, rp = ops.fused_infonce_rows(_t(q), _t(p)[:10].contiguous(), lab, 2.0)
    np.testing.assert_allclose(float(loss), float((rl - rp).mean()), rtol=1e-6)


def test_cpu_wrappers_count_no_launches():
    before = (ops.fused_infonce_fwd.launches, ops.fused_infonce_dq.launches,
              ops.fused_infonce_dp.launches)
    q, p, labels, valid, g_lse, g_pos = _problem(12, 4, 9, 8)
    _port(q, p, labels, valid, g_lse, g_pos, 1.0)
    assert (ops.fused_infonce_fwd.launches, ops.fused_infonce_dq.launches,
            ops.fused_infonce_dp.launches) == before


@settings(max_examples=15, deadline=None)
@given(
    m=st.integers(1, 16),
    n=st.integers(2, 40),
    n_garbage=st.integers(1, 16),
    d=st.integers(1, 12),
    seed=st.integers(0, 2**16),
)
def test_masked_columns_never_affect_loss_or_grads(m, n, n_garbage, d, seed):
    """Mirror of the JAX property: appending large masked columns changes
    neither the loss nor dQ (within 1e-6 relative: the fp32 sums run over
    another set of tiles), and the masked columns' dP rows are exactly 0."""
    q, p, labels, _, _, _ = _problem(seed, m, n, d)
    rng = np.random.default_rng(seed + 1)
    garbage = (100.0 * rng.normal(size=(n_garbage, d))).astype(np.float32)
    lab = torch.from_numpy(labels)

    def loss_and_grads(p_np, valid):
        qt = _t(q).requires_grad_(True)
        pt = _t(p_np).requires_grad_(True)
        lse, pos, _ = ops.fused_infonce_stats(
            qt, pt, lab, None if valid is None else torch.from_numpy(valid))
        loss = (lse - pos).mean()
        return (loss.detach(), *torch.autograd.grad(loss, (qt, pt)))

    l1, gq1, gp1 = loss_and_grads(p, None)
    l2, gq2, gp2 = loss_and_grads(
        np.concatenate([p, garbage]), np.concatenate([np.ones(n, bool), np.zeros(n_garbage, bool)]))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(gq1), _np(gq2), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(gp1), _np(gp2[:n]), rtol=1e-6, atol=1e-6)
    assert not gp2[n:].any()
