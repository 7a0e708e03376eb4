"""The port's fused_topk on CPU tensors (its plain version, ref.py) against
the JAX package's fused_topk_scores (the Pallas kernel in interpret mode, as
the JAX tests run it off-TPU) and its topk_scores_ref, on the same numpy
inputs.

Tolerance: fp32 scores agree to 1e-5 absolute plus 1e-6 relative (d <= 32:
the same products summed in another order; the inv_tau case scales scores
to the hundreds); ids are identical, because the
random cases are well separated and the tie cases use small integers, whose
sums are exact, so ties are real ties and go to the lowest id. bf16 inputs
are widened to fp32 before the product on both sides (exact products), so
the same tolerance holds.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fused_topk.ops import fused_topk_scores
from repro.kernels.fused_topk.ref import topk_scores_ref as jax_topk_ref
from repro_torch.core.precision import NEG_INF
from repro_torch.kernels.fused_topk import ops
from repro_torch.kernels.fused_topk.ref import topk_mismatch, topk_scores_ref

ATOL, RTOL = 1e-5, 1e-6
CASES = ["ragged", "masked", "k_exceeds_valid", "ties", "inv_tau"]


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    valid, inv_tau, k = None, 1.0, 10
    if name == "ragged":
        q, p = rng.normal(size=(13, 24)), rng.normal(size=(517, 24))
    elif name == "masked":
        q, p = rng.normal(size=(9, 16)), rng.normal(size=(300, 16))
        valid = rng.random(300) > 0.4
    elif name == "k_exceeds_valid":
        q, p = rng.normal(size=(3, 8)), rng.normal(size=(6, 8))
        valid = np.array([True, False, True, True, False, True])
        k = 9
    elif name == "ties":
        q = rng.integers(-2, 3, size=(7, 8))
        p = rng.integers(-2, 3, size=(200, 8))
        p[50] = p[130] = p[10]       # identical rows in different tiles
        k = 12
    elif name == "inv_tau":
        q, p = rng.normal(size=(5, 32)), rng.normal(size=(100, 32))
        inv_tau, k = 20.0, 7
    else:
        raise ValueError(name)
    q, p = q.astype(np.float32), p.astype(np.float32)
    return q, p, k, valid, inv_tau


def _port(q, p, k, valid, inv_tau):
    s, i = ops.fused_topk(
        torch.as_tensor(q), torch.as_tensor(p), k,
        col_valid=None if valid is None else torch.as_tensor(valid),
        inv_tau=inv_tau,
    )
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("name", CASES)
def test_plain_fused_topk_matches_jax(name, jax_fn):
    q, p, k, valid, inv_tau = _case(name)
    jv = None if valid is None else jnp.asarray(valid)
    if jax_fn == "ref":
        ws, wi = jax_topk_ref(jnp.asarray(q), jnp.asarray(p), k, col_valid=jv, inv_tau=inv_tau)
    else:
        ws, wi = fused_topk_scores(jnp.asarray(q), jnp.asarray(p), k, col_valid=jv,
                                   inv_tau=inv_tau, block_q=8, block_n=32)
    s, i = _port(q, p, k, valid, inv_tau)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_allclose(s, np.asarray(ws), rtol=RTOL, atol=ATOL)


def test_k_exceeds_valid_tail_is_sentinel():
    q, p, k, valid, inv_tau = _case("k_exceeds_valid")
    s, i = _port(q, p, k, valid, inv_tau)
    assert np.all(i[:, 4:] == -1) and np.all(s[:, 4:] == np.float32(NEG_INF))


def test_ties_go_to_lowest_id():
    q, p, k, valid, inv_tau = _case("ties")
    s, i = _port(q, p, k, valid, inv_tau)
    for row_s, row_i in zip(s, i):
        for a in range(k - 1):
            if row_s[a] == row_s[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_bf16_inputs_match_jax():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(64, 16)).astype(np.float32) * (1.0 + np.arange(64))[:, None]
    q = rng.normal(size=(5, 16)).astype(np.float32)
    qb, pb = q.astype(ml_dtypes.bfloat16), p.astype(ml_dtypes.bfloat16)
    ws, wi = fused_topk_scores(jnp.asarray(qb), jnp.asarray(pb), 8, block_q=8, block_n=16)
    tq = torch.as_tensor(q).bfloat16()
    tp = torch.as_tensor(p).bfloat16()
    assert np.array_equal(tq.float().numpy(), qb.astype(np.float32))
    s, i = ops.fused_topk(tq, tp, 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL, atol=ATOL)


def test_mismatch_counts_only_clear_slots():
    ref_s = torch.tensor([[5.0, 4.0, 3.0, 2.9995]])
    ref_i = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    # slot 2 is within 2 * atol of the first score it did not keep: a swap
    # there is allowed, a swap at a clear slot is not
    ok = topk_mismatch(ref_s[:, :3], torch.tensor([[0, 1, 3]], dtype=torch.int32),
                       ref_s, ref_i, 1e-3)
    bad = topk_mismatch(ref_s[:, :3], torch.tensor([[1, 0, 2]], dtype=torch.int32),
                        ref_s, ref_i, 1e-3)
    assert ok == (0.0, 0, 2) and bad == (0.0, 2, 2)
    # empty slots (id -1) are clear: the id there must be -1 too
    tail_s = torch.tensor([[5.0, NEG_INF, NEG_INF]])
    tail_i = torch.tensor([[0, -1, -1]], dtype=torch.int32)
    assert topk_mismatch(tail_s, tail_i, tail_s, tail_i, 1e-3) == (0.0, 0, 3)
    assert topk_mismatch(tail_s, torch.tensor([[0, 1, -1]], dtype=torch.int32),
                         tail_s, tail_i, 1e-3) == (0.0, 1, 3)


@pytest.mark.parametrize("n_q,n,sms", [(2048, (1 << 20) - 37, 132), (32, 1 << 20, 132),
                                       (1, 100, 132), (300, 129, 8)])
def test_split_plan_covers_every_column_once(n_q, n, sms):
    splits, cols = ops.split_plan(n_q, n, sms)
    assert cols % ops.BLOCK_N == 0
    assert (splits - 1) * cols < n <= splits * cols    # no empty split
    assert splits <= max(1, sms)


@pytest.mark.parametrize("bad", ["k_zero", "k_too_big", "dtype", "shape", "mask",
                                 "strided"])
def test_wrapper_rejects_bad_input(bad):
    q, p = torch.randn(3, 8), torch.randn(20, 8)
    kw, k = {}, 5
    if bad == "k_zero":
        k = 0
    elif bad == "k_too_big":
        k = ops.K_MAX + 1
    elif bad == "dtype":
        q = q.half()
    elif bad == "shape":
        p = torch.randn(20, 9)
    elif bad == "strided":
        q = torch.randn(3, 2, 8)[:, 0]     # the kernel reads rows as packed
    else:
        kw["col_valid"] = torch.ones(19, dtype=torch.bool)
    with pytest.raises((ValueError, TypeError)):
        ops.fused_topk(q, p, k, **kw)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, p = torch.randn(4, 8), torch.randn(50, 8)
    before = ops.fused_topk.launches
    s, i = ops.fused_topk(q, p, 6)
    rs, ri = topk_scores_ref(q, p, 6)
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert ops.fused_topk.launches == before
