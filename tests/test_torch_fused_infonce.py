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

import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fused_infonce.fused_infonce import fused_infonce_fwd as jax_fwd
from repro.kernels.fused_infonce.ops import fused_infonce_stats as jax_stats
from repro.kernels.fused_infonce.ops import merge_row_stats as jax_merge
from repro.kernels.fused_infonce.ref import infonce_stats_ref as jax_stats_ref
from repro_torch.core.precision import NEG_INF
from repro_torch.kernels.fused_infonce import ops
from repro_torch.kernels.fused_infonce.ref import infonce_stats_ref
from repro_torch.kernels.fused_infonce.ref import infonce_stats_vjp_ref as ref_vjp

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


# ---- the Hopper forward's arithmetic: per-tile partials, then their merge


def _tile_partials_merged(q, p, labels, valid, inv_tau, tile=ops.PASSAGE_TILE):
    """The Hopper forward (csrc/fused_infonce.cu, hp::tile_partials and
    masked_partials, then infonce_stats_merge_kernel; the 3xTF32 forward's
    tx::infonce_tf32x3_fwd_kernel at tile = ops.TF32X3_FWD_PASSAGES) in fp32
    torch: per tile of ``tile`` columns each row's partial (max of the valid
    columns' s, sum of exp(s - max) over them, s at the label when it lies
    in the tile (-1e30 on a masked column) else 0); a wholly masked tile's
    partial without its scores: (-1e30, its in-range columns, -1e30 where
    the label lies in it); then the online-softmax merge of the partials."""
    s = (q.float() @ p.float().T) * inv_tau
    m, n = s.shape
    neg = torch.full((m,), NEG_INF)
    lab = labels.long()
    parts = []
    for n0 in range(0, n, tile):
        n1 = min(n0 + tile, n)
        v = valid[n0:n1]
        own = (lab >= n0) & (lab < n1)
        if not v.any():
            parts.append((neg, torch.full((m,), float(n1 - n0)),
                          torch.where(own, neg, torch.zeros(m))))
            continue
        st = s[:, n0:n1]
        mx = torch.where(v, st, NEG_INF).max(dim=1).values
        se = torch.where(v, torch.exp(st - mx[:, None]), 0.0).sum(dim=1)
        at = (lab - n0).clamp(0, n1 - n0 - 1)
        at_label = torch.where(v[at], st.gather(1, at[:, None])[:, 0], neg)
        parts.append((mx, se, torch.where(own, at_label, torch.zeros(m))))
    pm, pl, pp = (torch.stack(x, dim=1) for x in zip(*parts))
    amax = pm.max(dim=1).values
    lse = amax + torch.log((pl * torch.exp(pm - amax[:, None])).sum(dim=1))
    return lse, pp.sum(dim=1), amax


TILE_CASES = {
    # name: (m, n, d, inv_tau); the mask and labels are set in the test
    "masked_tile": (9, 150, 16, 1.0),      # columns 64..127 all masked, ragged last tile
    "all_masked": (5, 70, 8, 1.0),         # every column masked: fully masked rows
    "all_valid": (6, 133, 12, 2.5),
}


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_partials_merge_to_the_row_stats(name):
    """The forward's tile scheme, a wholly masked tile's partial set
    without its scores, equals the port's plain version (ref.py) and JAX's
    forward (the Pallas kernel in interpret mode) on the same inputs: a
    label on a masked column, labels outside [0, N) (past the JAX kernel's
    column padding) and fully masked rows included. fp32 at 1e-5."""
    m, n, d, inv_tau = TILE_CASES[name]
    q, p, labels, valid, _, _ = _problem(20 + sorted(TILE_CASES).index(name), m, n, d, 0.2)
    if name == "masked_tile":
        valid[64:128] = False
        labels[0] = 70                         # in the wholly masked tile
        valid[5] = False
        labels[1] = 5                          # a masked column of a computed tile
    elif name == "all_masked":
        valid[:] = False
    else:
        valid[:] = True
    labels[2], labels[3] = -1, n + 100         # outside [0, N): pos = 0
    got = _tile_partials_merged(_t(q), _t(p), torch.from_numpy(labels),
                                torch.from_numpy(valid), inv_tau)
    want_port = infonce_stats_ref(_t(q), _t(p), torch.from_numpy(labels),
                                  torch.from_numpy(valid), inv_tau=inv_tau)
    want_jax = jax_fwd(jnp.asarray(q), jnp.asarray(p), jnp.asarray(labels),
                       col_valid=jnp.asarray(valid), inv_tau=inv_tau, block_m=8, block_n=16,
                       interpret=True)
    for want in (want_port, want_jax):
        for g, w, what in zip(got, want, ("lse", "pos", "amax")):
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {what}")
    lse, pos, amax = (_np(x) for x in got)
    assert np.isfinite(lse).all()
    assert pos[2] == 0.0 and pos[3] == 0.0
    if name == "all_masked":
        assert (lse < NEG_INF / 2).all() and (amax == np.float32(NEG_INF)).all()
        assert (pos[[0, 1, 4]] == np.float32(NEG_INF)).all()
    if name == "masked_tile":
        assert pos[0] == np.float32(NEG_INF) and pos[1] == np.float32(NEG_INF)


def test_tf32x3_forward_tile_partials_merge_to_the_row_stats():
    """The 3xTF32 forward's partials over tiles of 128 passages (a wholly
    masked one, a label in it, a label on a masked column of a computed
    tile, labels outside [0, N) and past N inside the last tile's range)
    merge to ref.py's statistics and to JAX's forward at 1e-5."""
    m, n, d = 7, 300, 16
    q, p, labels, valid, _, _ = _problem(24, m, n, d, 0.2)
    valid[128:256] = False
    labels[0], labels[1] = 200, 7              # in the wholly masked tile; a masked column
    valid[7] = False
    labels[2], labels[3] = -1, n + 20          # outside [0, N), n + 20 inside tile 2's range
    args = (_t(q), _t(p), torch.from_numpy(labels), torch.from_numpy(valid))
    got = _tile_partials_merged(*args, 1.5, tile=ops.TF32X3_FWD_PASSAGES)
    want_jax = jax_fwd(jnp.asarray(q), jnp.asarray(p), jnp.asarray(labels),
                       col_valid=jnp.asarray(valid), inv_tau=1.5, block_m=8, block_n=16,
                       interpret=True)
    for want in (infonce_stats_ref(*args, inv_tau=1.5), want_jax):
        for g, w, what in zip(got, want, ("lse", "pos", "amax")):
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=RTOL, atol=ATOL,
                                       err_msg=what)
    pos = _np(got[1])
    assert pos[0] == pos[1] == np.float32(NEG_INF) and pos[2] == pos[3] == 0.0


# ---- the Hopper kernels' host-side plan (ops.py mirrors csrc/fused_infonce.cu)

PATH_N, PATH_D = 2064, 768      # a contaccum_bf16 chunk: 8 + 8 + 2048 columns, d = 768


@pytest.mark.parametrize("m", [17, 37, 130, 255, 256, 257, 767, 768, 769, 1000, 2048, 2049,
                               3000, 6144])
def test_dp_plan_gives_every_query_row_to_one_rank(m):
    """Each rank of a cluster holds the coefficients of rq consecutive rows
    (a multiple of the pass-1 tile, at most RANK_ROWS); together they hold
    rows 0..m-1 once, and every rank holds at least one."""
    ranks, rq = ops.dp_plan(m)
    assert 1 <= ranks <= ops.MAX_RANKS
    assert rq % ops.PASS1_TILE == 0 and 0 < rq <= ops.RANK_ROWS
    owned = [row for r in range(ranks) for row in range(r * rq, min(m, (r + 1) * rq))]
    assert owned == list(range(m))
    assert all(r * rq < m for r in range(ranks))


@pytest.mark.parametrize("m,n", [(17, 1), (2048, PATH_N), (130, 70), (6144, 4100), (37, 301)])
def test_dp_blocks_cover_every_passage_tile_and_query_row_once(m, n):
    """Block b of the cluster dP kernel is rank b % ranks of passage tile
    b // ranks: every (passage tile, query row) pair belongs to one block."""
    ranks, rq = ops.dp_plan(m)
    blocks = ops.hopper_blocks("dp", m, n)
    pairs = [(b // ranks, row) for b in range(blocks)
             for row in range((b % ranks) * rq, min(m, (b % ranks + 1) * rq))]
    tiles = -(-n // ops.PASSAGE_TILE)
    assert sorted(pairs) == [(t, row) for t in range(tiles) for row in range(m)]


@pytest.mark.parametrize("m", [0, 16, 6145])
def test_dp_plan_refuses_rows_outside_the_large_kernel(m):
    with pytest.raises(ValueError):
        ops.dp_plan(m)


@pytest.mark.parametrize("kind,m", [("dq", 8), ("dp", 8), ("dp", 2048), ("fwd", 8),
                                    ("fwd", 2048)])
def test_path_shapes_fit_one_wave_of_an_h100(kind, m):
    """At a contaccum_bf16 chunk's shapes a Hopper launch has at most one
    block per SM of an H100 SXM (132): 33 passage tiles, and 3 ranks each
    for dP's 2048 bank rows (33 clusters of 3; the card runs 39 at once),
    4 row groups of 512 each for the forward's."""
    blocks = ops.hopper_blocks(kind, m, PATH_N)
    assert blocks <= ops.H100_SMS
    assert blocks == {("dp", 2048): 99, ("fwd", 2048): 132}.get((kind, m), 33)
    if kind == "dp" and m == 2048:
        assert ops.dp_plan(m) == (3, 768)
    if kind == "fwd" and m == 2048:
        assert ops.fwd_plan(m, PATH_N) == 512


@pytest.mark.parametrize("m,n,sms", [(17, 2064, 132), (2048, 2064, 132), (2048, 2064, 114),
                                     (5000, 700, 132), (300, 100000, 132), (257, 64, 132),
                                     (6144, 1, 8)])
def test_fwd_plan_gives_every_query_row_to_one_block_per_tile(m, n, sms):
    """The many-row forward's row groups: rq a multiple of the 256-row
    query tile; groups of rq rows cover rows 0..m-1 once, each with at
    least one row; tiles x groups blocks fill no more than the SMs unless
    one group of all rows already exceeds them."""
    rq = ops.fwd_plan(m, n, sms)
    assert rq % ops.PASS1_TILE == 0 and rq > 0
    groups = -(-m // rq)
    owned = [row for gi in range(groups) for row in range(gi * rq, min(m, (gi + 1) * rq))]
    assert owned == list(range(m))
    tiles = -(-n // ops.PASSAGE_TILE)
    assert ops.hopper_blocks("fwd", m, n, sms) == tiles * groups
    assert tiles * groups <= max(sms, tiles)


def test_fwd_plan_refuses_the_small_kernels_rows():
    with pytest.raises(ValueError):
        ops.fwd_plan(ops.SMALL_M, PATH_N)


@pytest.mark.parametrize("kind,dtype,m,d,path", [
    ("dq", torch.bfloat16, 8, 768, "hopper"),       # the train path's local rows
    ("dp", torch.bfloat16, 8, 768, "hopper"),
    ("dp", torch.bfloat16, 2048, 768, "hopper"),    # the query-bank rows
    ("dq", torch.bfloat16, 16, 8, "hopper"),
    ("dq", torch.bfloat16, 17, 768, "wmma"),        # dQ of many rows: no caller
    ("dq", torch.bfloat16, 2048, 768, "wmma"),
    ("dp", torch.bfloat16, 37, 96, "hopper"),
    ("dp", torch.bfloat16, 6144, 1024, "hopper"),
    ("dp", torch.bfloat16, 6145, 768, "wmma"),      # more rows than 8 ranks hold
    ("dp", torch.bfloat16, 8, 1032, "hopper"),      # wider than one block's tile: the split kernel
    ("dp", torch.bfloat16, 8, 2048, "hopper"),      # the LM retriever's local rows
    ("dp", torch.bfloat16, 2048, 2048, "hopper"),   # and its query-bank rows
    ("dq", torch.bfloat16, 8, 2048, "hopper"),      # the split dQ at the LM's local rows
    ("fwd", torch.bfloat16, 8, 2048, "hopper"),     # the split forward
    ("fwd", torch.bfloat16, 2048, 2048, "hopper"),  # the many-row forward at any d
    ("dq", torch.bfloat16, 2048, 2048, "wmma"),     # dQ of many rows: no caller
    ("dp", torch.bfloat16, 16, ops.HOPPER_D_MAX, "hopper"),
    ("dp", torch.bfloat16, 17, ops.HOPPER_D_MAX, "hopper"),
    ("dp", torch.bfloat16, 8, ops.HOPPER_D_MAX + 8, "wmma"),
    ("dp", torch.bfloat16, 2048, ops.HOPPER_D_MAX + 8, "wmma"),
    ("fwd", torch.bfloat16, 16, ops.HOPPER_D_MAX, "hopper"),
    ("fwd", torch.bfloat16, 17, ops.HOPPER_D_MAX, "hopper"),
    ("fwd", torch.bfloat16, 8, ops.HOPPER_D_MAX + 8, "wmma"),
    ("fwd", torch.bfloat16, 2048, ops.HOPPER_D_MAX + 8, "wmma"),
    ("dq", torch.bfloat16, 16, ops.HOPPER_D_MAX, "hopper"),
    ("dq", torch.bfloat16, 8, ops.HOPPER_D_MAX + 8, "wmma"),
    ("dq", torch.bfloat16, 8, 20, "wmma"),          # rows of 40 bytes: no TMA
    ("dp", torch.bfloat16, 2048, 36, "wmma"),
    ("dq", torch.float32, 8, 768, "tf32x3"),        # fp32 dQ and dP: 3xTF32 on wgmma
    ("dp", torch.float32, 2048, 768, "tf32x3"),
    ("dq", torch.float32, 32, 768, "tf32x3"),       # the xdev path's local rows
    ("dp", torch.float32, 32, 768, "tf32x3"),
    ("dp", torch.float32, 8192, 768, "tf32x3"),     # its bank rows
    ("dq", torch.float32, 8224, 768, "tf32x3"),     # the ring's rows
    ("dp", torch.float32, 8224, 768, "tf32x3"),
    ("dq", torch.float32, 8, 4, "tf32x3"),
    ("dp", torch.float32, 8, ops.TF32X3_D_MAX, "tf32x3"),
    ("dq", torch.float32, 8, 42, "fp32"),           # rows of 168 bytes: no TMA
    ("dp", torch.float32, 2048, 42, "fp32"),
    ("dq", torch.float32, 8, ops.TF32X3_D_MAX + 4, "fp32"),   # wider than 8 ranks hold
    ("dp", torch.float32, 2048, 2048, "fp32"),
    ("fwd", torch.float32, 8192, 768, "tf32x3"),    # the fp32 forward on 3xTF32: the xdev bank rows
    ("fwd", torch.float32, 32, 768, "tf32x3"),      # the xdev local rows
    ("fwd", torch.float32, 8224, 768, "tf32x3"),    # the ring's rows (bank and in-batch chunks)
    ("fwd", torch.float32, 1, 4, "tf32x3"),
    ("fwd", torch.float32, 8, ops.TF32X3_FWD_D_MAX, "tf32x3"),
    ("fwd", torch.float32, 8, 42, "fp32"),          # rows of 168 bytes: no TMA
    ("fwd", torch.float32, 2048, ops.TF32X3_FWD_D_MAX + 4, "fp32"),   # wider than it takes
    ("fwd", torch.bfloat16, 8, 768, "hopper"),      # the train path's two forward shapes
    ("fwd", torch.bfloat16, 2048, 768, "hopper"),
    ("fwd", torch.bfloat16, 17, 96, "hopper"),
    ("fwd", torch.bfloat16, 9000, 1024, "hopper"),  # any M
    ("fwd", torch.bfloat16, 8, 1032, "hopper"),     # wider than one small block: the split kernel
    ("fwd", torch.bfloat16, 2048, 36, "wmma"),      # rows of 72 bytes: no TMA
    ("fwd", torch.float32, 2048, 768, "tf32x3"),    # bench.py's fp32 case
])
def test_path_of_each_shape(kind, dtype, m, d, path):
    assert ops.path_of(kind, dtype, m, d) == path



def test_reset_launches_clears_every_path():
    ops.fused_infonce_fwd.paths["hopper"] += 2
    ops.fused_infonce_dq.paths["hopper"] += 3
    ops.fused_infonce_dp.paths["wmma"] += 1
    ops.fused_infonce_dp.launches += 1
    ops.reset_launches()
    assert ops.fused_infonce_fwd.paths == dict.fromkeys(ops.PATHS, 0)
    assert ops.fused_infonce_dq.paths == dict.fromkeys(ops.PATHS, 0)
    assert ops.fused_infonce_dp.paths == dict.fromkeys(ops.PATHS, 0)
    assert ops.fused_infonce_dp.launches == 0


# ---- past SMALL_D_MAX (the LM retriever's d = 2048) --------------------------

LM_D = 2048


@pytest.mark.parametrize("m", [1, 8, 16, 17, 2048])
def test_path_of_dp_at_the_lm_width(m):
    """d = 2048: the forward and dP on the Hopper path at every M, dQ at up
    to SMALL_M rows (above, dQ has no caller and keeps wmma); one name,
    HOPPER_D_MAX, for the widest Hopper row of all three."""
    assert ops.path_of("dp", torch.bfloat16, m, LM_D) == "hopper"
    assert ops.path_of("fwd", torch.bfloat16, m, LM_D) == "hopper"
    assert ops.path_of("dq", torch.bfloat16, m, LM_D) == (
        "hopper" if m <= ops.SMALL_M else "wmma")
    assert ops.SMALL_D_MAX == 1024 and ops.HOPPER_D_MAX == 8192


def _split_shares(d):
    """Rank r's d-chunks of the split kernels: [r nc / ranks, (r + 1) nc /
    ranks) (csrc: split_share)."""
    nc, ranks = -(-d // 64), ops.small_ranks(d)
    return nc, [range(r * nc // ranks, (r + 1) * nc // ranks) for r in range(ranks)]


@pytest.mark.parametrize("d", [8, 768, 1024, 1032, 1088, 1280, 2048, 2560, 4096, 8192])
def test_split_dp_ranks_cover_every_d_chunk_once(d):
    """At up to SMALL_M rows past SMALL_D_MAX a cluster of small_ranks(d)
    blocks takes each passage tile, rank r the d-chunks [r nc / ranks, (r +
    1) nc / ranks): together every chunk once, each rank at least one and
    at most 16 (one block's tile, the kernel's NC_MAX); one rank (the small
    kernel) up to SMALL_D_MAX; at most MAX_RANKS (a portable cluster)."""
    nc, shares = _split_shares(d)
    ranks = len(shares)
    assert (ranks == 1) == (d <= ops.SMALL_D_MAX) and ranks <= ops.MAX_RANKS
    assert [c for share in shares for c in share] == list(range(nc))
    assert all(1 <= len(share) <= ops.SMALL_D_MAX // 64 for share in shares)
    assert ops.hopper_blocks("dp", 8, PATH_N, d=d) == 33 * ranks
    assert {2048: 2, 2560: 3}.get(d, ranks) == ranks


@pytest.mark.parametrize("d", [1032, 1088, 2048, 2560, 4096, 8192])
@pytest.mark.parametrize("kind", ["fwd", "dq"])
def test_split_fwd_and_dq_ranks_cover_every_d_chunk_once(kind, d):
    """The forward's and dQ's split kernels at up to SMALL_M rows take the
    dP split's plan: small_ranks(d) ranks a passage tile, together every
    d-chunk once, each rank 1 to 16 of them; 66 blocks at the LM chunk (d
    = 2048, N = 2064), 33 clusters of 2."""
    nc, shares = _split_shares(d)
    assert [c for share in shares for c in share] == list(range(nc))
    assert all(1 <= len(share) <= ops.SMALL_D_MAX // 64 for share in shares)
    assert 2 <= len(shares) <= ops.MAX_RANKS
    for m in (1, 8, ops.SMALL_M):
        assert ops.path_of(kind, torch.bfloat16, m, d) == "hopper"
        assert ops.hopper_blocks(kind, m, PATH_N, d=d) == 33 * len(shares)
    if d == LM_D:
        assert ops.hopper_blocks(kind, 8, PATH_N, d=d) == 66


def test_split_dp_refuses_rows_past_its_widest():
    with pytest.raises(ValueError):
        ops.small_ranks(ops.HOPPER_D_MAX + 8)


def test_split_dp_shared_memory_fits_a_block():
    """The split kernels' plan (csrc: split_smem) at their largest share of
    16 d-chunks: the small kernel's tile of P and queries (10 KB a chunk),
    the coefficient area, the query values and barriers, then 4 KB of
    partial scores, under the 227 KB a block may use; the source states the
    same constants and has the three split kernels (forward, dQ, dP)."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
           / "fused_infonce" / "csrc" / "fused_infonce.cu").read_text()
    nc = ops.SMALL_D_MAX // 64
    small_bar = nc * (8192 + 2048) + 16 * 128 + 4 * 16 * 4
    split = -(-(small_bar + 8 * nc) // 16) * 16 + 128 * 32 + 1024
    assert split <= 232_448
    assert "constexpr int NC_MAX = 16;" in src and "infonce_dp_split_kernel(" in src
    assert "split_smem(int nc) { return split_off_x(nc) + 128 * 32 + 1024; }" in src
    split = ("infonce_dp_split_kernel", "infonce_fwd_split_kernel", "infonce_dq_split_kernel")
    assert ops.KERNELS[-3:] == split
    assert all(f"{name}(" in src and name in ops.HOPPER_KERNELS for name in split)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m", [8, 20])
def test_dp_at_the_lm_width_matches_jax(m, dtype):
    """d = 2048 with masked columns: the port's fused_infonce_dp (its plain
    version on the CPU) for the port's forward lse against the JAX
    package's dP (its Pallas kernels in interpret mode, through jax.vjp).
    fp32 within the file's rtol and atol of 1e-5; bf16 within 2e-2 of the
    largest gradient (the file's reason: JAX rounds each coefficient to
    bf16 before its product)."""
    np_dtype = np.float32 if dtype == "fp32" else ml_dtypes.bfloat16
    q, p, labels, valid, g_lse, g_pos = _problem(2048 + m, m, 40, LM_D, 0.3, np_dtype,
                                                 scale=LM_D ** -0.5)
    want = _jax(q, p, labels, valid, g_lse, g_pos, 1.0)[4]
    tq, tp = _t(q), _t(p)
    tl, tv = torch.from_numpy(labels), torch.from_numpy(valid)
    lse = ops.fused_infonce_fwd(tq, tp, tl, tv)[0]
    got = _np(ops.fused_infonce_dp(tq, tp, tl, tv, lse, _t(g_lse), _t(g_pos)))
    assert ops.path_of("dp", tp.dtype, m, LM_D) == ("hopper" if dtype == "bf16" else "fp32")
    assert not got[~valid].any()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_stats_and_vjp_at_the_lm_width_match_jax_bf16():
    """d = 2048, M = 8 (the split forward and dQ on the card), bf16 with
    masked columns, a label on a masked column and one outside [0, N): the
    port's stats and VJP (its plain version on the CPU, through the
    autograd Function) against the JAX fused op (its Pallas kernels in
    interpret mode). The statistics within the file's rtol and atol of
    1e-5; dQ and dP within 2e-2 of the largest gradient (the file's reason:
    JAX rounds each coefficient to bf16 before its product)."""
    q, p, labels, valid, g_lse, g_pos = _problem(2056, 8, 40, LM_D, 0.3, ml_dtypes.bfloat16,
                                                 scale=LM_D ** -0.5)
    valid[5] = False
    labels[1], labels[2] = 5, 40 + 100
    want = _jax(q, p, labels, valid, g_lse, g_pos, 1.0)
    got = _port(q, p, labels, valid, g_lse, g_pos, 1.0)
    for kind in ("fwd", "dq", "dp"):
        assert ops.path_of(kind, torch.bfloat16, 8, LM_D) == "hopper"
    assert got[1][1] == np.float32(NEG_INF) and got[1][2] == 0.0
    for g, w, what in zip(got[:3], want[:3], ("lse", "pos", "amax")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)
    for g, w, what in zip(got[3:], want[3:], ("dq", "dp")):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), what
    assert not got[4][~valid].any()


# ---- the fp32 dQ and dP on 3xTF32 ("tf32x3") ---------------------------------

#: (X rows, Y rows) of a dQ or dP call: dQ's output rows are the queries and
#: its contraction rows the passages, dP the other way round
XDEV_SHAPES = {
    "bank_rows_dp": (8256, 8192), "local_rows_dp": (8256, 32), "local_rows_dq": (32, 8256),
    "ring_bank_chunk_dq": (8224, 8192), "ring_inbatch_chunk_dq": (8224, 64),
    "ring_inbatch_chunk_dp": (64, 8224), "bench_dq": (2048, 2064), "bench_dp": (2064, 2048),
}


def test_tf32x3_ranks_share_d_in_192_columns():
    """A cluster's ranks split d in 192 columns (3 M-tiles of 64 of the
    gradient's accumulators): 4 ranks at d = 768, 1 up to 192, 8 at the
    widest row; no other d is taken."""
    assert ops.TF32X3_RANK_COLS == 192 and ops.TF32X3_D_MAX == 8 * 192
    for d, ranks in ((4, 1), (40, 1), (192, 1), (196, 2), (384, 2), (768, 4),
                     (ops.TF32X3_D_MAX, 8)):
        assert ops.tf32x3_ranks(d) == ranks
    for d in (42, 0, ops.TF32X3_D_MAX + 4):
        with pytest.raises(ValueError):
            ops.tf32x3_ranks(d)


def _tf32x3_blocks(x_rows, y_rows, d, max_clusters):
    """The (output tile, contraction step) pairs and the columns of d each
    block of a 3xTF32 launch takes, by the kernel's index arithmetic
    (csrc: infonce_tf32x3_kernel): cluster cid on X tile cid / splits and
    steps [s per, min(steps, (s + 1) per)), s = cid % splits; rank r on
    columns [192 r, 192 r + 192)."""
    ranks = ops.tf32x3_ranks(d)
    x_tiles = -(-x_rows // ops.TF32X3_TILE)
    steps = -(-y_rows // ops.TF32X3_STEP)
    splits, per = ops.tf32x3_split_plan(x_tiles, steps, max_clusters)
    pairs, cols = [], []
    for cid in range(x_tiles * splits):
        tile, split = divmod(cid, splits)
        t0, t1 = split * per, min(steps, split * per + per)
        assert t0 < t1, "a split with no step"
        pairs += [(tile, t) for t in range(t0, t1)]
    for r in range(ranks):
        cols.append(range(r * ops.TF32X3_RANK_COLS, min(d, (r + 1) * ops.TF32X3_RANK_COLS)))
    return x_tiles, steps, splits, ranks, pairs, cols


@pytest.mark.parametrize("shape", sorted(XDEV_SHAPES))
@pytest.mark.parametrize("d", [768, 40, 200])
def test_tf32x3_plan_covers_every_tile_step_and_column_once(shape, d):
    """At the xdev path's shapes and bench.py's (30 clusters of 4 at once on
    an H100, as cudaOccupancyMaxActiveClusters reports; 132 blocks of one):
    every (output tile, step) pair once, every column of d in one rank, no
    rank without a column; the contraction axis split only where the output
    tiles leave half the clusters idle (the 32 local queries' dQ and the
    in-batch dP: one tile each)."""
    x_rows, y_rows = XDEV_SHAPES[shape]
    max_clusters = 30 if d > ops.TF32X3_RANK_COLS else 132
    x_tiles, steps, splits, ranks, pairs, cols = _tf32x3_blocks(x_rows, y_rows, d, max_clusters)
    assert sorted(pairs) == [(x, t) for x in range(x_tiles) for t in range(steps)]
    assert [c for r in cols for c in r] == list(range(d)) and all(len(r) for r in cols)
    assert (splits > 1) == (2 * x_tiles <= max_clusters)
    assert x_tiles * splits <= max(max_clusters, x_tiles)
    if d == 768 and shape == "local_rows_dq":
        assert (ranks, x_tiles, steps, splits) == (4, 1, 258, 29)


@pytest.mark.parametrize("x_rows,y_rows,d,max_clusters", [
    (37, 301, 96, 132), (301, 37, 96, 132), (5, 37, 40, 132), (1, 1, 4, 132),
    (65, 4100, 40, 132), (130, 70, 768, 30), (2048, 300, 200, 66), (8, 2064, ops.TF32X3_D_MAX, 16),
])
def test_tf32x3_plan_covers_ragged_shapes(x_rows, y_rows, d, max_clusters):
    x_tiles, steps, splits, ranks, pairs, cols = _tf32x3_blocks(x_rows, y_rows, d, max_clusters)
    assert sorted(pairs) == [(x, t) for x in range(x_tiles) for t in range(steps)]
    assert [c for r in cols for c in r] == list(range(d))
    assert 1 <= ranks <= ops.MAX_RANKS and splits <= steps


def test_tf32x3_shared_memory_fits_a_block():
    """The 3xTF32 block's plan (csrc: tx::SMEM, mirrored by
    ops.tf32x3_smem): X's hi and lo boxes resident, two stages of a step's Y
    boxes, C's hi and lo box, two 8 KB exchange buffers of partial scores,
    the step's query values, the barriers and the alignment slack, under
    the 227 KB a block may use; the source states the same constants."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
           / "fused_infonce" / "csrc" / "fused_infonce.cu").read_text()
    assert ops.tf32x3_smem() <= 232_448
    for line in ("constexpr int XT = 64;", "constexpr int YT = 32;", "constexpr int PAIRS = 3;",
                 "constexpr int NSTAGE = 2;", "constexpr int SMEM = OFF_BAR + 8 * N_BARS + 1024;"):
        assert line in src, line
    assert (ops.TF32X3_TILE, ops.TF32X3_STEP, ops.TF32X3_RANK_COLS) == (64, 32, 3 * 64)
    assert all(name in ops.KERNELS for name in ops.TF32X3_KERNELS)


#: (M query rows, N passages) of the 3xTF32 forward on the xdev path and bench.py's fp32 case
XDEV_FWD_SHAPES = {"bank_rows": (8192, 8256), "local_rows": (32, 8256),
                   "ring_bank_chunk": (8224, 8192), "ring_inbatch_chunk": (8224, 64),
                   "bench": (2048, 2064)}


def _tf32x3_fwd_tile(b, q_tiles, p_tiles):
    """(query tile, passage tile) of block b of the 3xTF32 forward, as csrc
    tx::fwd_tile orders them: groups of TF32X3_FWD_GROUP query tiles, each
    walking every passage tile with its query tiles innermost."""
    per_group = ops.TF32X3_FWD_GROUP * p_tiles
    first = b // per_group * ops.TF32X3_FWD_GROUP
    size, r = min(q_tiles - first, ops.TF32X3_FWD_GROUP), b % per_group
    return first + r % size, r // size


def _tf32x3_fwd_blocks(m, n, d):
    """Each block's (query rows, passages) of a 3xTF32 forward launch, by the
    kernel's index arithmetic (csrc: infonce_tf32x3_fwd_kernel, fwd_tile):
    block b on query tile qt and passage tile pt (_tf32x3_fwd_tile), rows
    [128 qt, 128 qt + 128) and passages [128 pt, 128 pt + 128), each cut at
    M and N; warpgroup w on rows 64 w .. of the tile, idle where they all
    lie past M."""
    q_tiles, p_tiles = ops.tf32x3_fwd_tiles(m, n, d)
    rows_a, cols_a = ops.TF32X3_FWD_ROWS, ops.TF32X3_FWD_PASSAGES
    blocks = []
    for b in range(q_tiles * p_tiles):
        qt, pt = _tf32x3_fwd_tile(b, q_tiles, p_tiles)
        q0, n0 = qt * rows_a, pt * cols_a
        groups = [range(q0 + 64 * w, min(m, q0 + 64 * w + 64)) for w in range(2)]
        blocks.append(((qt, pt), [g for g in groups if len(g)], range(n0, min(n, n0 + cols_a))))
    return q_tiles, p_tiles, blocks


@pytest.mark.parametrize("shape", sorted(XDEV_FWD_SHAPES))
def test_tf32x3_forward_plan_covers_every_row_and_passage_once(shape):
    """At the xdev path's shapes and bench.py's: every (query tile, passage
    tile) pair in one block, the tiles' rows and passages a partition of
    [0, M) and [0, N), so every (row, passage) pair is computed once; no
    block without a row or a passage; the 32 local rows leave the second
    warpgroup idle."""
    m, n = XDEV_FWD_SHAPES[shape]
    q_tiles, p_tiles, blocks = _tf32x3_fwd_blocks(m, n, 768)
    assert sorted(t for t, _, _ in blocks) == [(a, b) for a in range(q_tiles)
                                               for b in range(p_tiles)]
    rows = {qt: [r for g in groups for r in g] for (qt, _), groups, _ in blocks}
    cols = {pt: list(c) for (_, pt), _, c in blocks}
    assert sorted(r for rs in rows.values() for r in rs) == list(range(m))
    assert sorted(c for cs in cols.values() for c in cs) == list(range(n))
    assert all(groups and len(c) for _, groups, c in blocks)
    if shape == "local_rows":
        assert all(len(groups) == 1 for _, groups, _ in blocks) and q_tiles == 1
    if shape == "bank_rows":
        assert (q_tiles, p_tiles) == (64, 65)


@pytest.mark.parametrize("m,n,d", [(1, 1, 4), (37, 301, 96), (130, 70, 768), (65, 4100, 40),
                                   (129, 129, 8), (1000, 500, 196), (300, 500, 8192),
                                   (17 * 128 + 3, 3 * 128, 768)])
def test_tf32x3_forward_plan_covers_ragged_shapes(m, n, d):
    """Ragged M and N, and more query tiles than a group of FWD_GROUP (a last
    group of 1): every (row, passage) pair once, counted."""
    _, _, blocks = _tf32x3_fwd_blocks(m, n, d)
    seen = np.zeros((m, n), np.int32)
    for _, groups, c in blocks:
        for g in groups:
            seen[g.start:g.stop, c.start:c.stop] += 1
    assert (seen == 1).all()


def test_tf32x3_forward_refuses_other_widths():
    for d in (42, 0, ops.TF32X3_FWD_D_MAX + 4):
        with pytest.raises(ValueError):
            ops.tf32x3_fwd_tiles(8, 64, d)
        assert d == 0 or ops.path_of("fwd", torch.float32, 8, d) == "fp32"


def test_tf32x3_forward_shared_memory_fits_a_block():
    """The 3xTF32 forward's plan (csrc: tx::FSMEM, mirrored by
    ops.tf32x3_fwd_smem): three stages of a 32-column chunk's q and p hi and
    lo boxes of 128 rows (64 KB a stage), a full and an empty barrier a
    stage and the alignment slack, under the 227 KB a block may use; the
    source states the same constants and the block order the tests mirror."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
           / "fused_infonce" / "csrc" / "fused_infonce.cu").read_text()
    assert ops.tf32x3_fwd_smem() == 3 * 4 * 128 * 128 + 48 + 1024 <= 232_448
    for line in ("constexpr int FQ = 128;", "constexpr int FP = 128;",
                 "constexpr int FBOX = 128 * 128;", "constexpr int FSTAGE = 4 * FBOX;",
                 "constexpr int FS = 3;", "constexpr int FGROUP = 8;",
                 "constexpr int FSMEM = OFF_FBAR + 8 * 2 * FS + 1024;",
                 # tx::fwd_tile, which _tf32x3_fwd_tile mirrors
                 "const int per_group = FGROUP * p_tiles, first = b / per_group * FGROUP;",
                 "const int size = min(q_tiles - first, FGROUP), r = b % per_group;",
                 "qt = first + r % size;", "pt = r / size;"):
        assert line in src, line
    assert (ops.TF32X3_FWD_ROWS, ops.TF32X3_FWD_PASSAGES, ops.TF32X3_FWD_GROUP) == (128, 128, 8)
    assert ops.TF32X3_FWD_D_MAX == ops.HOPPER_D_MAX
    assert "infonce_tf32x3_fwd_kernel" in ops.KERNELS and \
        "infonce_tf32x3_fwd_kernel" in ops.TF32X3_KERNELS


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, 10 mantissa bits kept (the low 13 bits of the fp32 pattern 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32x3_parts(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32x3_mm(a, b, passes):
    """a @ b.T in tf32 passes: hi hi + (hi lo + lo hi), or hi hi alone (passes 1)."""
    (ah, al), (bh, bl) = _tf32x3_parts(a), _tf32x3_parts(b)
    out = ah @ bh.T
    return out + (ah @ bl.T + al @ bh.T) if passes == 3 else out


def _tf32x3_chunked(a, b, step, prod, dtype=torch.float32):
    """prod of each `step` columns, fresh, summed in order in `dtype`."""
    total = torch.zeros(a.shape[0], b.shape[0], dtype=dtype)
    for k in range(0, a.shape[1], step):
        total += prod(a[:, k:k + step].contiguous(), b[:, k:k + step].contiguous()).to(dtype)
    return total.float()


def _tf32x3_lse(q, p, valid, passes):
    """The 3xTF32 forward's lse (csrc: infonce_tf32x3_fwd_kernel) in torch on
    the CPU: each 16 columns of d in a fresh accumulator of tf32 products
    (passes 3: hi hi + hi lo + lo hi; passes 1: one TF32 pass), the fresh
    sums added to the score in fp32, in order; masked columns -1e30."""
    scores = _tf32x3_chunked(q, p, 16, lambda a, b: _tf32x3_mm(a, b, passes))
    scores[:, ~valid] = NEG_INF
    return torch.logsumexp(scores, dim=1)


def _tf32x3_vjp(q, p, labels, valid, g_lse, g_pos, passes, fwd_passes=3):
    """dQ and dP as the 3xTF32 kernels compute them, in torch on the CPU:
    q and p split into tf32 hi and lo (passes 3: hi hi + hi lo + lo hi;
    passes 1: hi hi alone, one-pass TF32); each 16-column half-chunk of the
    scores in a fresh fp32 accumulator (the kernel's promotion), the
    half-chunks' sums added in float64 and rounded once (the kernel adds
    them in fp32 at a fraction of the score's size and keeps the rounding
    errors of the larger sums); the coefficients against the 3xTF32
    forward's lse (_tf32x3_lse with fwd_passes), in fp32, split as well;
    each gradient summed over steps of 32 contraction rows, each step's
    products in a fresh accumulator."""
    def mm(a, b):
        return _tf32x3_mm(a, b, passes)

    scores = _tf32x3_chunked(q, p, 16, mm, torch.float64)
    lse = _tf32x3_lse(q, p, valid, fwd_passes)
    c = torch.exp(scores - lse[:, None]) * g_lse[:, None]
    rows = torch.arange(len(labels))
    c[rows, labels.long()] += g_pos
    c[:, ~valid] = 0.0
    dq = _tf32x3_chunked(c, p.T.contiguous(), ops.TF32X3_STEP, mm)
    dp = _tf32x3_chunked(c.T.contiguous(), q.T.contiguous(), ops.TF32X3_STEP, mm)
    return dq, dp


@pytest.fixture
def one_thread():
    """One torch thread for the test (the suite runs 6 workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_tf32x3_products_hold_to_fp32_on_the_cpu(one_thread):
    """The design's numerics at the xdev phase's magnitudes (d = 768, rows
    of norm ~27.7: logits up to ~100, a peaked softmax; M = 64, N = 256, 10%
    of the columns masked), emulated in torch with the kernel's rounding
    (_tf32x3_vjp): 3-pass products give dQ and dP within GRAD_RTOL_FP32
    (1e-4, chip_smoke.py's) of the largest |g| of the fp32 plain version
    and an error against ref.py in float64 at most 10x the plain version's
    own; 1-pass products (one TF32 product) break both by far."""
    q, p, labels, valid, g_lse, g_pos = (_t(a) for a in _problem(32, 64, 256, 768, 0.1))
    plain = ref_vjp(q, p, labels, valid, g_lse, g_pos)
    exact = ref_vjp(q, p, labels, valid, g_lse, g_pos, dtype=torch.float64)
    for passes in (3, 1):
        got = _tf32x3_vjp(q, p, labels, valid, g_lse, g_pos, passes)
        for g, want, want64, what in zip(got, plain, exact, ("dq", "dp")):
            rel = (g - want).abs().max().item() / want.abs().max().item()
            x64 = ((g.double() - want64).abs().max()
                   / (want.double() - want64).abs().max()).item()
            if passes == 3:
                assert rel <= 1e-4 and x64 <= 10, (what, rel, x64)
            else:
                assert rel > 1e-3 and x64 > 100, (what, rel, x64)


def test_tf32x3_forward_holds_lse_and_the_backward_on_the_cpu(one_thread):
    """The 3xTF32 forward's numerics at the xdev phase's magnitudes (as
    above), emulated with its rounding (_tf32x3_lse: 16-column fresh sums
    added in fp32): its lse within 10x (FP64_ERR_RATIO) of the fp32 plain
    version's own error against ref.py in float64, and dQ and dP of 3-pass
    products taken against it within the bounds of
    test_tf32x3_products_hold_to_fp32_on_the_cpu; a 1-pass TF32 forward's
    lse, and the gradients against it, break them by far."""
    q, p, labels, valid, g_lse, g_pos = (_t(a) for a in _problem(32, 64, 256, 768, 0.1))
    plain_lse = infonce_stats_ref(q, p, labels, valid)[0]
    exact_lse = infonce_stats_ref(q, p, labels, valid, dtype=torch.float64)[0]
    own = (plain_lse.double() - exact_lse).abs().max().item()
    plain = ref_vjp(q, p, labels, valid, g_lse, g_pos)
    exact = ref_vjp(q, p, labels, valid, g_lse, g_pos, dtype=torch.float64)
    for fwd_passes in (3, 1):
        err = (_tf32x3_lse(q, p, valid, fwd_passes).double() - exact_lse).abs().max().item()
        got = _tf32x3_vjp(q, p, labels, valid, g_lse, g_pos, 3, fwd_passes)
        for g, want, want64, what in zip(got, plain, exact, ("dq", "dp")):
            rel = (g - want).abs().max().item() / want.abs().max().item()
            x64 = ((g.double() - want64).abs().max()
                   / (want.double() - want64).abs().max()).item()
            if fwd_passes == 3:
                assert err <= 10 * own, (err, own)
                assert rel <= 1e-4 and x64 <= 10, (what, rel, x64)
            else:
                assert err > 100 * own, (err, own)
                assert rel > 1e-3 and x64 > 100, (what, rel, x64)
