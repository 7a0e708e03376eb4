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

import pathlib
import re

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

REPO = pathlib.Path(__file__).resolve().parents[1]
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


@pytest.mark.parametrize("max_splits", [1, 2, 3, 50])
@pytest.mark.parametrize("n_q,n,sms", [(2048, (1 << 20) - 37, 132), (32, 1 << 20, 132),
                                       (70, 9000, 132)])
def test_split_plan_under_a_state_cap_covers_every_column_once(n_q, n, sms, max_splits):
    splits, cols = ops.split_plan(n_q, n, sms, max_splits)
    assert cols % ops.BLOCK_N == 0
    assert (splits - 1) * cols < n <= splits * cols
    assert splits <= max_splits


KERNEL_SOURCE = (REPO / "src" / "repro_torch" / "kernels" / "fused_topk" / "csrc"
                 / "fused_topk.cu")


@pytest.mark.parametrize("d", [8, 24, 64, 96, 256, 512, 768, 1024, 1216, 1472, 2048, 2560,
                               ops.HOPPER_D_MAX, ops.HOPPER_D_MAX + 8])
def test_scan_plan_fits_the_shared_memory_budget(d):
    """Every Hopper plan fits the 227 KB a block may use with 2-4 stages in
    each consumer's ring, spreads at most 32 query rows over the warps,
    keeps the query tile resident wherever a resident plan fits and streams
    it only where none does, stages a row's whole pool (2 kp keys) for its
    cuts only up to 512 keys, and takes as many stages as the rest holds
    (each k and Q of the grid); past HOPPER_D_MAX there is no plan."""
    for k in (1, 100, 128, 129, 256, 257, 1000, ops.K_MAX):
        for n_q in (1, 32, 33, 2048):
            plan = ops.scan_plan(d, k, n_q)
            if plan is None:   # only rows past the widest planned
                assert d > ops.HOPPER_D_MAX, (d, k, n_q)
                continue
            layout, stages, stage_keys = plan
            resident = ops.SPREAD if n_q <= 32 else ops.RESIDENT
            assert layout == (resident if ops.layout_plan(d, resident, k) else ops.STREAMED)
            assert 2 <= stages <= ops.MAX_STAGES
            assert ops.scan_smem_bytes(d, layout, stages, stage_keys) <= ops.SMEM_LIMIT
            assert stage_keys in (0, 2 * ops.state_pairs(k))
            assert stage_keys <= ops.STAGE_KEYS_MAX
            if stages < ops.MAX_STAGES:
                assert ops.scan_smem_bytes(d, layout, stages + 1, stage_keys) > ops.SMEM_LIMIT


def test_scan_plan_at_the_served_width_is_the_one_the_kernel_states():
    """d = 768 (dpr-bert-base): the plans the kernel's header states, byte
    for byte, and the constants the Python mirror shares with the source."""
    src = KERNEL_SOURCE.read_text()
    assert ops.scan_plan(768, 100, 32) == (True, 4, 256)          # serve_topk
    assert ops.scan_plan(768, 100, 2048) == (False, 3, 256)       # eval_topk
    assert ops.scan_plan(768, 1000, 2048) == (False, 3, 0)
    assert ops.scan_smem_bytes(768, False, 3, 256) == 222_856
    assert ops.scan_smem_bytes(768, True, 4, 256) == 206_472
    assert "3 stages a ring, 222,856 bytes" in src and "(spread) 4, 206,472 bytes" in src
    for name, value in (("HQ", ops.BLOCK_Q), ("HN", ops.BLOCK_N), ("MAX_STAGES", ops.MAX_STAGES),
                        ("CONSUMERS", ops.CONSUMERS),
                        ("SMEM_LIMIT", ops.SMEM_LIMIT), ("ALIGN_SLACK", ops.ALIGN_SLACK),
                        ("STAGE_KEYS_MAX", ops.STAGE_KEYS_MAX),
                        ("SORT_SMEM_KEYS", ops.SORT_SMEM_KEYS), ("BINS", 256)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert ops.HIST_BYTES == 4 * ops.CONSUMERS * 256 * 4
    assert ops.BARRIER_BYTES == 8 * (1 + 2 * ops.CONSUMERS * ops.MAX_STAGES)


@pytest.mark.parametrize("dtype,d,k,path", [
    (torch.bfloat16, 768, 100, "hopper"),          # serve_topk and eval_topk
    (torch.bfloat16, 768, 20, "hopper"),           # the Top@k eval
    (torch.bfloat16, 768, 1000, "hopper"),
    (torch.bfloat16, 20, 129, "hopper"),           # padded to 24 columns
    (torch.bfloat16, 33, 1, "hopper"),             # padded to 40 columns
    (torch.bfloat16, 1216, 100, "hopper"),         # the widest resident tile
    (torch.bfloat16, 1280, 100, "hopper"),         # streamed from here
    (torch.bfloat16, 2048, 20, "hopper"),          # the LM retriever's eval search
    (torch.bfloat16, 2048, 100, "hopper"),
    (torch.bfloat16, 2560, 100, "hopper"),         # stablelm-3b's width
    (torch.bfloat16, ops.HOPPER_D_MAX, 100, "hopper"),
    (torch.bfloat16, ops.HOPPER_D_MAX + 8, 100, "fp32_widened"),
    (torch.float32, 768, 100, "fp32"),
    (torch.float32, 2048, 20, "fp32"),
])
def test_path_of_each_shape(dtype, d, k, path):
    assert ops.path_of(dtype, d, k) == path
    assert path in ops.PATHS


def test_hopper_rows_are_limited_by_the_query_tile():
    """A resident 64-row query tile fits up to RESIDENT_D_MAX (1216, the
    widest rows the Hopper scan took before the streamed layout); wider
    rows stream their query chunks, up to HOPPER_D_MAX; past it none."""
    for n_q in (1, 2048):
        assert ops.scan_plan(ops.HOPPER_D_MAX, 1, n_q) is not None
        assert ops.scan_plan(ops.HOPPER_D_MAX, ops.K_MAX, n_q) is not None
    assert ops.scan_plan(ops.HOPPER_D_MAX + 8, 1, 2048) is None
    assert ops.HOPPER_D_MAX % 64 == 0 and ops.HOPPER_D_MAX >= 2560
    assert ops.HOPPER_D_MAX == ops.STREAM_D_MAX == 8192
    assert ops.RESIDENT_D_MAX == 1216
    assert ops.layout_plan(ops.RESIDENT_D_MAX + 64, ops.RESIDENT, ops.K_MAX) is None
    assert ops.scan_plan(ops.RESIDENT_D_MAX, ops.K_MAX, 2048)[0] == ops.RESIDENT
    assert ops.scan_plan(ops.RESIDENT_D_MAX + 64, 1, 2048)[0] == ops.STREAMED


def test_tma_ready_pads_rows_and_aligns_bases():
    t = torch.randn(5, 20).bfloat16()
    r = ops._tma_ready(t)
    assert r.shape == (5, 24) and torch.equal(r[:, :20], t) and not r[:, 20:].any()
    whole = torch.randn(5, 64).bfloat16()
    if whole.data_ptr() % 16 == 0:
        assert ops._tma_ready(whole) is whole
    shifted = torch.randn(5 * 64 + 1).bfloat16()[1:].view(5, 64)   # 2 bytes off
    assert shifted.data_ptr() % 16 != 0
    copy = ops._tma_ready(shifted)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, shifted)


def test_reset_launches_clears_every_path():
    ops.fused_topk.launches = 3
    ops.fused_topk.paths["hopper"] = 3
    ops.reset_launches()
    assert ops.fused_topk.launches == 0
    assert ops.fused_topk.paths == dict.fromkeys(ops.PATHS, 0)


# ---- rows past a resident query tile (the LM retriever's d = 2048) ---------

LM_D = 2048


def _parent_scan_plan(d, k, n_q):
    """The scan plan before the streamed layout: the resident (spread)
    tile, or None where it does not fit."""
    spread = n_q <= ops.BLOCK_Q // 2
    cap = 2 * ops.state_pairs(k)
    for stage_keys in ((cap, 0) if cap <= ops.STAGE_KEYS_MAX else (0,)):
        stages = min(ops.MAX_STAGES,
                     (ops.SMEM_LIMIT - ops.scan_smem_bytes(d, spread, 0, stage_keys))
                     // (ops.CONSUMERS * ops.CHUNK_P))
        if stages >= 2:
            return spread, stages, stage_keys
    return None


@pytest.mark.parametrize("n_q", [1, 32, 33, 64, 256, 2048])
def test_plans_up_to_the_resident_width_are_unchanged(n_q):
    """Every plan the scan had (d up to 1216, each k) is the same tuple, so
    the resident kernel runs every one of them as before."""
    for d in range(8, ops.RESIDENT_D_MAX + 1, 8):
        for k in (1, 20, 100, 128, 129, 256, 257, 1000, 4096):
            before = _parent_scan_plan(d, k, n_q)
            if before is not None:
                assert ops.scan_plan(d, k, n_q) == before, (d, k, n_q)
            else:
                assert d > 1024 and ops.scan_plan(d, k, n_q)[0] == ops.STREAMED


@pytest.mark.parametrize("n_q", [1, 32, 33, 256, 2048])
@pytest.mark.parametrize("k", [1, 20, 100, 1000])
def test_scan_plan_at_the_lm_width(n_q, k):
    """d = 2048: a served batch (at most 32 rows) keeps its spread tile
    where two stages still fit, every other batch streams; each plan fits
    SMEM_LIMIT and takes the Hopper path."""
    layout, stages, stage_keys = ops.scan_plan(LM_D, k, n_q)
    assert ops.scan_smem_bytes(LM_D, layout, stages, stage_keys) <= ops.SMEM_LIMIT
    assert layout == (ops.SPREAD if n_q <= 32 else ops.STREAMED)
    assert stages == (2 if layout == ops.SPREAD else 4)
    assert stage_keys == (256 if k <= 128 else 0)
    assert ops.path_of(torch.bfloat16, LM_D, k) == "hopper"


def test_streamed_plan_is_the_one_the_kernel_states():
    """The streamed layout's plans, byte for byte as the kernel's header
    states them, and its layout codes as the source has them."""
    src = KERNEL_SOURCE.read_text()
    assert ops.scan_plan(LM_D, 100, 2048) == (ops.STREAMED, 4, 256)
    assert ops.scan_plan(LM_D, 129, 2048) == (ops.STREAMED, 3, 512)
    assert ops.scan_plan(LM_D, 1000, 2048) == (ops.STREAMED, 4, 0)
    assert ops.scan_smem_bytes(LM_D, ops.STREAMED, 4, 256) == 222_856
    assert ops.scan_smem_bytes(LM_D, ops.STREAMED, 3, 512) == 190_088
    assert ops.scan_smem_bytes(LM_D, ops.STREAMED, 4, 0) == 206_472
    assert ("k <= 128: 4 stages, 222,856 bytes; k <= 256: 3, 190,088" in src
            and "(pools cut in global memory): 4, 206,472." in src)
    assert re.search(r"constexpr int RESIDENT = 0, SPREAD = 1, STREAMED = 2;", src)
    assert (ops.RESIDENT, ops.SPREAD, ops.STREAMED) == (0, 1, 2)
    # nothing of the streamed plan depends on d
    assert len({ops.scan_plan(d, 100, 2048) for d in range(1280, ops.HOPPER_D_MAX + 1, 64)}) == 1
    assert ops.KERNELS[-1] == "topk_stream_kernel" and "topk_stream_kernel" in ops.BF16_KERNELS
    assert "topk_stream_kernel(" in src


@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("data", ["normal", "integers"])
def test_lm_width_matches_jax(data, dtype, jax_fn):
    """d = 2048 (the LM retriever's reps) with masked columns, through the
    JAX package's fused_topk_scores (the Pallas kernel in interpret mode)
    or its reference, and the port's fused_topk: small integers sum
    exactly, so scores and ids are equal; normal rows scaled by 1/sqrt(d)
    agree to the file's tolerance (ids equal: the top scores of 300 rows
    are far apart)."""
    rng = np.random.default_rng(2048)
    if data == "integers":
        q, p = rng.integers(-2, 3, size=(13, LM_D)), rng.integers(-2, 3, size=(300, LM_D))
    else:
        q, p = rng.normal(size=(13, LM_D)) / 45.0, rng.normal(size=(300, LM_D)) / 45.0
    q, p = q.astype(np.float32), p.astype(np.float32)
    if dtype == "bf16":
        q, p = q.astype(ml_dtypes.bfloat16), p.astype(ml_dtypes.bfloat16)
    valid = rng.random(300) > 0.3
    k = 20
    jv = jnp.asarray(valid)
    if jax_fn == "ref":
        ws, wi = jax_topk_ref(jnp.asarray(q), jnp.asarray(p), k, col_valid=jv)
    else:
        ws, wi = fused_topk_scores(jnp.asarray(q), jnp.asarray(p), k, col_valid=jv,
                                   block_q=8, block_n=32)
    tq, tp = torch.as_tensor(q.astype(np.float32)), torch.as_tensor(p.astype(np.float32))
    if dtype == "bf16":
        tq, tp = tq.bfloat16(), tp.bfloat16()
    s, i = ops.fused_topk(tq, tp, k, col_valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    if data == "integers":
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    else:
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL, atol=ATOL)
