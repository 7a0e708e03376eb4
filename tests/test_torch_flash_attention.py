"""The port's flash attention op (kernels/flash_attention/ops.py) against the
JAX package's, on the same numpy inputs. On the CPU the port's forward is
its plain version (ref.py) and the JAX op runs its Pallas kernel in
interpret mode, as tests/test_kernels.py runs it; both backwards recompute
through their package's chunked attention. The kernel itself is held to
ref.py on the card by tests/test_torch_flash_attention_cuda.py.

Tolerances: fp32 forward, rtol/atol 2e-5 (tests/test_kernels.py's own
kernel-against-reference tolerance: the kernel's online softmax against the
full softmax); bf16 forward, 2e-2 (the same file's: the kernel rounds each
tile's unnormalised probabilities to bf16, the plain version the normalised
ones); gradients, rtol 1e-5 and atol 1e-5 of the largest gradient (the same
chunked recompute on both sides, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    error_ok,
    flash_attention_error,
    flash_attention_ref,
)

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, sq, skv, h, hk, d, masked, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hk, d)).astype(np.float32)
    mask = None
    if masked:
        lengths = rng.integers(1, skv + 1, size=b)
        mask = np.arange(skv)[None, :] < lengths[:, None]
    return q, k, v, mask


@pytest.mark.parametrize(
    "b,sq,skv,h,hk,d,causal,masked,dtype",
    [
        (2, 32, 32, 2, 2, 16, False, True, "float32"),    # BERT-like: padding mask
        (1, 32, 32, 4, 2, 16, True, False, "float32"),    # causal GQA
        (1, 16, 32, 4, 1, 16, True, True, "float32"),     # MQA, Sq != Skv, both masks
        (2, 32, 32, 2, 2, 16, False, True, "bfloat16"),
    ],
)
def test_forward_matches_jax(b, sq, skv, h, hk, d, causal, masked, dtype):
    q, k, v, mask = _inputs(b, sq, skv, h, hk, d, masked, seed=sq + h + hk)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    want = jops.flash_attention(jq, jk, jv, causal=causal, kv_mask=jm, block_q=16, block_k=16)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))
    tm = None if mask is None else torch.as_tensor(mask)
    before = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal, kv_mask=tm, block_q=16, block_k=16)
    assert ops.flash_attention.launches == before          # the CPU path launches nothing
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # and the plain versions of the two packages agree with each other
    np.testing.assert_allclose(
        flash_attention_ref(tq, tk, tv, causal=causal, kv_mask=tm).float().numpy(),
        np.asarray(jax_ref(jq, jk, jv, causal=causal, kv_mask=jm).astype(jnp.float32)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)])
def test_grads_match_jax(causal, masked):
    q, k, v, mask = _inputs(1, 32, 32, 4, 2, 16, masked, seed=3)
    cot = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, causal=causal, kv_mask=jm, block_q=16, block_k=16)
        return jnp.sum(out * cot)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal,
                              kv_mask=None if mask is None else torch.as_tensor(mask),
                              block_q=16, block_k=16)
    (out * torch.as_tensor(cot)).sum().backward()
    for name, t, jg in zip("qkv", leaves, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max(),
                                   err_msg=f"d{name}")


def test_grads_only_for_the_inputs_that_need_them():
    q, k, v, _ = _inputs(1, 16, 16, 2, 2, 16, False, seed=5)
    tq = torch.as_tensor(q).requires_grad_(True)
    out = ops.flash_attention(tq, torch.as_tensor(k), torch.as_tensor(v))
    (dq,) = torch.autograd.grad(out.sum(), [tq])
    assert dq.shape == tq.shape and torch.isfinite(dq).all()


def test_no_mask_is_an_all_true_mask():
    q, k, v, _ = _inputs(2, 16, 16, 2, 2, 16, False, seed=6)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    ones = torch.ones((2, 16), dtype=torch.bool)
    torch.testing.assert_close(ops.flash_attention(tq, tk, tv),
                               ops.flash_attention(tq, tk, tv, kv_mask=ones), rtol=0, atol=0)


@pytest.mark.parametrize(
    "sq,skv,block_q,block_k",
    [(48, 32, 32, 32),      # Sq not a multiple of block_q
     (32, 48, 32, 32)],     # Skv not a multiple of block_k
)
def test_shape_contract_raises_as_in_jax(sq, skv, block_q, block_k):
    q, k, v, _ = _inputs(1, sq, skv, 2, 2, 16, False, seed=7)
    with pytest.raises(AssertionError):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=block_q, block_k=block_k)
    with pytest.raises(ValueError, match="Sq % min"):
        ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            block_q=block_q, block_k=block_k)


def test_bad_shapes_and_masks_raise():
    q = torch.zeros(1, 16, 6, 16)
    kv = torch.zeros(1, 16, 4, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ops.flash_attention(q, kv, kv)
    kv = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="kv_mask must be bool"):
        ops.flash_attention(q, kv, kv, kv_mask=torch.ones(1, 15, dtype=torch.bool))
    with pytest.raises(ValueError, match="need q"):
        ops.flash_attention(q[0], kv, kv)


def _tiled(q, k, v, causal, kv_mask, skip=None, tile=64):
    """The kernel's arithmetic in plain torch: an online softmax over tiles
    of ``tile`` keys, each tile's unnormalised exp(s - m) rounded to v's
    type before its value product, the row sum kept in fp32; the tile
    starting at key ``skip`` is left out (a fault the check must find)."""
    b, sq, h, d = q.shape
    group = h // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.repeat_interleave(group, 2).float()) * d ** -0.5
    if causal:
        s = s.masked_fill(torch.arange(k.shape[1])[None, :] > torch.arange(sq)[:, None], -1e30)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], -1e30)
    vr = v.repeat_interleave(group, 2).float().transpose(1, 2)
    m = torch.full((b, h, sq, 1), -float("inf"))
    row_sum, acc = torch.zeros((b, h, sq, 1)), torch.zeros((b, h, sq, d))
    for c in range(0, k.shape[1], tile):
        if c == skip:
            continue
        m_new = torch.maximum(m, s[..., c : c + tile].amax(-1, keepdim=True))
        p, corr = torch.exp(s[..., c : c + tile] - m_new), torch.exp(m - m_new)
        row_sum = row_sum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vr[:, :, c : c + tile]
        m = m_new
    return (acc / row_sum.clamp_min(1e-30)).to(v.dtype).transpose(1, 2)


@pytest.mark.parametrize(
    "b,s,h,hk,d,causal,masked,dtype,skip,passes",
    [
        (4, 256, 4, 4, 64, False, True, torch.bfloat16, None, True),   # BERT passage pass
        (1, 512, 4, 2, 128, True, False, torch.bfloat16, None, True),  # causal GQA
        (2, 128, 4, 4, 64, False, True, torch.float32, None, True),
        (1, 512, 4, 2, 128, True, False, torch.bfloat16, 384, False),  # a late tile dropped
        (1, 512, 4, 2, 128, True, False, torch.float32, 384, False),
    ],
)
def test_error_check_allows_tile_rounding_and_finds_a_dropped_tile(
        b, s, h, hk, d, causal, masked, dtype, skip, passes):
    """The check the card holds the kernel to (ref.flash_attention_error):
    the kernel's own rounding passes it, a kernel that skips one late key
    tile does not."""
    q, k, v, mask = _inputs(b, s, s, h, hk, d, masked, seed=9)
    q, k, v = (torch.as_tensor(a).to(dtype) for a in (q, k, v))
    mask = None if mask is None else torch.as_tensor(mask)
    out = _tiled(q, k, v, causal, mask, skip=skip)
    err = flash_attention_error(out, q, k, v, causal=causal, kv_mask=mask)
    assert error_ok(err, dtype) == passes, err


@pytest.mark.parametrize("skip,offset,passes", [
    (None, 0, True), (None, 448, True), (384, 448, False),
    (None, None, False),     # the last rows checked as if they were the first
])
def test_error_check_of_some_rows_with_q_offset(skip, offset, passes):
    """The check of a causal pass's first or last rows only (chip_smoke.py's
    S = 32768 case): rows from ``q_offset`` on against every key up to
    them. A dropped late tile fails it, and so do the last rows checked
    without their offset."""
    q, k, v, _ = _inputs(1, 512, 512, 4, 2, 128, False, seed=9)
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    out = _tiled(q, k, v, True, None, skip=skip)
    start = 448 if offset is None else offset
    rows, keys = slice(start, start + 64), slice(0, start + 64)
    err = flash_attention_error(out[:, rows], q[:, rows], k[:, keys], v[:, keys], causal=True,
                                q_offset=offset or 0)
    assert error_ok(err, torch.bfloat16) == passes, err


@pytest.mark.parametrize(
    "b,s,h,hk,d,causal,masked,dtype",
    [
        (4, 256, 4, 4, 64, False, True, torch.bfloat16),
        (1, 512, 4, 2, 128, True, False, torch.bfloat16),
        (1, 512, 4, 4, 80, True, True, torch.bfloat16),
    ],
)
def test_error_check_allows_128_key_tiles(b, s, h, hk, d, causal, masked, dtype):
    """The kernel's tiles of 128 keys (BK = 128) round each tile's
    probabilities as the 64-key tiles do: the card's check passes them."""
    q, k, v, mask = _inputs(b, s, s, h, hk, d, masked, seed=10)
    q, k, v = (torch.as_tensor(a).to(dtype) for a in (q, k, v))
    mask = None if mask is None else torch.as_tensor(mask)
    err = flash_attention_error(_tiled(q, k, v, causal, mask, tile=128), q, k, v,
                                causal=causal, kv_mask=mask)
    assert error_ok(err, dtype), err


# the shapes the port runs or times the kernel at: the BERT query and passage
# passes (B=8, H=12, D=64), an index encode batch, internlm2-1.8b and
# stablelm-3b prefill, the LM retriever's passes (B=8, H=16)
PLAN_SHAPES = [(8, 32, 32, 12), (8, 256, 256, 12), (256, 256, 256, 12), (1, 4096, 4096, 16),
               (1, 2048, 2048, 32), (1, 1, 1, 1), (64, 512, 512, 16), (8, 32, 32, 16),
               (8, 256, 256, 16)]
#: an H100 SXM: its SMs and each SM's shared memory
H100 = {"sms": 132, "sm_smem": 233_472}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", list(ops.HEAD_DIMS))
def test_tile_plan_is_legal_and_fits_shared_memory(d, dtype):
    """Every head dim, both dtypes, at the port's shapes: the plan is a tile
    shape the kernel has (bf16: BQ, BK in {64, 128}; fp32: 64 x 64) and one
    block's shared memory is within the 227 KB a block may use."""
    for b, sq, skv, h in PLAN_SHAPES:
        bq, bk = ops.tile_plan(b, sq, skv, h, d, dtype, **H100)
        if dtype == torch.float32:
            assert (bq, bk) == (64, 64)
        else:
            assert bq in (64, 128) and bk in (64, 128)
        assert 0 < ops.smem_bytes_mirror(bq, bk, d, dtype) <= ops.SMEM_LIMIT
    if dtype == torch.bfloat16:
        for bq in (64, 128):
            for bk in (64, 128):
                assert ops.smem_bytes_mirror(bq, bk, d, dtype) <= ops.SMEM_LIMIT


@pytest.mark.parametrize(
    "b,sq,skv,h,d,want",
    [(8, 32, 32, 12, 64, (64, 64)),            # BERT query pass: 96 blocks of 64 rows
     (8, 256, 256, 12, 64, (64, 128)),         # BERT passage pass
     (32, 32, 32, 12, 64, (64, 64)),           # a served batch of queries
     (256, 256, 256, 12, 64, (64, 64)),        # an index encode batch: 12288 blocks
     (1, 4096, 4096, 16, 128, (128, 128)),     # internlm2-1.8b prefill
     (1, 2048, 2048, 32, 80, (128, 128)),      # stablelm-3b prefill
     (1, 2048, 2048, 16, 128, (128, 128)),     # 256 blocks of 128 rows, one 64-row block a SM
     (8, 32, 32, 16, 128, (64, 64)),           # LM retriever query pass (internlm2-1.8b), causal
     (8, 256, 256, 16, 128, (128, 64))],       # LM retriever passage pass, causal
)
def test_tile_plan_at_the_timed_shapes(b, sq, skv, h, d, want):
    """The plan kernels/flash_attention/bench.py timed fastest at each of
    these shapes on an H100 (PERF.md), causal where the shape's callers are
    (the LM shapes)."""
    assert ops.tile_plan(b, sq, skv, h, d, torch.bfloat16, **H100, causal=d != 64) == want


def test_tile_plan_follows_the_card():
    """The plan reads the card it is given: the BERT passage pass's 384
    blocks of 64 rows fill half the SMs' two slots more than twice over
    (64 x 64), and where a SM holds one 64 x 128 block only, its 192 blocks
    of 128 rows fill the SMs (128 x 128)."""
    passage = (8, 256, 256, 12, 64, torch.bfloat16)
    assert ops.tile_plan(*passage, **H100) == (64, 128)
    assert ops.tile_plan(*passage, sms=66, sm_smem=H100["sm_smem"]) == (64, 64)
    assert ops.tile_plan(*passage, sms=132, sm_smem=100_000) == (128, 128)


def test_plan_is_computed_once_a_shape(monkeypatch):
    """The launch's plan (ops._plan) is tile_plan with the card's SMs and
    their shared memory and the library's shared memory a block, asked once
    for each shape and card and then cached."""
    import types

    asked, cards = [], []

    def library_smem(bq, bk, d, dtype):
        asked.append((bq, bk, d))
        return ops.smem_bytes_mirror(bq, bk, d, dtype)

    def properties(device):
        cards.append(device)
        return types.SimpleNamespace(multi_processor_count=H100["sms"],
                                     shared_memory_per_multiprocessor=H100["sm_smem"])

    monkeypatch.setattr(ops, "_library_smem_bytes", library_smem)
    monkeypatch.setattr(ops.torch.cuda, "get_device_properties", properties)
    ops._plan.cache_clear()
    try:
        for _ in range(3):
            for shape in ((8, 256, 256, 12, 64), (1, 2048, 2048, 32, 80)):
                assert ops._plan(*shape, torch.bfloat16, 0) == ops.tile_plan(
                    *shape, torch.bfloat16, **H100)
        assert asked == [(64, 128, 64), (64, 128, 80)] and cards == [0, 0]
    finally:
        ops._plan.cache_clear()


@pytest.mark.parametrize("sq", [1, 32, 64])
@pytest.mark.parametrize("b", [8, 32, 256])
def test_tile_plan_keeps_one_warpgroup_for_short_queries(b, sq):
    """At most 64 query rows: one consumer warpgroup (BQ = 64) however many
    blocks there are, since a second one would have no row to compute."""
    for d in ops.HEAD_DIMS:
        assert ops.tile_plan(b, sq, 512, 12, d, torch.bfloat16, **H100)[0] == 64


def _view(base: torch.Tensor, offset: int, shape, strides):
    return base.as_strided(shape, strides, storage_offset=offset)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "offset,strides,aligned",
    [
        (0, (8192, 512, 64, 1), True),     # contiguous (2, 16, 8, 64)
        (0, (24576, 1536, 64, 1), True),   # a head split of one fused qkv projection
        (64, (24576, 1536, 64, 1), True),  # the k split: 64 elements in
        (1, (8192, 512, 64, 1), False),    # base off by one element
        (0, (8192, 513, 64, 1), False),    # row stride not a 16-byte multiple
        (0, (8200, 512, 64, 1), True),     # batch stride 8200 elements: 16 bytes in either type
        (0, (8196, 512, 64, 1), None),     # batch stride 8196: 16 bytes in fp32 only
        (0, (8192, 512, 65, 1), False),    # head stride not a 16-byte multiple
        (0, (8192, 512, 1, 8), False),     # last dim not contiguous
    ],
)
def test_alignment_helper_copies_exactly_the_misaligned(offset, strides, aligned, dtype):
    """_tma_ready keeps a tensor whose base and batch, row and head strides
    are 16-byte multiples (and whose last dim is contiguous), and copies any
    other to a new contiguous tensor of the same values."""
    if aligned is None:
        aligned = dtype == torch.float32
    base = torch.arange(2 * 24576 + 1024, dtype=torch.float32).to(dtype)
    t = _view(base, offset, (2, 16, 8, 64), strides)
    assert (base.data_ptr() % 64) == 0
    got = ops._tma_ready(t)
    if aligned:
        assert got is t
    else:
        assert got is not t and got.is_contiguous() and got.data_ptr() % 16 == 0
        assert got.data_ptr() != t.data_ptr() and torch.equal(got, t)


@pytest.mark.parametrize("edit", ["kernel", "header", "new_header"])
def test_library_path_follows_every_file_under_csrc(tmp_path, monkeypatch, edit):
    """The built library's name hashes every file under the kernel's csrc/,
    so editing a header it includes rebuilds it too."""
    import shutil

    from repro_torch.kernels import _build

    root = tmp_path / "repro_torch"
    shutil.copytree(_build.PACKAGE_ROOT / "kernels" / "flash_attention" / "csrc",
                    root / "kernels" / "flash_attention" / "csrc")
    monkeypatch.setattr(_build, "PACKAGE_ROOT", root)
    csrc = root / "kernels" / "flash_attention" / "csrc"
    before = _build.library_path("flash_attention")
    assert before == _build.library_path("flash_attention")
    target = {"kernel": csrc / "flash_attention.cu", "header": csrc / "hopper.cuh",
              "new_header": csrc / "extra.cuh"}[edit]
    target.write_text((target.read_text() if target.exists() else "") + "\n// edited\n")
    assert _build.library_path("flash_attention") != before
