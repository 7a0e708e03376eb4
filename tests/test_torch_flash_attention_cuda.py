"""The hand-written CUDA flash attention kernel against its plain version
(ref.py), on the card. Marked ``cuda``: without a GPU (and nvcc) every test
here skips. Imports no JAX.

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention_cuda.py

Tolerances, on the output, as ref.flash_attention_error states them:
  * fp32: each element within 1e-5 of the largest |v| of ref.py's (the same
    fp32 products and exponentials, summed in another order);
  * bf16: each element within 2^-7 (a + |o|) + 2^-12 a of ref.py's, where
    a = sum_j p_j |v_j| and o is the exact output: both sides round their
    probabilities to bf16 before the value product (the kernel each tile's
    unnormalised exp(s - m), the plain version the normalised softmax: at
    most 2^-8 a each) and their output to bf16 (2^-8 |o| each); and a mean
    error from the exact attention at most 1.25 times ref.py's own (the
    same kinds of rounding, so about equal; a dropped or misweighted tile of
    late keys shows here even where it stays within the per-element
    allowance);
  * gradients (the backward recomputes through chunked_attention, not the
    kernel): 1e-4 of the largest |reference gradient|, fp32 (order only).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    bf16_allowance,
    error_ok,
    flash_attention_error,
    flash_attention_ref,
)

GRAD_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _qkv(b, sq, skv, h, hk, d, dtype, dev, seed=0):
    return (_rand((b, sq, h, d), dtype, dev, seed), _rand((b, skv, hk, d), dtype, dev, seed + 1),
            _rand((b, skv, hk, d), dtype, dev, seed + 2))


def _ragged_mask(b, skv, dev, seed=5):
    """Each row keeps a random-length prefix (at least one key), as padded
    token batches do."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, skv + 1, (b,), generator=g, device=dev)
    return torch.arange(skv, device=dev)[None, :] < lengths[:, None]


def _check(q, k, v, causal=False, kv_mask=None, tiles=None):
    """The kernel's output (through the op, or at the given (BQ, BK) tiles)
    held against ref.py."""
    before = ops.flash_attention.launches
    with torch.no_grad():
        if tiles is None:
            out = ops.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask)
        else:
            out = ops._launch(q, k, v, kv_mask, causal, q.shape[-1] ** -0.5, tiles=tiles)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape and out.is_contiguous()
    assert torch.isfinite(out.float()).all()
    err = flash_attention_error(out, q, k, v, causal=causal, kv_mask=kv_mask)
    assert error_ok(err, q.dtype), err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 256])
def test_bert_passes_with_ragged_mask(dev, s):
    q, k, v = _qkv(8, s, s, 12, 12, 64, torch.bfloat16, dev)
    _check(q, k, v, kv_mask=_ragged_mask(8, s, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_head_dims_causal_gqa(dev, d, dtype):
    q, k, v = _qkv(2, 200, 200, 8, 2, d, dtype, dev, seed=d)      # ragged tile edges
    _check(q, k, v, causal=True)
    _check(q, k, v, kv_mask=_ragged_mask(2, 200, dev))


@pytest.mark.cuda
def test_lm_prefill_shapes(dev):
    _check(*_qkv(1, 1024, 1024, 16, 8, 128, torch.bfloat16, dev), causal=True)
    _check(*_qkv(1, 512, 512, 32, 32, 80, torch.bfloat16, dev), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strided_views_of_one_fused_projection(dev, dtype):
    """q, k, v as the split heads of one (B, S, 3 * H * D) projection, read
    through their strides; a view whose last dim is strided is copied."""
    b, s, h, d = 4, 96, 6, 64
    qkv = _rand((b, s, 3 * h * d), dtype, dev, 11)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    out = _check(q, k, v, kv_mask=_ragged_mask(b, s, dev))
    dense = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                kv_mask=_ragged_mask(b, s, dev))
    assert torch.equal(out, dense)
    t = _rand((b, s, d, h), dtype, dev, 12).transpose(2, 3)        # last-dim stride h
    _check(t, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_false_mask_row_averages_every_value(dev, dtype):
    q, k, v = _qkv(3, 64, 128, 4, 4, 64, dtype, dev)
    mask = _ragged_mask(3, 128, dev)
    mask[1] = False
    out = _check(q, k, v, kv_mask=mask)[1].float()
    vf = v[1].float()
    want = vf.mean(0, keepdim=True).expand(64, 4, 64)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * vf.abs().max().item())
    else:                                   # every probability 1 / Skv
        assert ((out - want).abs() <= bf16_allowance(vf.abs().mean(0), want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_no_mask_is_an_all_true_mask(dev, causal):
    """kv_mask=None reaches the kernel as a null mask, read as every key
    visible: bit-equal to an all-True mask."""
    q, k, v = _qkv(2, 128, 128, 8, 4, 64, torch.bfloat16, dev)
    ones = torch.ones((2, 128), dtype=torch.bool, device=dev)
    assert torch.equal(_check(q, k, v, causal=causal),
                       ops.flash_attention(q, k, v, causal=causal, kv_mask=ones))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_query_and_key_lengths_differ(dev, causal):
    q, k, v = _qkv(2, 64, 192, 8, 4, 64, torch.bfloat16, dev)
    _check(q, k, v, causal=causal, kv_mask=_ragged_mask(2, 192, dev))
    q, k, v = _qkv(2, 256, 64, 8, 4, 64, torch.bfloat16, dev)
    _check(q, k, v, causal=causal)


@pytest.mark.cuda
def test_autograd_matches_plain_autograd(dev):
    q, k, v = _qkv(2, 128, 128, 8, 2, 64, torch.float32, dev)
    mask = _ragged_mask(2, 128, dev)
    cot = _rand((2, 128, 8, 64), torch.float32, dev, 21)
    grads = []
    for fn in (lambda *a: ops.flash_attention(*a, causal=True, kv_mask=mask, block_q=64, block_k=64),
               lambda *a: flash_attention_ref(*a, causal=True, kv_mask=mask)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want, name in zip(*grads, "qkv"):
        err = (got - want).abs().max().item()
        tol = GRAD_RTOL * want.abs().max().item()
        assert err <= tol, f"d{name}: max abs err {err} > {tol}"


@pytest.mark.cuda
def test_raises_on_what_the_kernel_does_not_take(dev):
    q, k, v = _qkv(1, 64, 64, 4, 4, 72, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 64, 64, 4, 4, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        ops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="Sq % min"):
        ops.flash_attention(*_qkv(1, 300, 300, 4, 4, 64, torch.bfloat16, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("d", list(ops.HEAD_DIMS))
def test_every_head_dim_bf16(dev, d):
    """Each D, including those TMA zero-fills to a 64-column chunk (16 to 48,
    80 to 112), causal and with a ragged key mask."""
    q, k, v = _qkv(2, 160, 160, 4, 2, d, torch.bfloat16, dev, seed=d + 1)
    _check(q, k, v, causal=True)
    _check(q, k, v, kv_mask=_ragged_mask(2, 160, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [1, 37, 97, 200, 321])
def test_keys_not_a_multiple_of_either_tile(dev, skv):
    q, k, v = _qkv(2, 64, skv, 4, 4, 64, torch.bfloat16, dev, seed=skv)
    _check(q, k, v)
    _check(q, k, v, kv_mask=_ragged_mask(2, skv, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 32, 64, 128, 256])
def test_query_rows_below_and_at_the_tile(dev, sq):
    q, k, v = _qkv(2, sq, 192, 4, 2, 64, torch.bfloat16, dev, seed=sq)
    _check(q, k, v, kv_mask=_ragged_mask(2, 192, dev))
    _check(q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(100, 300), (512, 97), (1, 129), (129, 1)])
def test_causal_with_other_query_and_key_lengths(dev, sq, skv):
    q, k, v = _qkv(2, sq, skv, 4, 2, 64, torch.bfloat16, dev, seed=sq + skv)
    _check(q, k, v, causal=True)
    _check(q, k, v, causal=True, kv_mask=_ragged_mask(2, skv, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_gqa_groups(dev, group):
    q, k, v = _qkv(2, 192, 192, 8, 8 // group, 128, torch.bfloat16, dev, seed=group)
    _check(q, k, v, causal=True)
    _check(q, k, v, kv_mask=_ragged_mask(2, 192, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_each_tile_plan(dev, tiles, d):
    """Every (BQ, BK) the plan may pick, on ragged query and key lengths,
    causal, GQA, and a key mask."""
    q, k, v = _qkv(2, 333, 333, 8, 2, d, torch.bfloat16, dev, seed=tiles[0] + tiles[1] + d)
    _check(q, k, v, causal=True, tiles=tiles)
    _check(q, k, v, kv_mask=_ragged_mask(2, 333, dev), tiles=tiles)
    mask = _ragged_mask(2, 333, dev)
    mask[0, :200] = False                       # rows before key 200 see no key
    _check(q, k, v, causal=True, kv_mask=mask, tiles=tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_misaligned_inputs_are_copied(dev, dtype):
    """Strides or a base off TMA's 16-byte rule: the op copies the tensor
    first and the result is bit-equal to that of a contiguous copy."""
    b, s, h, d = 2, 96, 4, 64
    wide = _rand((b, s, h * d + 1), dtype, dev, 31)                  # row stride h*d + 1
    q = wide[..., : h * d].unflatten(-1, (h, d))
    flat = _rand((b * s * h * d + 1,), dtype, dev, 32)
    k = flat[1:].view(b, s, h, d)                                    # base 1 element off
    v = _rand((b, s, h, d), dtype, dev, 33)
    assert ops._tma_ready(q) is not q and ops._tma_ready(k) is not k and ops._tma_ready(v) is v
    mask = _ragged_mask(b, s, dev)
    out = _check(q, k, v, kv_mask=mask)
    dense = ops.flash_attention(q.contiguous(), k.clone(), v, kv_mask=mask)
    assert torch.equal(out, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(64, 64), (128, 128)])
def test_all_masked_row_under_causal(dev, tiles):
    """A batch row whose keys are all masked averages every value in every
    row, causal or not (no KV tile may be skipped there)."""
    q, k, v = _qkv(2, 256, 256, 4, 4, 64, torch.bfloat16, dev, seed=41)
    mask = _ragged_mask(2, 256, dev)
    mask[1] = False
    out = _check(q, k, v, causal=True, kv_mask=mask, tiles=tiles)[1].float()
    vf = v[1].float()
    want = vf.mean(0, keepdim=True).expand(256, 4, 64)
    assert ((out - want).abs() <= bf16_allowance(vf.abs().mean(0), want)).all()


@pytest.mark.cuda
def test_smem_bytes_mirror_the_kernel(dev):
    """ops.smem_bytes_mirror (which the CPU tests hold to the 227 KB limit)
    is what the library reports, and the kernel asks for, under every plan,
    head dim and dtype; so the card's plan is the CPU tests' plan."""
    lib, card = ops._library(), torch.cuda.current_device()
    props = torch.cuda.get_device_properties(card)
    for d in ops.HEAD_DIMS:
        assert lib.flash_attention_smem_bytes(0, 64, 64, d) == ops.smem_bytes_mirror(
            64, 64, d, torch.float32)
        for bq in (64, 128):
            for bk in (64, 128):
                assert lib.flash_attention_smem_bytes(1, bq, bk, d) == ops.smem_bytes_mirror(
                    bq, bk, d, torch.bfloat16)
        for shape in ((8, 32, 32, 12), (8, 256, 256, 12), (1, 4096, 4096, 16), (1, 2048, 2048, 32)):
            for dtype in (torch.bfloat16, torch.float32):
                assert ops._plan(*shape, d, dtype, card) == ops.tile_plan(
                    *shape, d, dtype, sms=props.multi_processor_count,
                    sm_smem=props.shared_memory_per_multiprocessor)
    assert lib.flash_attention_smem_bytes(1, 96, 64, 64) == 0


@pytest.mark.cuda
def test_no_bf16_kernel_uses_local_memory(dev):
    """Every bf16 instantiation runs from registers and shared memory: the
    card reports no local memory (no spill, no stack frame) for any plan and
    head dim; fp32 and unknown plans are told apart."""
    for bq in (64, 128):
        for bk in (64, 128):
            for d in ops.HEAD_DIMS:
                attrs = ops.kernel_attributes(bq, bk, d, torch.bfloat16)
                assert attrs["local_bytes"] == 0 and 0 < attrs["registers"] <= 255, (bq, bk, d)
    assert ops.kernel_attributes(64, 64, 64, torch.float32)["registers"] > 0
    with pytest.raises(RuntimeError):
        ops.kernel_attributes(96, 64, 64, torch.bfloat16)
