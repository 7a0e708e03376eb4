"""The port's attention module (models/attention.py) against the JAX
package's, on the same numpy inputs: plain (causal, GQA, q_offset,
kv_mask), chunked with its log-sum-exp, the flash-chunked custom backward
(values and gradients, on the cases of tests/test_flash_bwd.py), decode and
the dispatcher.

Tolerances: fp32, rtol 1e-5 and atol 1e-5 on values and log-sum-exps (the
same arithmetic in another summation order; outputs and inputs are O(1)).
Gradients of the flash-chunked backward: rtol 1e-5, atol 1e-5 of the
gradient's largest entry. bf16 (the one bf16 case): both sides keep fp32
internals and round dq, dk, dv once to bf16, so they agree to one bf16 ulp
of the largest gradient (2^-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

RTOL = ATOL = 1e-5


def _arrays(b, sq, skv, h, hk, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32) * scale
    k = rng.normal(size=(b, skv, hk, d)).astype(np.float32) * scale
    v = rng.normal(size=(b, skv, hk, d)).astype(np.float32) * scale
    return q, k, v


def _mask(b, skv, seed=1):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, skv)) > 0.3
    mask[:, 0] = True
    return mask


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0), (True, 5)])
@pytest.mark.parametrize("hk", [4, 2, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_matches_jax(causal, q_offset, hk, masked):
    q, k, v = _arrays(2, 7, 12, 4, hk, 8)
    mask = _mask(2, 12) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = jattn.plain_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                                 kv_mask=None if mask is None else jnp.asarray(mask))
    got = tattn.plain_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                                kv_mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hk,masked", [(4, False), (2, True), (1, True)])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 16), (32, 8), (64, 64)])
def test_chunked_attention_with_lse_matches_jax(causal, hk, masked, q_chunk, kv_chunk):
    q, k, v = _arrays(2, 32, 32, 4, hk, 16, seed=2)
    mask = _mask(2, 32, seed=3) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, return_lse=True)
    want, want_lse = jattn.chunked_attention(
        jq, jk, jv, kv_mask=None if mask is None else jnp.asarray(mask), **kw)
    got, got_lse = tattn.chunked_attention(
        tq, tk, tv, kv_mask=None if mask is None else torch.as_tensor(mask), **kw)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, 32, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=RTOL, atol=ATOL)


def test_chunked_attention_refuses_uneven_chunks():
    q, k, v = (torch.zeros(1, 24, 2, 8) for _ in range(3))
    with pytest.raises(ValueError, match="multiples of their chunks"):
        tattn.chunked_attention(q, k, v, q_chunk=16, kv_chunk=8)


def _flash_value_and_grads(fn, q, k, v, cot):
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*leaves)
    (out.float() * torch.as_tensor(cot)).sum().backward()
    return out.detach().float().numpy(), [t.grad for t in leaves]


# the cases of tests/test_flash_bwd.py: causal or not, MHA and GQA, two
# chunkings; then the rectangular n_rep=8 case with uneven chunks
FLASH_CASES = [
    (2, 32, 32, h, hk, 16, causal, qc, kc)
    for causal in (False, True)
    for hk, h in ((4, 4), (2, 8))
    for qc, kc in ((8, 16), (32, 32))
] + [(1, 16, 64, 8, 1, 8, False, 8, 16)]


@pytest.mark.parametrize("b,sq,skv,h,hk,d,causal,q_chunk,kv_chunk", FLASH_CASES)
def test_flash_chunked_values_and_grads_match_jax(b, sq, skv, h, hk, d, causal, q_chunk, kv_chunk):
    q, k, v = _arrays(b, sq, skv, h, hk, d, seed=4, scale=0.4)
    cot = np.random.default_rng(5).normal(size=(b, sq, h, d)).astype(np.float32)
    (jq, jk, jv), _ = _both(q, k, v)

    def jloss(q_, k_, v_):
        o = jattn.flash_chunked_attention(q_, k_, v_, causal, None, q_chunk, kv_chunk)
        return jnp.sum(o * cot), o

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    got, tgrads = _flash_value_and_grads(
        lambda *t: tattn.flash_chunked_attention(*t, causal, None, q_chunk, kv_chunk), q, k, v, cot)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for name, g, jg in zip("qkv", tgrads, jgrads):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), jg, rtol=RTOL, atol=ATOL * np.abs(jg).max(),
                                   err_msg=f"d{name}")


def test_flash_chunked_bf16_grads_match_jax():
    q, k, v = _arrays(2, 64, 64, 4, 2, 16, seed=6)
    cot = np.random.default_rng(7).normal(size=(2, 64, 4, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    # the bf16 inputs, exactly, for the port
    q, k, v = (np.array(a.astype(jnp.float32)) for a in (jq, jk, jv))

    def jloss(q_, k_, v_):
        return jnp.sum(jattn.flash_chunked_attention(q_, k_, v_, True, None, 16, 32)
                       .astype(jnp.float32) * cot)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.as_tensor(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_chunked_attention(*leaves, True, None, 16, 32)
    (out.float() * torch.as_tensor(cot)).sum().backward()
    for name, t, jg in zip("qkv", leaves, jgrads):
        assert t.grad.dtype == torch.bfloat16
        jg = np.asarray(jg.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), jg, rtol=0,
                                   atol=2.0 ** -7 * np.abs(jg).max(), err_msg=f"d{name}")


@pytest.mark.parametrize("cache_len", [np.asarray([5, 16, 1]), 9])
def test_decode_attention_matches_jax(cache_len):
    q, _, _ = _arrays(3, 1, 1, 8, 2, 16, seed=8)
    _, k, v = _arrays(3, 1, 16, 8, 2, 16, seed=9)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = jattn.decode_attention(jq, jk, jv, cache_len=jnp.asarray(cache_len))
    got = tattn.decode_attention(tq, tk, tv, cache_len=torch.as_tensor(cache_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["plain", "chunked", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_dispatch_matches_jax(impl, masked):
    q, k, v = _arrays(2, 16, 16, 4, 2, 16, seed=10)
    mask = _mask(2, 16, seed=11) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(impl=impl, causal=True, q_chunk=8, kv_chunk=8)
    want = jattn.attention(jq, jk, jv, kv_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = tattn.attention(tq, tk, tv, kv_mask=None if mask is None else torch.as_tensor(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_chunked_dispatch_takes_the_custom_backward_only_without_a_mask():
    q, k, v = (torch.randn(1, 8, 2, 8, requires_grad=True) for _ in range(3))
    out = tattn.attention(q, k, v, impl="chunked")
    assert type(out.grad_fn).__name__ == "_FlashChunkedAttentionBackward"
    out = tattn.attention(q, k, v, impl="chunked", kv_mask=torch.ones(1, 8, dtype=torch.bool))
    assert type(out.grad_fn).__name__ != "_FlashChunkedAttentionBackward"
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="nope")
