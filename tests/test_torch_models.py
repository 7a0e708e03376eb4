"""The port's BERT towers against the JAX package's, on the same tokens and
the same (carried-across) params.

Tolerances: fp32 within rtol/atol 1e-5 (the same arithmetic in another
summation order). bf16 compute: both packages round activations to bf16
after every matmul but at different places inside fused ops and with
different accumulation orders, so [CLS] reps (|x| up to ~3 after LayerNorm,
where one bf16 ulp is 1/64) agree to a few ulps: atol 0.05 (twice the
largest difference seen over seeds, 0.023) and a mean error below 0.01
(seen: 0.005).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro_torch.compat import params_to_torch
from repro_torch.launch.serve import tiny_bert
from repro_torch.models import layers
from repro_torch.models.attention import plain_attention
from repro_torch.models.towers import make_bert_dual_encoder


def _tokens(b=4, s=12, vocab=1000, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(10, vocab, size=(b, s)).astype(np.int32)
    tokens[:, 0] = 1
    lengths = rng.integers(3, s + 1, size=b)
    mask = np.arange(s)[None, :] < lengths[:, None]
    tokens[~mask] = 0
    return tokens, mask


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tower", ["query", "passage"])
def test_bert_cls_reps_match_jax(precision, masked, tower):
    tokens, mask = _tokens()
    jenc = jax_dual_encoder(jax_tiny_bert(), precision=precision)
    jparams = jenc.init(jax.random.PRNGKey(1))
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask) if masked else None}
    jfn = jenc.encode_query if tower == "query" else jenc.encode_passage
    want = np.asarray(jfn(jparams, jbatch).astype(jnp.float32))

    tenc = make_bert_dual_encoder(tiny_bert(), precision=precision)
    tparams = params_to_torch(jax.device_get(jparams), "cpu")
    tbatch = {"tokens": torch.as_tensor(tokens).long(),
              "mask": torch.as_tensor(mask) if masked else None}
    tfn = tenc.encode_query if tower == "query" else tenc.encode_passage
    with torch.inference_mode():
        got = tfn(tparams, tbatch)
    assert got.dtype == (torch.float32 if precision == "fp32" else torch.bfloat16)
    got = got.float().numpy()
    assert got.shape == want.shape == (4, 64)
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
        assert np.abs(got - want).mean() < 0.01


def test_unmasked_padding_attends_like_jax():
    """With no mask every position attends, padding included: the reps of a
    padded batch differ from the masked ones in both packages alike."""
    tokens, mask = _tokens(seed=2)
    tenc = make_bert_dual_encoder(tiny_bert())
    params = tenc.init(torch.Generator().manual_seed(0), "cpu")
    t = torch.as_tensor(tokens).long()
    with torch.inference_mode():
        a = tenc.encode_query(params, t)
        b = tenc.encode_query(params, {"tokens": t, "mask": torch.as_tensor(mask)})
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = layers.layer_norm(torch.as_tensor(scale), torch.as_tensor(bias), tx).float().numpy()
    want = np.asarray(jax_layers.layer_norm(jnp.asarray(scale), jnp.asarray(bias), jx).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    got = layers.gelu(tx).float().numpy()
    want = np.asarray(jax_layers.gelu(jx).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_plain_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 7, 3, 8)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, 7)) > 0.3
    mask[:, 0] = True
    got = plain_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          kv_mask=torch.as_tensor(mask)).numpy()
    want = np.asarray(jax_attention.plain_attention(
        *(jnp.asarray(a) for a in (q, k, v)), kv_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
