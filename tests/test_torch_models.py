"""The port's BERT towers against the JAX package's, on the same tokens and
the same (carried-across) params, with each attention path
(``attention_impl`` "plain", "chunked" and "pallas": the flash kernel, whose
plain version runs on the CPU while the JAX package runs its Pallas kernel
in interpret mode).

Tolerances: fp32 within rtol/atol 1e-5 (the same arithmetic in another
summation order), for [CLS] reps and for parameter gradients (atol 1e-5 of
the gradient's largest entry). bf16 compute: both packages round activations to bf16
after every matmul but at different places inside fused ops and with
different accumulation orders, so [CLS] reps (|x| up to ~3 after LayerNorm,
where one bf16 ulp is 1/64) agree to a few ulps: atol 0.05 (twice the
largest difference seen over seeds, 0.023) and a mean error below 0.01
(seen: 0.005).
"""

import dataclasses

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
from repro_torch.models import bert as tbert
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


@pytest.mark.parametrize(
    "impl,precision,masked",
    [("chunked", "fp32", True), ("pallas", "fp32", True), ("chunked", "bf16", True),
     ("pallas", "bf16", True),
     # no mask: the JAX towers attend under an all-True one, the port passes
     # None on ("chunked" then takes the custom-backward path)
     ("chunked", "fp32", False), ("pallas", "fp32", False)],
)
def test_bert_attention_impl_matches_jax(impl, precision, masked):
    """[CLS] reps under ragged masks (or none) and, in fp32, every parameter
    gradient of the query tower, with the chunked or the flash attention
    path."""
    tokens, mask = _tokens(seed=5)
    w = np.random.default_rng(6).normal(size=(4, 64)).astype(np.float32)
    jenc = jax_dual_encoder(dataclasses.replace(jax_tiny_bert(), attention_impl=impl),
                            precision=precision)
    jparams = jenc.init(jax.random.PRNGKey(7))
    jbatch = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)} if masked else jnp.asarray(tokens)

    def jloss(p):
        reps = jenc.encode_query(p, jbatch).astype(jnp.float32)
        return jnp.sum(reps * w), reps

    tenc = make_bert_dual_encoder(dataclasses.replace(tiny_bert(), attention_impl=impl),
                                  precision=precision)
    tparams = params_to_torch(jax.device_get(jparams), "cpu")
    tbatch = torch.as_tensor(tokens).long()
    if masked:
        tbatch = {"tokens": tbatch, "mask": torch.as_tensor(mask)}
    if precision == "bf16":
        want = np.asarray(jloss(jparams)[1])
        with torch.inference_mode():
            got = tenc.encode_query(tparams, tbatch).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
        assert np.abs(got - want).mean() < 0.01
        return
    jgrads, want = jax.grad(jloss, has_aux=True)(jparams)
    leaves = tparams["query"]
    for group in leaves.values():
        for t in group.values():
            t.requires_grad_(True)
    reps = tenc.encode_query(tparams, tbatch)
    (reps * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(reps.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jq = jax.device_get(jgrads["query"])
    for group, ts in leaves.items():
        for name, t in ts.items():
            jg = np.asarray(jq[group][name])
            np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(jg).max(), 1e-30),
                                       err_msg=f"{group}/{name}")


@pytest.mark.parametrize("impl", ["plain", "pallas"])
def test_remat_other_than_none_checkpoints_every_layer(impl, monkeypatch):
    """Any remat value but "none" runs each layer under the checkpoint (as
    the JAX package applies jax.checkpoint for any such value); values and
    gradients stay those of "none"."""
    tokens, mask = _tokens(seed=8)
    batch = {"tokens": torch.as_tensor(tokens).long(), "mask": torch.as_tensor(mask)}
    calls = []
    real = tbert.checkpoint
    monkeypatch.setattr(tbert, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = {}
    for remat in ("none", "dots", "full"):
        calls.clear()
        enc = make_bert_dual_encoder(
            dataclasses.replace(tiny_bert(), attention_impl=impl, remat=remat))
        params = enc.init(torch.Generator().manual_seed(9), "cpu")
        w = params["passage"]["layers"]["wqkv"].requires_grad_(True)
        reps = enc.encode_passage(params, batch)
        reps.square().sum().backward()
        assert len(calls) == (0 if remat == "none" else tiny_bert().n_layers), remat
        out[remat] = (reps.detach(), w.grad)
    for remat in ("dots", "full"):
        torch.testing.assert_close(out[remat][0], out["none"][0], rtol=0, atol=0)
        torch.testing.assert_close(out[remat][1], out["none"][1], rtol=1e-6, atol=1e-7)
