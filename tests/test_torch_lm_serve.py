"""The port's LM serving (models/lm.py's ``KVCache``, ``prefill`` and
``decode_step``, launch/steps.py's ``_lm_prefill_program`` and
``_lm_decode_program``) against the JAX package's, on the same numpy inputs
and the same (carried-across) params, on tests/test_torch_lm.py's tiny LM.

Tolerances: fp32 within rtol/atol 1e-5 (the same arithmetic in another
summation order) for the cache's k and v and the logits, with each prefill
attention path ("chunked", and "pallas": the flash op, whose plain version
runs on the CPU while the JAX package runs its Pallas kernel in interpret
mode); ``length`` exactly. Teacher forcing in the port holds prefill and
decode logits to the full forward's at tests/test_models.py's tolerances
(rtol 2e-4, atol 2e-5) in fp32. In bf16 with chunked attention the two
routes round different tensors (the decode's attention is one query
against the cache, the forward's an online softmax over key blocks), and
their logits (unit spread, up to |4.5|) differ by bf16 ulps of the hidden
states: over 6 seeds up to 0.047, and 0.0062 on average; the flash op's
plain version (its CPU path) does the decode attention's arithmetic, and
the two agree exactly. Held at atol 0.1 and a mean below 0.02 (the mean is
the limit chip_smoke.py's lm_serve phase holds the full-size model to).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as jax_steps
from repro.models import lm as jlm
from repro_torch.common.treemath import tree_leaves
from repro_torch.compat import params_to_torch
from repro_torch.launch import steps
from repro_torch.models import lm as tlm

# tests/test_models.py's tiny LM, in both packages
_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab_size=128, q_chunk=8, kv_chunk=8, loss_chunk=8, remat="none")
B, S = 2, 16
BF16_ATOL, BF16_MEAN = 0.1, 0.02
VARIANTS = {"base": {}, "qkv_bias_tied": {"qkv_bias": True, "tie_embeddings": True}}


def _configs(impl="chunked", dtype="float32", **kw):
    jcfg = jlm.LMConfig(**_TINY, dtype=getattr(jnp, dtype), attention_impl=impl)
    tcfg = tlm.LMConfig(**_TINY, dtype=getattr(torch, dtype), attention_impl=impl)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _params(jcfg, seed=0):
    """JAX's params (biases drawn too, so qkv_bias is seen) and the port's copy."""
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = jp["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = rng.normal(scale=0.1, size=attn[name].shape).astype(np.float32)
    return jp, params_to_torch(jp, "cpu")


def _tokens(shape=(B, S), seed=1):
    return np.random.default_rng(seed).integers(0, _TINY["vocab_size"], size=shape,
                                                dtype=np.int32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cache_close(cache, jcache):
    _close(cache.k.numpy(), jcache.k)
    _close(cache.v.numpy(), jcache.v)
    assert cache.length.dtype == torch.int32
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))


@pytest.mark.parametrize("max_seq", [None, S, S + 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_matches_jax(impl, variant, max_seq):
    """The cache's k and v (rows past S zero), length and the last
    position's logits, fp32."""
    jcfg, cfg = _configs(impl, **VARIANTS[variant])
    jp, tp = _params(jcfg)
    tokens = _tokens()
    jcache, jlogits = jlm.prefill(jp, jcfg, jnp.asarray(tokens), max_seq=max_seq)
    cache, logits = tlm.prefill(tp, cfg, torch.from_numpy(tokens), max_seq=max_seq)
    slots = max_seq or S
    assert tuple(cache.k.shape) == jcache.k.shape == (2, B, slots, 2, 8)
    assert cache.k.dtype == cache.v.dtype == torch.float32 and logits.shape == (B, 128)
    _cache_close(cache, jcache)
    assert not cache.k[:, :, S:].any() and not cache.v[:, :, S:].any()
    _close(logits.numpy(), jlogits)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_four_decode_steps_match_jax(impl, variant):
    """Four decode_steps from the same prefilled cache (8 of 16 slots):
    logits, k, v and length after each, fp32."""
    jcfg, cfg = _configs(impl, **VARIANTS[variant])
    jp, tp = _params(jcfg, seed=2)
    tokens = _tokens((B, 12), seed=3)
    jcache, _ = jlm.prefill(jp, jcfg, jnp.asarray(tokens[:, :8]), max_seq=16)
    cache, _ = tlm.prefill(tp, cfg, torch.from_numpy(tokens[:, :8]), max_seq=16)
    for t in range(8, 12):
        jcache, jlogits = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(tokens[:, t]))
        cache, logits = tlm.decode_step(tp, cfg, cache, torch.from_numpy(tokens[:, t]))
        _close(logits.numpy(), jlogits)
        _cache_close(cache, jcache)
    assert cache.length.tolist() == [12, 12]


@pytest.mark.parametrize("lengths", [(16, 16), (16, 14)], ids=["full", "ragged"])
def test_decode_on_a_full_cache_clamps_as_jax(lengths):
    """``length[0] == S_max``: the write lands at S_max - 1, as JAX's
    dynamic_update_slice clamps its start, and the attention sees every
    row; rows of another length take their own RoPE position."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=4)
    tokens = _tokens((B, 17), seed=5)
    jcache, _ = jlm.prefill(jp, jcfg, jnp.asarray(tokens[:, :16]))
    cache, _ = tlm.prefill(tp, cfg, torch.from_numpy(tokens[:, :16]))
    length = np.asarray(lengths, np.int32)
    jcache = jcache._replace(length=jnp.asarray(length))
    cache = cache._replace(length=torch.from_numpy(length))
    for _ in range(2):
        jcache, jlogits = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(tokens[:, 16]))
        cache, logits = tlm.decode_step(tp, cfg, cache, torch.from_numpy(tokens[:, 16]))
        _close(logits.numpy(), jlogits)
        _cache_close(cache, jcache)


def _teacher_forcing(cfg, tp, tokens, split):
    """Logits at positions split-1 .. S-1 from prefill of tokens[:, :split]
    and decode of the rest, and from one forward over all of them."""
    t = torch.from_numpy(tokens)
    x, _, _ = tlm.backbone(tp, cfg, t)
    with torch.no_grad():
        full = tlm._head(tp, cfg, x).float()
    cache, logits = tlm.prefill(tp, cfg, t[:, :split], max_seq=2 * tokens.shape[1])
    got = [logits.float()]
    for i in range(split, tokens.shape[1]):
        cache, logits = tlm.decode_step(tp, cfg, cache, t[:, i])
        got.append(logits.float())
    return torch.stack(got, 1), full[:, split - 1:]


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_decode_matches_teacher_forcing_fp32(impl):
    """tests/test_models.py's teacher forcing in the port: prefill of 4
    tokens (max_seq 16), then decode of positions 4..7."""
    jcfg, cfg = _configs(impl)
    _, tp = _params(jcfg)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, 128), np.int32)
    got, want = _teacher_forcing(cfg, tp, tokens, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_decode_matches_teacher_forcing_bf16(impl):
    """The same in bf16 compute (fp32 params), 8 prompt tokens and 8
    decoded: held at BF16_ATOL and BF16_MEAN (the module docstring)."""
    jcfg, cfg = _configs(impl, "bfloat16")
    _, tp = _params(jcfg, seed=6)
    got, want = _teacher_forcing(cfg, tp, _tokens((B, 16), seed=7), 8)
    assert bool(torch.isfinite(got).all()) and got.shape == (B, 9, 128)
    diff = (got - want).abs()
    assert diff.max().item() <= BF16_ATOL and diff.mean().item() <= BF16_MEAN, (
        diff.max().item(), diff.mean().item())


def test_decode_step_writes_the_cache_in_place():
    """The returned cache shares the input's storage; nothing is copied."""
    jcfg, cfg = _configs()
    _, tp = _params(jcfg)
    tokens = torch.from_numpy(_tokens())
    cache, _ = tlm.prefill(tp, cfg, tokens[:, :8], max_seq=S)
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr())
    before = cache.k.clone()
    new, _ = tlm.decode_step(tp, cfg, cache, tokens[:, 8])
    assert (new.k.data_ptr(), new.v.data_ptr()) == ptrs
    assert new.k is cache.k and new.v is cache.v
    assert not torch.equal(cache.k[:, :, 8], before[:, :, 8])          # written in place
    torch.testing.assert_close(cache.k[:, :, :8], before[:, :, :8], rtol=0, atol=0)
    assert new.length.tolist() == [9, 9] and not new.k.requires_grad


class _NewStorages(TorchDispatchMode):
    """The ops that return a tensor of its own storage (not a view) of at
    least ``nbytes`` bytes."""

    def __init__(self, nbytes):
        super().__init__()
        self.nbytes, self.ops = nbytes, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr() for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen
                    and t.untyped_storage().nbytes() >= self.nbytes):
                self.ops.append(str(func))
        return out


def test_prefill_allocates_the_cache_once():
    """No stack of the layers' k and v and no padded copy: the only new
    tensors as large as the stacked k of the prompt are the cache's two. At
    8 layers the stack (8 x B x S x Hk x Dh) is twice a layer's FFN
    activations (B x S x d_ff), the largest of the rest."""
    _, cfg = _configs(n_layers=8)
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens())
    with _NewStorages(8 * B * S * 2 * 8 * 4) as seen:
        cache, _ = tlm.prefill(params, cfg, tokens, max_seq=2 * S)
    assert seen.ops == ["aten.empty.memory_format"] * 2, seen.ops
    assert tuple(cache.k.shape) == (8, B, 2 * S, 2, 8)
    with _NewStorages(8 * B * S * 2 * 8 * 4) as seen:
        tlm.backbone(params, cfg, tokens, collect_cache=True)
    assert seen.ops == ["aten.stack.default"] * 2, seen.ops      # the check sees a stack


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "stablelm-3b", "olmoe-1b-7b"])
def test_meta_build_matches_jax(arch_id, shape):
    """The full cells build on meta tensors (allocating nothing), with JAX's
    input shapes and types and its static_info."""
    prog = steps.build_cell(arch_id, shape, "cpu")
    jarch = jax_get_arch(arch_id)
    cell = jarch.shapes[shape]
    build = jax_steps._lm_prefill_program if cell.kind == "prefill" else jax_steps._lm_decode_program
    jprog = build(jarch, cell, _mesh())
    assert prog.kind == jprog.kind == cell.kind and prog.static_info == jprog.static_info
    got, want = tree_leaves(prog.args), jax.tree_util.tree_leaves(jprog.args)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert t.device.type == "meta" and tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    if cell.kind == "decode":
        cache = prog.args[1]
        assert isinstance(cache, tlm.KVCache) and cache.length.dtype == torch.int32


def test_serve_cells_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for shape in ("prefill_32k", "decode_32k"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            steps.build_cell("internlm2-1.8b", shape)


def test_cells_run_their_programs_on_the_cpu():
    """The prefill cell's fn and four steps of the decode cell's fn on its
    full cache (each write clamped to the last slot), on the tiny LM with
    the global batch cut to 2: prefill's and decode_step's values, from
    params drawn by the cell's init."""
    _, cfg = _configs()
    pre = steps.build_cell("internlm2-1.8b", "prefill_32k", "cpu", model_cfg=cfg, global_batch=B)
    dec = steps.build_cell("internlm2-1.8b", "decode_32k", "cpu", model_cfg=cfg, global_batch=B)
    assert tuple(pre.args[1].shape) == (B, 32768) and tuple(dec.args[2].shape) == (B,)
    assert pre.static_info["tokens_per_step"] == B * 32768
    assert dec.static_info["kv_cache_bytes"] == 2 * 2 * B * 32768 * 2 * 8 * 4
    params = pre.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens((B, 20), seed=8))
    cache, logits = pre.fn(params, tokens[:, :16])
    want, want_logits = tlm.prefill(params, cfg, tokens[:, :16])
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for t in range(16, 20):
        cache, logits = dec.fn(params, cache, tokens[:, t])
        want, want_logits = tlm.decode_step(params, cfg, want, tokens[:, t])
        torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    torch.testing.assert_close(cache.k, want.k, rtol=0, atol=0)
    assert cache.length.tolist() == [20, 20]
