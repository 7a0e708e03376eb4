"""The port's LM retriever (models/lm.py, the LM layers of models/layers.py,
core/precision.apply_compute_dtype, models/towers.make_lm_dual_encoder and
the two dense LM configs) against the JAX package's, on the same numpy
inputs and the same (carried-across) params.

Tolerances: fp32 within rtol/atol 1e-5 (the same arithmetic in another
summation order), for hidden states, pooled reps and every parameter
gradient (atol 1e-5 of the gradient's largest entry), with each attention
path ("plain", "chunked" and "pallas": the flash op, whose plain version
runs on the CPU while the JAX package runs its Pallas kernel in interpret
mode). bf16 compute: XLA fuses SwiGLU, the rotary products and the residual
and norm chains and rounds once, torch rounds after each op, so the pooled
reps of the tiny LM (|x| up to ~2.2) differ by whole bf16 ulps: up to 0.0176
and 0.0035 on average over 6 seeds, both paths, masked or not; held at atol
0.04 and a mean below 0.008. The layer functions alone in bf16: 2e-2. One
ContAccum step (4 chunks of 2, banks of 16, clip then SGD) on both loss
backends: rtol 1e-5, atol 1e-6 on every metric and updated param, as the
StepProgram parity tests hold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch
from repro.core import ContrastiveConfig as JConfig
from repro.core import RetrievalBatch as JBatch
from repro.core import build_step_program as jax_build
from repro.core import init_state as jax_init_state
from repro.core.precision import apply_compute_dtype as jax_apply_compute_dtype
from repro.core.types import DualEncoder as JEnc
from repro.models import layers as jax_layers
from repro.models import lm as jlm
from repro.models.towers import make_lm_dual_encoder as jax_lm_dual_encoder
from repro.optim import chain as jchain
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro_torch.common.treemath import tree_leaves
from repro_torch.compat import params_to_numpy, params_to_torch
from repro_torch.configs import get_arch
from repro_torch.core.methods import build_step_program, init_state
from repro_torch.core.precision import apply_compute_dtype
from repro_torch.core.types import ContrastiveConfig, DualEncoder, RetrievalBatch
from repro_torch.models import layers
from repro_torch.models import lm as tlm
from repro_torch.models.moe import MoEConfig
from repro_torch.models.towers import make_lm_dual_encoder
from repro_torch.optim import chain, clip_by_global_norm, sgd

# tests/test_models.py's tiny LM, in both packages
_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab_size=128, q_chunk=8, kv_chunk=8, loss_chunk=8, remat="none")
JAX_TINY = jlm.LMConfig(**_TINY, dtype=jnp.float32)
TINY = tlm.LMConfig(**_TINY, dtype=torch.float32)
BF16_ATOL, BF16_MEAN = 0.04, 0.008


def _configs(**kw):
    return dataclasses.replace(JAX_TINY, **kw), dataclasses.replace(TINY, **kw)


def _tokens(b=3, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TINY.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.arange(s)[None, :] < rng.integers(4, s + 1, size=b)[:, None]
    return tokens, mask


def _paths(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_grads_close(got_tree, want_tree, what):
    got, want = _paths(got_tree), _paths(jax.device_get(want_tree))
    assert sorted(got) == sorted(want), what
    for name, t in got.items():
        jg = np.asarray(want[name])
        g = np.zeros_like(jg) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * max(np.abs(jg).max(), 1e-30),
                                   err_msg=f"{what}: {name}")


def _port_tx():
    """Clip at 2.0, then SGD (0.1): the JAX side's jchain(jclip, jsgd)."""
    return chain(clip_by_global_norm(2.0), sgd(0.1))


def _retrieval_batch(rng, b, q_len=8, p_len=16, n_hard=1):
    def toks(*shape):
        return rng.integers(0, TINY.vocab_size, size=shape).astype(np.int32)

    return toks(b, q_len), toks(b, p_len), toks(b, n_hard, p_len)


FIELDS = ("loss", "accuracy", "grad_norm", "grad_norm_query", "grad_norm_passage",
          "grad_norm_ratio", "n_negatives", "bank_fill_q", "bank_fill_p")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["linear", "linear_bias", "rms_norm", "swiglu", "rotary"])
def test_layer_functions_match_jax(fn, dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 6, 4, 16)) * 2).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    jt = lambda a: jnp.asarray(a).astype(dtype)                      # noqa: E731
    tt = lambda a: torch.as_tensor(a).to(getattr(torch, dtype))      # noqa: E731
    if fn in ("linear", "linear_bias"):
        jp, tp = {"w": jt(w)}, {"w": tt(w)}
        if fn == "linear_bias":
            jp["b"], tp["b"] = jt(b), tt(b)
        want, got = jax_layers.linear(jp, jt(x)), layers.linear(tp, tt(x))
    elif fn == "rms_norm":
        want = jax_layers.rms_norm(jnp.asarray(scale), jt(x), eps=1e-6)
        got = layers.rms_norm(torch.as_tensor(scale), tt(x), eps=1e-6)
    elif fn == "swiglu":
        want, got = jax_layers.swiglu(jt(x), jt(x[::-1])), layers.swiglu(tt(x), tt(x[::-1].copy()))
    else:
        pos = np.arange(6)
        jcos, jsin = jax_layers.rotary_embedding(jnp.asarray(pos), 16, 1e6, getattr(jnp, dtype))
        tcos, tsin = layers.rotary_embedding(torch.as_tensor(pos), 16, 1e6, getattr(torch, dtype))
        assert tcos.dtype == tsin.dtype == getattr(torch, dtype)
        for jv, tv in ((jcos, tcos), (jsin, tsin)):
            np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)),
                                       rtol=1e-5, atol=1e-6)
        want, got = jax_layers.apply_rotary(jt(x), jcos, jsin), layers.apply_rotary(tt(x), tcos, tsin)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("variant", [{}, {"qkv_bias": True, "tie_embeddings": True}],
                         ids=["base", "qkv_bias_tied"])
def test_init_lm_tree_matches_jax(variant):
    """Same leaves (paths), shapes and dtypes as JAX's tree, param_count
    equal in both packages and to the count of its parameters (which leaves
    the QKV biases out, in both), and the norms at one and the biases at
    zero."""
    jcfg, cfg = _configs(**variant)
    want = _paths(jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg)))
    got = _paths(tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == torch.float32 and want[name].dtype == np.float32, name
    n = sum(t.numel() for k, t in got.items() if k not in ("layers/attn/bq", "layers/attn/bk",
                                                           "layers/attn/bv"))
    assert n == cfg.param_count() == jcfg.param_count() == cfg.active_param_count()
    for name in ("layers/ln1", "layers/ln2", "final_norm"):
        assert bool((got[name] == 1).all())
    for name in ("bq", "bk", "bv"):
        assert (f"layers/attn/{name}" in got) == bool(variant)
        if variant:
            assert bool((got[f"layers/attn/{name}"] == 0).all())
    assert ("lm_head" in got) != bool(variant)


# ------------------------------------------------- backbone, encode_pooled
def _grad_case(jcfg, cfg, tokens, mask, w, fn_jax, fn_port, seed=1):
    """fn(params, tokens, mask) -> (B, d) in both packages: the values and
    every gradient of sum(out * w), from the same params."""
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)

    def jloss(p):
        out = fn_jax(p, jnp.asarray(tokens), None if mask is None else jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * w), out

    jgrads, want = jax.grad(jloss, has_aux=True)(jparams)
    params = params_to_torch(jax.device_get(jparams), "cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    got = fn_port(params, torch.as_tensor(tokens).long(),
                  None if mask is None else torch.as_tensor(mask))
    (got.float() * torch.as_tensor(w)).sum().backward()
    return got.detach(), np.asarray(want), params, jgrads


@pytest.mark.parametrize("variant", [{}, {"qkv_bias": True, "tie_embeddings": True}],
                         ids=["base", "qkv_bias_tied"])
@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("impl", ["plain", "chunked", "pallas"])
def test_backbone_matches_jax(impl, scan_layers, variant):
    """The final hidden states (pooled by a fixed projection) and every
    parameter gradient, fp32; the stacked (k, v) of collect_cache too."""
    jcfg, cfg = _configs(attention_impl=impl, scan_layers=scan_layers, **variant)
    tokens, _ = _tokens(seed=2)
    w = np.random.default_rng(3).normal(size=(3, 16, 32)).astype(np.float32)
    got, want, params, jgrads = _grad_case(
        jcfg, cfg, tokens, None, w,
        lambda p, t, m: jlm.backbone(p, jcfg, t)[0], lambda p, t, m: tlm.backbone(p, cfg, t)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    _assert_grads_close(params, jgrads, impl)
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(1), jcfg))
    _, jaux, (jk, jv) = jlm.backbone(jp, jcfg, jnp.asarray(tokens), collect_cache=True)
    with torch.inference_mode():
        _, aux, (k, v) = tlm.backbone(params_to_torch(jp, "cpu"), cfg,
                                      torch.as_tensor(tokens).long(), collect_cache=True)
    assert float(aux) == float(jaux) == 0.0
    assert tuple(k.shape) == jk.shape == (2, 3, 16, 2, 8)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["plain", "chunked", "pallas"])
def test_encode_pooled_matches_jax(impl, masked):
    """Mean-pooled reps over the valid positions (or all) and every
    parameter gradient, fp32."""
    jcfg, cfg = _configs(attention_impl=impl)
    tokens, mask = _tokens(seed=4)
    mask = mask if masked else None
    w = np.random.default_rng(5).normal(size=(3, 32)).astype(np.float32)
    got, want, params, jgrads = _grad_case(
        jcfg, cfg, tokens, mask, w,
        lambda p, t, m: jlm.encode_pooled(p, jcfg, t, m),
        lambda p, t, m: tlm.encode_pooled(p, cfg, t, m))
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    _assert_grads_close(params, jgrads, impl)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["plain", "pallas"])
def test_remat_policies_give_the_same_values_and_grads(impl):
    """"none", "full" and "dots" give the reps and gradients of "none" (and
    JAX's); "full" runs the projection matmuls of every layer again in the
    backward (at least the 6 whose outputs a backward reads: torch stops the
    recompute once the last of them is back, before the down projection),
    "dots" keeps their outputs and runs none of them again."""
    tokens, mask = _tokens(seed=6)
    w = np.random.default_rng(7).normal(size=(3, 32)).astype(np.float32)
    out, backward_mm = {}, {}
    for remat in ("none", "full", "dots"):
        jcfg, cfg = _configs(attention_impl=impl, remat=remat)
        jparams = jlm.init_lm(jax.random.PRNGKey(8), jcfg)
        params = params_to_torch(jax.device_get(jparams), "cpu")
        for t in tree_leaves(params):
            t.requires_grad_(True)
        reps = tlm.encode_pooled(params, cfg, torch.as_tensor(tokens).long(), torch.as_tensor(mask))
        loss = (reps * torch.as_tensor(w)).sum()
        with _CountMatmuls() as count:
            loss.backward()
        backward_mm[remat] = count.n
        out[remat] = (reps.detach(), {k: t.grad for k, t in _paths(params).items()})
        want = jlm.encode_pooled(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(mask))
        np.testing.assert_allclose(reps.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for remat in ("full", "dots"):
        torch.testing.assert_close(out[remat][0], out["none"][0], rtol=0, atol=0)
        for name, g in out[remat][1].items():
            torch.testing.assert_close(g, out["none"][1][name], rtol=1e-6, atol=1e-7)
    assert backward_mm["full"] - backward_mm["none"] >= 6 * TINY.n_layers
    assert backward_mm["dots"] == backward_mm["none"]


def test_unknown_remat_and_moe_raise():
    """An unknown remat policy, and an MoE layer whose B*S tokens do not
    divide into its groups (JAX asserts; the port raises ValueError)."""
    with pytest.raises(ValueError, match="remat"):
        tlm._remat_wrap(dataclasses.replace(TINY, remat="some"), lambda x: x)
    moe = dataclasses.replace(TINY, d_ff=0, moe=MoEConfig(n_experts=4, top_k=2, d_expert=16,
                                                          group_size=16))
    params = tlm.init_lm(moe, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="not divisible by group size 16"):
        tlm.backbone(params, moe, torch.zeros((3, 8), dtype=torch.long))


# ------------------------------------------- precision and the dual encoder
class _NoCast(torch.Tensor):
    """A tensor whose cast raises: a leaf the encoder must never cast."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to:
            raise AssertionError("a leaf the encoder does not read was cast")
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("tower", ["query", "passage"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", [None, "bf16_banks"])
def test_lm_dual_encoder_matches_jax(precision, compute, tower):
    """make_lm_dual_encoder (and so apply_compute_dtype) against JAX: reps
    in the policy's compute dtype, fp32 at 1e-5, bf16 at the module's
    tolerances; stored params fp32; only what the tower reads is cast."""
    jcfg, cfg = _configs(dtype=getattr(jnp, compute))
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, compute))
    tokens, mask = _tokens(b=4, seed=9)
    jenc = jax_lm_dual_encoder(jcfg, precision=precision)
    jparams = jenc.init(jax.random.PRNGKey(10))
    jb = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    want = np.asarray(getattr(jenc, f"encode_{tower}")(jparams, jb).astype(jnp.float32))
    enc = make_lm_dual_encoder(cfg, precision=precision)
    params = params_to_torch(jax.device_get(jparams), "cpu")
    other = "passage" if tower == "query" else "query"
    if precision is not None:
        params[tower]["lm_head"] = params[tower]["lm_head"].as_subclass(_NoCast)
        params[other] = {k: v.as_subclass(_NoCast) if isinstance(v, torch.Tensor) else v
                         for k, v in params[other].items()}
    with torch.inference_mode():
        got = getattr(enc, f"encode_{tower}")(params, {"tokens": torch.as_tensor(tokens).long(),
                                                        "mask": torch.as_tensor(mask)})
    out_dtype = torch.float32 if precision is None and compute == "float32" else torch.bfloat16
    assert got.dtype == out_dtype and got.shape == (4, 32) and enc.rep_dim == 32
    got = got.float().numpy()
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        assert np.abs(got - want).mean() < BF16_MEAN
    own = enc.init(torch.Generator().manual_seed(0), "cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(own))


def test_apply_compute_dtype_casts_inputs_and_outputs_like_jax():
    """A generic encoder (float vectors in, not tokens): float params and
    inputs cast to the compute dtype, the reps in it, init in param_dtype."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    jenc = jax_apply_compute_dtype(JEnc(
        init=lambda rng: {"query": {"w": jnp.asarray(w)}, "passage": {"w": jnp.asarray(w)}},
        encode_query=lambda p, b: b @ p["query"]["w"], encode_passage=lambda p, b: b @ p["passage"]["w"],
        rep_dim=4), "bf16")
    seen = []

    def encode(p, b):
        seen.append((p["query"]["w"].dtype, b.dtype))
        return b @ p["query"]["w"]

    enc = apply_compute_dtype(DualEncoder(
        init=lambda g, device: {"query": {"w": torch.as_tensor(w).double()}},
        encode_query=encode, encode_passage=encode, rep_dim=4), "bf16")
    got = enc.encode_query({"query": {"w": torch.as_tensor(w)}}, torch.as_tensor(x))
    want = jenc.encode_query(jenc.init(None), jnp.asarray(x))
    assert seen == [(torch.bfloat16, torch.bfloat16)] and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert enc.init(None, "cpu")["query"]["w"].dtype == torch.float32


def test_shared_towers_alias_at_init_and_part_after_a_step():
    """shared=True: one set of tensors at init (JAX's aliasing); the update
    differentiates each tower's leaves apart, so the towers differ after one
    step; shared=False draws two towers."""
    enc = make_lm_dual_encoder(TINY)
    params = enc.init(torch.Generator().manual_seed(0), "cpu")
    assert params["query"] is params["passage"]
    cfg = ContrastiveConfig(method="contaccum", accumulation_steps=2, bank_size=8)
    tx = _port_tx()
    state = init_state(None, enc, tx, cfg, params=params, device="cpu")
    batch = _retrieval_batch(np.random.default_rng(12), 4)
    state, _ = build_step_program(enc, tx, cfg).update(state, RetrievalBatch(*(
        torch.as_tensor(a).long() for a in batch)))
    q, p = _paths(state.params["query"]), _paths(state.params["passage"])
    assert not torch.equal(q["layers/attn/wq"], p["layers/attn/wq"])
    two = make_lm_dual_encoder(TINY, shared=False).init(torch.Generator().manual_seed(0), "cpu")
    assert not torch.equal(two["query"]["embed"], two["passage"]["embed"])


def test_init_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks what happens without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_lm(TINY, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_lm_dual_encoder(TINY).init(torch.Generator())


# ------------------------------------------------------ the slice as a whole
@pytest.mark.parametrize("loss_impl", ["dense", "fused"])
def test_contaccum_step_of_a_shared_lm_dual_encoder_matches_jax(loss_impl):
    """One ContAccum step (8 pairs as 4 chunks of 2, dual banks of 16, one
    hard negative, clip then SGD) of a tiny shared=True LM dual encoder,
    from the same params: the loss, every metric and both towers' updated
    params agree, and in both packages the towers differ after the step."""
    kw = dict(method="contaccum", accumulation_steps=4, bank_size=16, grad_clip_norm=2.0)
    jenc = jax_lm_dual_encoder(JAX_TINY)
    jtx = jchain(jclip(2.0), jsgd(0.1))
    jcfg = JConfig(**kw, loss_impl=loss_impl)
    jstate = jax_init_state(jax.random.PRNGKey(13), jenc, jtx, jcfg)
    params0 = jax.device_get(jstate.params)
    batch = _retrieval_batch(np.random.default_rng(14), 8)
    jnew, jm = jax.jit(jax_build(jenc, jtx, jcfg).update)(jstate, JBatch(*map(jnp.asarray, batch)))
    jnew, jm = jax.device_get(jnew), jax.device_get(jm)

    enc = make_lm_dual_encoder(TINY)
    tx = _port_tx()
    cfg = ContrastiveConfig(**kw, loss_impl=loss_impl)
    params = params_to_torch(params0["query"], "cpu")
    state = init_state(None, enc, tx, cfg, params={"query": params, "passage": params},
                       device="cpu")
    new, m = build_step_program(enc, tx, cfg).update(
        state, RetrievalBatch(*(torch.as_tensor(a).long() for a in batch)))
    for field in FIELDS:
        np.testing.assert_allclose(float(getattr(m, field)), float(getattr(jm, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    got = params_to_numpy(new.params)
    for tower in ("query", "passage"):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=tower),
            got[tower], jnew.params[tower])
    for tree in (got, jnew.params):
        wq = [np.asarray(tree[t]["layers"]["attn"]["wq"]) for t in ("query", "passage")]
        assert np.abs(wq[0] - wq[1]).max() > 1e-6
    np.testing.assert_allclose(new.bank_p.buf.numpy(), np.asarray(jnew.bank_p.buf),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "stablelm-3b", "olmoe-1b-7b"])
def test_registered_lm_configs_equal_jax(arch_id):
    mine, theirs = get_arch(arch_id), jax_get_arch(arch_id)
    a, b = dataclasses.asdict(mine.model_cfg), dataclasses.asdict(theirs.model_cfg)
    for key in ("dtype", "param_dtype"):
        assert str(a.pop(key)).replace("torch.", "") == np.dtype(b.pop(key)).name
    assert a == b
    assert (mine.family, mine.micro_batches, sorted(mine.shapes)) == (
        theirs.family, theirs.micro_batches, sorted(theirs.shapes))
    cfg = mine.model_cfg
    assert cfg.dh == theirs.model_cfg.dh
    assert cfg.param_count() == theirs.model_cfg.param_count()
    assert cfg.active_param_count() == theirs.model_cfg.active_param_count()
