"""The port's MoE causal LM (models/lm.py with ``LMConfig.moe``, the
olmoe-1b-7b config and its cells) against the JAX package's, on a tiny MoE
LM (2 layers, d 32, 4 experts, top 2, groups of 16), the same numpy inputs
and the same (carried-across) params, in fp32.

Tolerances: fp32 within rtol/atol 1e-5 (the same arithmetic in another
summation order) for hidden states, ``moe_aux``, the loss, the cache's k
and v and the logits, and every gradient leaf within rtol 1e-5 and 1e-5 of
its largest |g|; teacher forcing at tests/test_models.py's rtol 2e-4 /
atol 2e-5. The model-level tests stay in fp32: in bf16 XLA and torch round
different tensors, and a router logit near the k-th place can then pick
another expert and move a token's output by O(1) (tests/test_torch_moe.py
holds bf16 at the module level, on identical inputs).

Capacity drops depend on the group (a token's slot counts the earlier
tokens of its group): a prefill groups the (B*S) tokens row-major, a
decode step the B tokens of the step. So the generation equals the
forward only where nothing is dropped (the dropless twin: capacity =
group), and two prefills agree on a prompt's cache rows where the prompt's
groups are the same groups in both (lengths that are multiples of the
group); both packages behave alike in each case.

In bf16 (the port alone) a dropless generation departs from the forward
by the bf16 ulps the two routes round apart, and more where a token's
router logits sit within those ulps of the k-th place: it picks another
expert on one route. On a 4-layer LM of width 128 routed as olmoe-1b-7b
(64 experts, top 8), seeds 0-5, prompt 64, 32 decode steps: mean
|difference| 0.010-0.025 and largest 0.22-0.48 with MoE, 0.008-0.010 and
0.05-0.09 for its dense twin. Held: the MoE run within chip_smoke.py's
MOE_TF_MEAN / MOE_TF_MAX (0.05, 1.0), the dense twin within LM_SERVE_TF_*
(0.02, 0.25), and the MoE's largest difference past the dense twin's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as jax_steps
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.common.treemath import tree_leaves
from repro_torch.compat import params_to_torch
from repro_torch.configs import get_arch
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

_TINY = dict(name="tiny-moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=0,
             vocab_size=128, q_chunk=8, kv_chunk=8, loss_chunk=8, remat="none")
_MOE = dict(n_experts=4, top_k=2, d_expert=48, capacity_factor=1.25, group_size=16)
B, S = 2, 16
ARCH = "olmoe-1b-7b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs a worker per core, and
    torch's intra-op threads on top of them slowed this file's many small
    CPU ops tenfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(impl="chunked", moe=None, **kw):
    m = {**_MOE, **(moe or {})}
    jcfg = jlm.LMConfig(**_TINY, dtype=jnp.float32, attention_impl=impl,
                        moe=jmoe.MoEConfig(**m))
    tcfg = tlm.LMConfig(**_TINY, dtype=torch.float32, attention_impl=impl,
                        moe=tmoe.MoEConfig(**m))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _params(jcfg, seed=0):
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jp, params_to_torch(jp, "cpu")


def _tokens(shape=(B, S), seed=1):
    return np.random.default_rng(seed).integers(0, _TINY["vocab_size"], size=shape,
                                                dtype=np.int32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_init_lm_draws_the_moe_ffn():
    _, cfg = _configs()
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), _configs()[0]))
    got = {k: tuple(v.shape) for k, v in _paths(params).items()}
    assert got == {k: tuple(v.shape) for k, v in _paths(jparams).items()}
    assert got["layers/ffn/w_gate"] == (2, 4, 32, 48) and got["layers/ffn/router"] == (2, 32, 4)
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()


@pytest.mark.parametrize("vectorize", [True, False], ids=["vectorized", "scan"])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_backbone_matches_jax(impl, vectorize):
    """Hidden states and the layers' mean moe_aux, with drops (capacity
    factor 1.25 at groups of 16) in both dispatch branches."""
    jcfg, cfg = _configs(impl, {"vectorize_groups": vectorize})
    jp, tp = _params(jcfg)
    tokens = _tokens()
    jx, jaux, _ = jlm.backbone(jp, jcfg, jnp.asarray(tokens))
    x, aux, _ = tlm.backbone(tp, cfg, torch.from_numpy(tokens))
    _close(x.numpy(), jx)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux.numpy(), jaux)
    assert float(aux) > 0
    # the config drops: the first layer's MoE on the normed embeddings
    y = tlm.L.rms_norm(tp["layers"]["ln2"][0], tp["embed"][torch.from_numpy(tokens)])
    _, m = tmoe.moe_ffn({k: v[0] for k, v in tp["layers"]["ffn"].items()},
                        y.reshape(B * S, -1), cfg.moe)
    assert float(m["moe_dropped_frac"]) > 0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_lm_loss_and_grads_match_jax(impl, remat):
    """lm_loss (token loss + the mean moe_aux), its parts, and the gradient
    of every leaf (the router's through the gates and the aux loss)."""
    jcfg, cfg = _configs(impl, remat=remat)
    jp, _ = _params(jcfg, seed=2)
    tokens = _tokens(seed=3)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(tokens), jnp.asarray(targets)),
        has_aux=True)(jp)
    leaves = params_to_torch(jp, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    loss, aux = tlm.lm_loss(leaves, cfg, torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    _close(loss.item(), float(jloss))
    for key in ("lm_loss", "moe_aux", "tokens"):
        _close(aux[key].detach().numpy(), jaux[key])
    assert float(aux["moe_aux"].detach()) > 0
    want = _paths(jax.device_get(jg))
    got = {k: t.grad.numpy() for k, t in _paths(leaves).items()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("max_seq", [None, S + 8])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_matches_jax(impl, max_seq):
    jcfg, cfg = _configs(impl)
    jp, tp = _params(jcfg, seed=4)
    tokens = _tokens(seed=5)
    jcache, jlogits = jlm.prefill(jp, jcfg, jnp.asarray(tokens), max_seq=max_seq)
    cache, logits = tlm.prefill(tp, cfg, torch.from_numpy(tokens), max_seq=max_seq)
    assert tuple(cache.k.shape) == jcache.k.shape == (2, B, max_seq or S, 2, 8)
    _close(cache.k.numpy(), jcache.k)
    _close(cache.v.numpy(), jcache.v)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))
    _close(logits.numpy(), jlogits)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_four_decode_steps_match_jax(impl):
    """Four decode_steps from the same prefilled cache: each step's B = 2
    tokens are one group (capacity top_k, nothing dropped)."""
    jcfg, cfg = _configs(impl)
    jp, tp = _params(jcfg, seed=6)
    tokens = _tokens((B, 20), seed=7)
    jcache, _ = jlm.prefill(jp, jcfg, jnp.asarray(tokens[:, :16]), max_seq=24)
    cache, _ = tlm.prefill(tp, cfg, torch.from_numpy(tokens[:, :16]), max_seq=24)
    for t in range(16, 20):
        jcache, jlogits = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(tokens[:, t]))
        cache, logits = tlm.decode_step(tp, cfg, cache, torch.from_numpy(tokens[:, t]))
        _close(logits.numpy(), jlogits)
        _close(cache.k.numpy(), jcache.k)
        _close(cache.v.numpy(), jcache.v)
    assert cache.length.tolist() == [20, 20]


def _generation(cfg, tp, tokens, split):
    """Logits at positions split-1 .. S-1 from prefill of tokens[:, :split]
    and decode of the rest."""
    t = torch.from_numpy(tokens)
    cache, logits = tlm.prefill(tp, cfg, t[:, :split], max_seq=tokens.shape[1])
    got = [logits]
    for i in range(split, tokens.shape[1]):
        cache, logits = tlm.decode_step(tp, cfg, cache, t[:, i])
        got.append(logits)
    return torch.stack(got, 1)


def _jax_forward_logits(jcfg, jp, tokens, split):
    jx, _, _ = jlm.backbone(jp, jcfg, jnp.asarray(tokens))
    return np.asarray(jlm._head(jp, jcfg, jx))[:, split - 1:]


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_generation_matches_teacher_forcing_dropless(impl):
    """Under the dropless twin (capacity_factor E / k: capacity = group) a
    prompt of 16 prefilled into 32 slots and 16 decode steps give the one
    forward's logits, in the port and against JAX's forward."""
    jcfg, cfg = _configs(impl, {"capacity_factor": 4 / 2})
    assert tmoe._capacity(16, cfg.moe) == 16
    jp, tp = _params(jcfg, seed=8)
    tokens = _tokens((B, 32), seed=9)
    got = _generation(cfg, tp, tokens, 16)
    x, _, _ = tlm.backbone(tp, cfg, torch.from_numpy(tokens))
    want = tlm._head(tp, cfg, x)[:, 15:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _jax_forward_logits(jcfg, jp, tokens, 16),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seed", range(6))
def test_bf16_generation_against_teacher_forcing_dropless(seed):
    """The module docstring's bf16 case: an MoE LM routed as olmoe-1b-7b and
    its dense twin, prefill of 64 tokens and 32 decode steps against one
    forward over 96."""
    diffs = {}
    for kind in ("moe", "dense"):
        moe = tmoe.MoEConfig(n_experts=64, top_k=8, d_expert=64, capacity_factor=8.0,
                             group_size=16) if kind == "moe" else None
        cfg = tlm.LMConfig(name=kind, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                           d_ff=0 if moe else 256, vocab_size=512, dtype=torch.bfloat16,
                           attention_impl="chunked", q_chunk=32, kv_chunk=32, remat="none",
                           moe=moe)
        params = tlm.init_lm(cfg, torch.Generator().manual_seed(seed), "cpu")
        tokens = np.random.default_rng(seed).integers(0, 512, size=(B, 96), dtype=np.int32)
        got = _generation(cfg, params, tokens, 64)[:, :-1].float()
        with torch.no_grad():
            x, _, _ = tlm.backbone(params, cfg, torch.from_numpy(tokens))
            want = tlm._head(params, cfg, x[:, 63:-1]).float()
        assert bool(torch.isfinite(got).all())
        diffs[kind] = (got - want).abs()
    assert diffs["moe"].mean() <= 0.05 and diffs["moe"].max() <= 1.0, diffs["moe"].max()
    assert diffs["dense"].mean() <= 0.02 and diffs["dense"].max() <= 0.25
    assert diffs["moe"].max() > diffs["dense"].max()


def test_generation_departs_from_teacher_forcing_where_groups_drop():
    """At a dropping capacity (factor 0.5) the decode's groups (the B tokens
    of a step) drop nothing while the forward's groups of 16 drop, so the
    generation departs from the forward; JAX's departs alike, and the port's
    generation equals JAX's."""
    jcfg, cfg = _configs(moe={"capacity_factor": 0.5})
    jp, tp = _params(jcfg, seed=8)
    tokens = _tokens((B, 32), seed=9)
    got = _generation(cfg, tp, tokens, 16).numpy()
    want = _jax_forward_logits(jcfg, jp, tokens, 16)
    jcache, jlogits = jlm.prefill(jp, jcfg, jnp.asarray(tokens[:, :16]), max_seq=32)
    jgen = [np.asarray(jlogits)]
    for i in range(16, 32):
        jcache, jlogits = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(tokens[:, i]))
        jgen.append(np.asarray(jlogits))
    jgen = np.stack(jgen, 1)
    _close(got, jgen)
    assert np.abs(jgen[:, 1:] - want[:, 1:]).max() > 1e-2
    assert np.abs(got[:, 1:] - want[:, 1:]).max() > 1e-2


@pytest.mark.parametrize("prompt,same", [(16, True), (24, False)], ids=["aligned", "misaligned"])
def test_prefill_cache_rows_across_prompt_lengths(prompt, same):
    """Two prefills at a dropping capacity: a prompt whose length is a
    multiple of the group keeps each of its groups in a longer prefill
    (the tokens flatten row-major), so their cache rows agree; at 24 the
    second sequence's first tokens share a group with the first's last
    in the short run only, and their rows differ."""
    jcfg, cfg = _configs(moe={"capacity_factor": 0.5})
    _, tp = _params(jcfg, seed=10)
    tokens = torch.from_numpy(_tokens((B, 32), seed=11))
    short, _ = tlm.prefill(tp, cfg, tokens[:, :prompt], max_seq=32)
    full, _ = tlm.prefill(tp, cfg, tokens, max_seq=32)
    diff = (short.k[:, :, :prompt] - full.k[:, :, :prompt]).abs().max().item()
    if same:
        assert diff <= 1e-5
    else:
        assert diff > 1e-2


# --------------------------------------------------- the olmoe config and cells
def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_olmoe_train_cell_builds_on_meta_as_jax():
    """The train cell builds for olmoe-1b-7b on meta tensors, with JAX's
    input shapes, static_info and param tree (no phase runs it yet)."""
    prog = steps.build_cell(ARCH, "train_4k", "cpu")
    jarch = jax_get_arch(ARCH)
    jprog = jax_steps._lm_train_program(jarch, jarch.shapes["train_4k"], _mesh())
    assert prog.kind == "train" and prog.static_info == jprog.static_info
    state, tokens, _ = prog.args
    assert tuple(tokens.shape) == tuple(jprog.args[1].shape) == (4, 64, 4096)
    assert all(t.device.type == "meta" for t in tree_leaves(state))
    got = [tuple(t.shape) for t in tree_leaves(state.params)]
    assert got == [tuple(s.shape) for s in jax.tree_util.tree_leaves(jprog.args[0].params)]
    assert sum(np.prod(s) for s in got) == get_arch(ARCH).model_cfg.param_count() == 6919096320


def test_olmoe_serve_cells_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for shape in ("prefill_32k", "decode_32k"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            steps.build_cell(ARCH, shape)


def test_olmoe_cells_run_their_programs_on_the_cpu():
    """The olmoe prefill and decode cells' fns on the tiny MoE LM with the
    global batch cut to 2: prefill's and decode_step's values, from params
    drawn by the cell's init."""
    _, cfg = _configs()
    pre = steps.build_cell(ARCH, "prefill_32k", "cpu", model_cfg=cfg, global_batch=B)
    dec = steps.build_cell(ARCH, "decode_32k", "cpu", model_cfg=cfg, global_batch=B)
    params = pre.init(torch.Generator().manual_seed(0))
    assert tuple(params["layers"]["ffn"]["w_up"].shape) == (2, 4, 32, 48)
    tokens = torch.from_numpy(_tokens((B, 20), seed=12))
    cache, logits = pre.fn(params, tokens[:, :16])
    want, want_logits = tlm.prefill(params, cfg, tokens[:, :16])
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for t in range(16, 20):
        cache, logits = dec.fn(params, cache, tokens[:, t])
        want, want_logits = tlm.decode_step(params, cfg, want, tokens[:, t])
        torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    torch.testing.assert_close(cache.k, want.k, rtol=0, atol=0)
