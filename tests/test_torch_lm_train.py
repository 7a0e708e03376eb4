"""The port's causal-LM training (models/lm.py's ``_head`` and ``lm_loss``,
launch/steps.py's ``_lm_flops`` and ``_lm_train_program``) against the JAX
package's, on the same numpy inputs and the same (carried-across) params.

Tolerances: fp32 within rtol 1e-5 (the same arithmetic in another
summation order) for the loss and every parameter gradient (atol 1e-5 of
the gradient's largest entry). bf16 compute: XLA fuses the rotary, SwiGLU
and norm chains and rounds once where torch rounds after each op, so the
tiny LM's bf16 results differ by bf16 ulps of its hidden states: over 6
seeds, tied and untied, the loss by up to 3.5e-4 relative and a gradient
leaf by up to 2.4e-2 of its largest entry; held at 2e-3 and 5e-2. Three
train-cell steps: the loss at 1e-5
relative, the params at 1e-5 relative plus 1e-3 of the largest move (the
warm-up schedule moves them little in three steps, and an AdamW step
divides m by sqrt(v), so an element near 0 moves by up to lr either way;
tests/test_torch_recsys.py holds the recsys cell to the same rule).
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
from repro_torch.common.treemath import tree_leaves
from repro_torch.compat import params_to_torch
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import steps
from repro_torch.models import lm as tlm

# tests/test_models.py's tiny LM, in both packages
_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab_size=128, q_chunk=8, kv_chunk=8, loss_chunk=8, remat="none")
B, S = 2, 16
BF16_RTOL, BF16_GRAD_RTOL = 2e-3, 5e-2
ARCH = "internlm2-1.8b"


def _configs(dtype="float32", **kw):
    jcfg = jlm.LMConfig(**_TINY, dtype=getattr(jnp, dtype))
    tcfg = tlm.LMConfig(**_TINY, dtype=getattr(torch, dtype))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _inputs(jcfg, pad_every=5):
    """tests/test_models.py's params and tokens (PRNGKeys 0 and 1), targets
    the next token with -1 at the last position and at every
    ``pad_every``-th one (padding)."""
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, jcfg.vocab_size),
                        np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    targets[:, ::pad_every] = -1
    return jp, tokens, targets


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_loss_and_grads(tcfg, jp, tokens, targets):
    leaves = params_to_torch(jp, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    loss, aux = tlm.lm_loss(leaves, tcfg, torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    return loss.item(), aux, {k: t.grad.numpy() for k, t in _paths(leaves).items()}


def _jax_loss_and_grads(jcfg, jp, tokens, targets):
    (loss, aux), g = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(tokens), jnp.asarray(targets)),
        has_aux=True)(jp)
    return float(loss), aux, _paths(jax.device_get(g))


# ------------------------------------------------------------------- _head
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_head_matches_jax(tied, dtype):
    jcfg, tcfg = _configs(dtype, tie_embeddings=tied)
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(2).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jlm._head(jp, jcfg, jnp.asarray(x).astype(jcfg.dtype)).astype(jnp.float32))
    got = tlm._head(params_to_torch(jp, "cpu"), tcfg, torch.from_numpy(x).to(tcfg.dtype))
    assert got.dtype == tcfg.dtype and got.shape == (B, S, jcfg.vocab_size)
    # bf16: one product rounded to bf16 by both, from fp32 sums in another order
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


# ----------------------------------------------------------------- lm_loss
@pytest.mark.parametrize("loss_chunk", [4, 8, S, 2 * S])
@pytest.mark.parametrize("tied", [False, True])
def test_lm_loss_and_grads_match_jax_fp32(tied, loss_chunk):
    jcfg, tcfg = _configs(tie_embeddings=tied, loss_chunk=loss_chunk)
    jp, tokens, targets = _inputs(jcfg)
    loss, aux, grads = _port_loss_and_grads(tcfg, jp, tokens, targets)
    jloss, jaux, jgrads = _jax_loss_and_grads(jcfg, jp, tokens, targets)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(aux["lm_loss"].item(), float(jaux["lm_loss"]), rtol=1e-5)
    assert aux["tokens"].item() == float(jaux["tokens"]) == int((targets >= 0).sum())
    assert aux["moe_aux"].item() == float(jaux["moe_aux"]) == 0.0
    assert sorted(grads) == sorted(jgrads)
    assert ("lm_head" in grads) is not tied
    for name, g in grads.items():
        jg = np.asarray(jgrads[name])
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


@pytest.mark.parametrize("tied", [False, True])
def test_lm_loss_and_grads_match_jax_bf16(tied):
    jcfg, tcfg = _configs("bfloat16", tie_embeddings=tied, loss_chunk=4)
    jp, tokens, targets = _inputs(jcfg)
    loss, _, grads = _port_loss_and_grads(tcfg, jp, tokens, targets)
    jloss, _, jgrads = _jax_loss_and_grads(jcfg, jp, tokens, targets)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=BF16_RTOL)
    for name, g in grads.items():
        jg = np.asarray(jgrads[name], np.float32)
        np.testing.assert_allclose(g, jg, rtol=0, atol=BF16_GRAD_RTOL * np.abs(jg).max(),
                                   err_msg=name)


def test_lm_loss_matches_dense_cross_entropy_without_grad():
    """Under no_grad (no checkpoint) the chunked loss is the dense cross
    entropy over the unmasked targets."""
    _, tcfg = _configs(loss_chunk=4)
    jcfg, _ = _configs()
    jp, tokens, targets = _inputs(jcfg)
    params = params_to_torch(jp, "cpu")
    tk, tg = torch.from_numpy(tokens), torch.from_numpy(targets).long()
    with torch.no_grad():
        loss, aux = tlm.lm_loss(params, tcfg, tk, tg)
        x, _, _ = tlm.backbone(params, tcfg, tk)
        logits = tlm._head(params, tcfg, x).float()
        dense = torch.nn.functional.cross_entropy(logits.reshape(-1, tcfg.vocab_size),
                                                  tg.reshape(-1), ignore_index=-1)
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-6)
    assert aux["tokens"].item() == int((targets >= 0).sum())


@pytest.mark.parametrize("loss_chunk", [3, 5, 12])
def test_uneven_loss_chunk_raises(loss_chunk):
    jcfg, tcfg = _configs(loss_chunk=loss_chunk)
    jp, tokens, targets = _inputs(jcfg)
    with pytest.raises(ValueError, match="loss_chunk"):
        tlm.lm_loss(params_to_torch(jp, "cpu"), tcfg, torch.from_numpy(tokens),
                    torch.from_numpy(targets))


def _saved_sizes(fn):
    """The element counts of every tensor autograd saves for the backward
    while ``fn`` runs (outside checkpointed regions)."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sizes


@pytest.mark.parametrize("loss_chunk", [4, 8])
def test_chunk_logits_are_not_saved_for_the_backward(loss_chunk):
    """No saved tensor has a chunk's B x c x V logits' size: each chunk is
    recomputed in the backward. The vocabulary (100) makes that size unlike
    any other tensor of the tiny LM; the same chunk's loss run outside the
    checkpoint does save it, so the check can see such a tensor."""
    jcfg, tcfg = _configs(loss_chunk=loss_chunk, vocab_size=100)
    jp, tokens, targets = _inputs(jcfg)
    params = params_to_torch(jp, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    logits_size = B * loss_chunk * tcfg.vocab_size
    tk, tg = torch.from_numpy(tokens), torch.from_numpy(targets)
    sizes = _saved_sizes(lambda: tlm.lm_loss(params, tcfg, tk, tg)[0].backward())
    assert sizes and logits_size not in sizes
    x = torch.randn((B, loss_chunk, tcfg.d_model), requires_grad=True)
    control = _saved_sizes(lambda: tlm._chunk_loss(tlm._head_weight(params, tcfg), x,
                                                   tg[:, :loss_chunk]))
    assert logits_size in control


# --------------------------------------------------------------- the cell
def _tiny_arch(micro_batches=None):
    """internlm2-1.8b's ArchSpec in both packages with the tiny LM's widths
    (its head_dim, rope_theta and remat kept), and optionally another
    microbatch count for train_4k."""
    small = dict(_TINY, name=ARCH, head_dim=8, rope_theta=1000000.0, remat="full")
    jarch, tarch = jax_get_arch(ARCH), get_arch(ARCH)
    jarch = dataclasses.replace(jarch, model_cfg=jlm.LMConfig(**small, dtype=jnp.float32))
    tarch = dataclasses.replace(tarch, model_cfg=tlm.LMConfig(**small, dtype=torch.float32))
    if micro_batches is not None:
        jarch = dataclasses.replace(jarch, micro_batches={"train_4k": micro_batches})
        tarch = dataclasses.replace(tarch, micro_batches={"train_4k": micro_batches})
    return jarch, tarch


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("micro_batches,want_m", [(None, 4), (2, 2), (3, 2), (16, 8)])
def test_three_train_cell_steps_match_jax(micro_batches, want_m):
    """Three steps of _lm_train_program on a tiny internlm2 config (8
    sequences of 16 tokens, the config's 4 microbatches or an override)
    against the JAX package's program on a 1 x 1 ("data", "model") mesh."""
    jarch, tarch = _tiny_arch(micro_batches)
    cell = ShapeCell("train_4k", "train", {"seq_len": 16, "global_batch": 8})
    jprog = jax_steps._lm_train_program(jarch, cell, _mesh())
    prog = steps._lm_train_program(tarch, cell, torch.device("cpu"))
    assert prog.static_info == jprog.static_info
    m = prog.static_info["microbatches"]
    assert m == want_m and tuple(prog.args[1].shape) == (m, 8 // m, 16)
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(3), jarch.model_cfg))
    jtx = jax_steps._make_tx(ARCH)
    jstate = jax_steps.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    tp = params_to_torch(jp, "cpu")
    state = steps.TrainState(torch.zeros((), dtype=torch.int32), tp,
                             steps._make_tx(ARCH).init(tp))
    rng = np.random.default_rng(4)
    jstep = jax.jit(jprog.fn)
    for _ in range(3):
        tokens = rng.integers(0, 128, size=(m, 8 // m, 16)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=-1)
        targets[..., -1] = -1
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        state, metrics = prog.fn(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    for got, want, start in zip(tree_leaves(state.params),
                                jax.tree_util.tree_leaves(jax.device_get(jstate.params)),
                                jax.tree_util.tree_leaves(jp)):
        moved = float(np.abs(np.asarray(want) - np.asarray(start)).max())
        assert moved > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3 * moved)


@pytest.mark.parametrize("micro_batches,want", [(None, (4, 64, 4096)), (32, (32, 8, 4096))])
def test_meta_build_matches_jax(micro_batches, want):
    """The full train_4k cell builds on meta tensors (allocating nothing),
    with JAX's input shapes and static_info."""
    prog = steps.build_cell(ARCH, "train_4k", "cpu", micro_batches=micro_batches)
    jarch = jax_get_arch(ARCH)
    if micro_batches is not None:
        jarch = dataclasses.replace(jarch, micro_batches={"train_4k": micro_batches})
    jprog = jax_steps._lm_train_program(jarch, jarch.shapes["train_4k"], _mesh())
    state, tokens, targets = prog.args
    assert prog.kind == "train" and prog.static_info == jprog.static_info
    for t, j in ((tokens, jprog.args[1]), (targets, jprog.args[2])):
        assert t.device.type == "meta" and t.dtype == torch.int32
        assert tuple(t.shape) == tuple(j.shape) == want
    assert all(t.device.type == "meta" for t in tree_leaves(state))
    got_shapes = [tuple(t.shape) for t in tree_leaves(state.params)]
    jax_shapes = [tuple(s.shape) for s in jax.tree_util.tree_leaves(jprog.args[0].params)]
    assert got_shapes == jax_shapes
    assert len(tree_leaves(state.opt)) == len(jax.tree_util.tree_leaves(jprog.args[0].opt))


@pytest.mark.parametrize("arch_id", ["qwen1.5-110b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_qwen_cells_build_on_meta_as_jax(arch_id, shape):
    """The pod-scale qwen archs' LM cells build on meta tensors (allocating
    nothing) with JAX's input shapes and static_info; the train cell's AdamW
    moments are bf16, as JAX's MOMENT_DTYPE gives them."""
    prog = steps.build_cell(arch_id, shape, "cpu")
    jprog = jax_steps.build_cell(arch_id, shape, _mesh())
    assert prog.kind == jprog.kind and prog.static_info == jprog.static_info
    assert all(t.device.type == "meta" for t in tree_leaves(prog.args))
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tree_leaves(prog.args)]
    want = [(tuple(s.shape), np.dtype(s.dtype).name) for s in jax.tree_util.tree_leaves(jprog.args)]
    assert got == want
    if shape == "train_4k":
        moments = tree_leaves([prog.args[0].opt[1].mu, prog.args[0].opt[1].nu])
        assert len(moments) == 2 * len(tree_leaves(prog.args[0].params))
        assert {t.dtype for t in moments} == {torch.bfloat16}


@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "stablelm-3b", "olmoe-1b-7b",
                                     "qwen1.5-110b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("train", [True, False])
def test_lm_flops_equal_jax(arch_id, train):
    cfg, jcfg = get_arch(arch_id).model_cfg, jax_get_arch(arch_id).model_cfg
    assert steps._lm_flops(cfg, 256 * 4096, train=train) == jax_steps._lm_flops(
        jcfg, 256 * 4096, train=train)


def test_train_cell_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell(ARCH, "train_4k")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_lm(get_arch(ARCH).model_cfg, torch.Generator())
