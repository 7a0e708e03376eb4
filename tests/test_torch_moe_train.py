"""The port's MoE training (launch/steps.py's ``_lm_train_program`` on an MoE
arch, with ``_make_tx``'s per-arch moment dtype) against the JAX package's,
on tiny MoE LMs (2 layers, d_model 32, 8 experts, top 2, d_expert 16,
groups of 16), the same numpy inputs and the same (carried-across) params,
in fp32, on a 1 x 1 ("data", "model") mesh on the JAX side.

- Three steps of the olmoe-1b-7b train cell (8 sequences of 16 tokens, the
  config's 4 microbatches: 2 groups a microbatch) at capacity factor 1.25
  (groups drop) and 4.0 (capacity = group: none drop), in the vectorised
  and the group-loop branch. The step's gradient is that of the token loss
  plus ``moe_aux``. Losses to 1e-5 relative; params to 1e-5 relative plus
  1e-3 of the largest move, as tests/test_torch_lm_train.py holds the
  dense cell (an AdamW step divides m by sqrt(v), so an element whose
  gradient is near 0 moves by up to lr either way).
- Three steps of the qwen3-moe-235b-a22b train cell (GQA 4 : 1, a tiny
  width, the config's 16 microbatches capped at the batch: 8 of one
  sequence, one group each) through ``_make_tx("qwen3-moe-235b-a22b")``: bf16 moments in both
  packages, fp32 arithmetic rounded on store. The two packages' gradients
  differ in their last fp32 bits, and where such a moment lies at a bf16
  rounding boundary the two store neighbouring bf16 values: one bf16 ulp,
  up to 2^-7 of m (and 2^-8 of sqrt(v)), moves that element's step by up
  to 1.2% of lr. Over three steps the params are held to 1e-5 relative
  plus 2^-6 of the largest move; the losses to 1e-5 relative.
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
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

_TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=128,
             head_dim=8, q_chunk=8, kv_chunk=8, loss_chunk=8, remat="full")
_MOE = dict(n_experts=8, top_k=2, d_expert=16, group_size=16)
CELL = ShapeCell("train_4k", "train", {"seq_len": 16, "global_batch": 8})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_arch(arch_id, moe=None, **kw):
    """``arch_id``'s ArchSpec in both packages with the tiny MoE LM's widths
    (the arch's rope_theta kept) and its fp32 compute."""
    jarch, tarch = jax_get_arch(arch_id), get_arch(arch_id)
    small = dict(_TINY, name=arch_id, rope_theta=tarch.model_cfg.rope_theta, **kw)
    m = {**_MOE, **(moe or {})}
    jcfg = jlm.LMConfig(**small, dtype=jnp.float32, moe=jmoe.MoEConfig(**m))
    tcfg = tlm.LMConfig(**small, dtype=torch.float32, moe=tmoe.MoEConfig(**m))
    return (dataclasses.replace(jarch, model_cfg=jcfg),
            dataclasses.replace(tarch, model_cfg=tcfg))


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _three_steps(jarch, tarch):
    """Three steps of the train cell in both packages from the same params
    and batches -> (port state, JAX state, the JAX params at the start)."""
    jprog = jax_steps._lm_train_program(jarch, CELL, _mesh())
    prog = steps._lm_train_program(tarch, CELL, torch.device("cpu"))
    assert prog.static_info == jprog.static_info
    m = prog.static_info["microbatches"]
    assert m == min(tarch.micro_batch("train_4k"), 8)
    assert tuple(prog.args[1].shape) == (m, 8 // m, 16)
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(3), jarch.model_cfg))
    jtx = jax_steps._make_tx(jarch.arch_id)
    jstate = jax_steps.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    tp = params_to_torch(jp, "cpu")
    state = steps.TrainState(torch.zeros((), dtype=torch.int32), tp,
                             steps._make_tx(tarch.arch_id).init(tp))
    rng = np.random.default_rng(4)
    jstep = jax.jit(jprog.fn)
    for _ in range(3):
        tokens = rng.integers(0, 128, size=(m, 8 // m, 16)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=-1)
        targets[..., -1] = -1
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        state, metrics = prog.fn(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        assert sorted(metrics) == sorted(jm) == ["loss"]
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    return state, jstate, jp


def _hold_params(state, jstate, jp, move_share):
    for got, want, start in zip(tree_leaves(state.params),
                                jax.tree_util.tree_leaves(jax.device_get(jstate.params)),
                                jax.tree_util.tree_leaves(jp)):
        moved = float(np.abs(np.asarray(want) - np.asarray(start)).max())
        assert moved > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=move_share * moved)


def _dropped(tarch, tp, tokens):
    """The first layer's dropped share on the normed embeddings of tokens."""
    cfg = tarch.model_cfg
    y = tlm.L.rms_norm(tp["layers"]["ln2"][0], tp["embed"][torch.from_numpy(tokens)])
    _, m = tmoe.moe_ffn({k: v[0] for k, v in tp["layers"]["ffn"].items()},
                        y.reshape(-1, cfg.d_model), cfg.moe)
    return float(m["moe_dropped_frac"])


@pytest.mark.parametrize("vectorize", [True, False], ids=["vectorized", "scan"])
@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True), (4.0, False)],
                         ids=["dropping", "dropless"])
def test_three_olmoe_train_cell_steps_match_jax(capacity_factor, drops, vectorize):
    jarch, tarch = _tiny_arch("olmoe-1b-7b", {"capacity_factor": capacity_factor,
                                              "vectorize_groups": vectorize})
    tokens = np.random.default_rng(4).integers(0, 128, size=(2, 16)).astype(np.int32)
    jp = jax.device_get(jlm.init_lm(jax.random.PRNGKey(3), jarch.model_cfg))
    # the capacity factor decides whether the first microbatch's groups drop
    assert (_dropped(tarch, params_to_torch(jp, "cpu"), tokens) > 0) is drops
    state, jstate, jp = _three_steps(jarch, tarch)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.opt[1].mu))
    _hold_params(state, jstate, jp, 1e-3)


def test_three_qwen3_moe_train_cell_steps_with_bf16_moments_match_jax():
    jarch, tarch = _tiny_arch("qwen3-moe-235b-a22b", n_kv_heads=1)
    assert steps.MOMENT_DTYPE[tarch.arch_id] == torch.bfloat16
    state, jstate, jp = _three_steps(jarch, tarch)
    opt, jopt = state.opt[1], jstate.opt[1]
    for moments, jmoments in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        assert {t.dtype for t in tree_leaves(moments)} == {torch.bfloat16}
        assert {x.dtype for x in jax.tree_util.tree_leaves(jmoments)} == {jnp.dtype(jnp.bfloat16)}
    _hold_params(state, jstate, jp, 2 ** -6)
