"""The port's mixture-of-experts FFN (models/moe.py) against the JAX
package's, on the same numpy inputs and the same (carried-across) params.

Tolerances: fp32 outputs within rtol 2e-5 / atol 2e-6 and ``moe_aux_loss``
and ``moe_dropped_frac`` within rtol 2e-5 (tests/test_moe_vectorized.py's,
the same arithmetic in another summation order); gradients of
``(y**2).sum() + aux`` within that file's gradient rtol 5e-5, with an atol
of 1e-6 of each leaf's largest |g|. In bf16 the two packages route alike
(the router is fp32 on the same bf16 tokens) but round differently: XLA
fuses the SwiGLU and rounds it once, torch rounds silu(gate) and the
product apart. Over 6 seeds and the three branches each package's output
lay 2^-8 to 2^-7.5 of the mean |y| from the fp32 output of the same
routing (mean |difference|), and the two 2^-9 to 2^-8 from each other, at
most 2^-7 of the largest |y| in one element. Held: the mean |difference|
within 2^-7 of the mean |y|, each element within 2^-6 of the largest |y|,
and the port's mean error from the fp32 output at most 1.25 times JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.compat import params_to_torch
from repro_torch.models import moe as tmoe

D, E, K, F_, G = 16, 8, 2, 32, 16
BRANCHES = {"one_group": (G, True), "vectorized": (4 * G, True), "scan": (4 * G, False)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs a worker per core, and
    torch's intra-op threads on top of them slowed this file's many small
    CPU ops tenfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(g=G, capacity_factor=1.25, normalize_top_k=True, vectorize_groups=True):
    kw = dict(n_experts=E, top_k=K, d_expert=F_, group_size=g, capacity_factor=capacity_factor,
              normalize_top_k=normalize_top_k, vectorize_groups=vectorize_groups)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _params(jcfg, seed=0):
    """One layer of JAX's init_moe and the port's copy."""
    jp = jax.device_get(jax.tree_util.tree_map(
        lambda p: p[0], jmoe.init_moe(jax.random.PRNGKey(seed), D, jcfg, 1)))
    return jp, params_to_torch(jp, "cpu")


def _x(t, seed=1):
    return np.random.default_rng(seed).normal(size=(t, D)).astype(np.float32)


def _close(got, want, rtol=2e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _bf16_close(y, jy, exact):
    """The module docstring's bf16 tolerance; ``exact``: the port's fp32
    output of the same bf16 tokens."""
    got, want, exact = y.float().numpy(), np.asarray(jy, np.float32), exact.numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -6 * np.abs(want).max(), diff.max()
    assert diff.mean() <= 2.0 ** -7 * np.abs(want).mean(), diff.mean()
    assert np.abs(got - exact).mean() <= 1.25 * np.abs(want - exact).mean()


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_moe_ffn_matches_jax(branch, capacity_factor, normalize):
    t, vec = BRANCHES[branch]
    jcfg, cfg = _configs(capacity_factor=capacity_factor, normalize_top_k=normalize,
                         vectorize_groups=vec)
    jp, tp = _params(jcfg, seed=3)
    x = _x(t, seed=4)
    jy, jm = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    y, m = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert y.shape == (t, D) and y.dtype == torch.float32
    _close(y.numpy(), jy)
    for key in ("moe_aux_loss", "moe_dropped_frac"):
        _close(m[key].numpy(), jm[key], atol=0)
    if capacity_factor < 1:
        assert float(m["moe_dropped_frac"]) > 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_moe_ffn_gradients_match_jax(branch, capacity_factor):
    """d/dx and d/dparams of (y**2).sum() + moe_aux_loss, each leaf within
    rtol 5e-5 and 1e-6 of its largest |g|."""
    t, vec = BRANCHES[branch]
    jcfg, cfg = _configs(capacity_factor=capacity_factor, vectorize_groups=vec)
    jp, tp = _params(jcfg, seed=5)
    x = _x(t, seed=6)

    def jloss(params, x):
        y, m = jmoe.moe_ffn(params, x, jcfg)
        return (y ** 2).sum() + m["moe_aux_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, m = tmoe.moe_ffn(leaves, xt, cfg)
    ((y ** 2).sum() + m["moe_aux_loss"]).backward()
    got = {"x": xt.grad, **{k: v.grad for k, v in leaves.items()}}
    want = {"x": jgx, **jgp}
    assert sorted(got) == sorted(want) == ["router", "w_down", "w_gate", "w_up", "x"]
    for name, g in got.items():
        w = np.asarray(want[name])
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_moe_ffn_bf16_matches_jax(branch, capacity_factor):
    """bf16 tokens, fp32 params cast in both packages: the same routing
    (dropped share and aux to rtol 2e-5), outputs within the module
    docstring's bf16 tolerance."""
    t, vec = BRANCHES[branch]
    jcfg, cfg = _configs(capacity_factor=capacity_factor, vectorize_groups=vec)
    jp, tp = _params(jcfg, seed=7)
    x = _x(t, seed=8)
    jy, jm = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    y, m = tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    _bf16_close(y, jy, tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16).float(), cfg)[0])
    for key in ("moe_aux_loss", "moe_dropped_frac"):
        _close(m[key].numpy(), jm[key], atol=0)


def test_dispatch_slots_past_256_in_bf16():
    """A bf16 group whose capacity passes 256 (the twin of a dropless
    config) with tokens alike enough that one expert takes more than 256:
    every slot index is exact, so no two tokens share a slot and the
    output is JAX's within bf16."""
    g = 512
    jcfg, cfg = _configs(g=g, capacity_factor=E / K)
    assert tmoe._capacity(g, cfg) == g
    jp, tp = _params(jcfg, seed=9)
    x = (0.1 * _x(g, seed=10) + _x(1, seed=13)).astype(np.float32)
    jy, jm = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    y, m = tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert float(m["moe_dropped_frac"]) == float(jm["moe_dropped_frac"]) == 0.0
    _bf16_close(y, jy, tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16).float(), cfg)[0])
    # each kept (token, expert) pair has a slot of its own
    _, disp, _, mask, keep = (a[0] for a in tmoe._route(
        tp["router"], torch.from_numpy(x).to(torch.bfloat16)[None], cfg, g))
    assert int(keep.sum(0).max()) > 256
    torch.testing.assert_close(disp.float().sum(-1), keep, rtol=0, atol=0)
    assert int(disp.float().sum(0).max()) == 1


@pytest.mark.parametrize("t", [24, 40])
def test_uneven_groups_raise(t):
    _, cfg = _configs()
    _, tp = _params(_configs()[0])
    with pytest.raises(ValueError, match="not divisible by group size 16"):
        tmoe.moe_ffn(tp, torch.zeros((t, D)), cfg)


@pytest.mark.parametrize("b", [1, 2, K, 4 * K])
def test_decode_groups_drop_nothing_up_to_top_k(b):
    """A decode step's B tokens are one group of B: at B <= top_k the
    capacity, max(int(B k cf / E), k) = k, holds every token, so nothing
    is dropped; past it a capacity of k may drop (JAX's rule, held equal)."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=11)
    x = _x(b, seed=12)
    y, m = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    jy, jm = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    _close(y.numpy(), jy)
    _close(m["moe_dropped_frac"].numpy(), jm["moe_dropped_frac"], atol=0)
    assert tmoe._capacity(b, cfg) == max(int(b * K * 1.25 / E), K)
    if b <= K:
        assert float(m["moe_dropped_frac"]) == 0.0


def test_init_moe_shapes_and_devices():
    _, cfg = _configs()
    params = tmoe.init_moe(torch.Generator().manual_seed(0), D, cfg, 3, device="cpu")
    jparams = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), D, _configs()[0], 3))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    # normal over sqrt(fan in): w_down's fan in is d_expert
    assert abs(params["w_down"].std().item() * F_ ** 0.5 - 1) < 0.05
    meta = tmoe.init_moe(torch.Generator(), D, cfg, 3, torch.bfloat16, device="meta")
    assert all(v.device.type == "meta" and v.dtype == torch.bfloat16 for v in meta.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmoe.init_moe(torch.Generator(), D, cfg, 3)
