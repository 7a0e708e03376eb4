"""The port's optimizer (optim/adamw.py, optim/schedules.py) against the JAX
package's hand-written one, update for update on the same numpy gradients.

Tolerance: fp32, rtol 1e-6 and atol 1e-9 on params, moments and schedules:
the same elementwise arithmetic in the same order; the only differences are
the last bit of fp32 ``pow``/``sqrt``/``cos`` between the two libraries and
the order of the global norm's sum (ROADMAP Queue C); schedules to atol
1e-9 (an fp32 cos near its zero). bf16 moments: compared
after the same rounding, within one bf16 ulp (2^-8 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.compat import params_to_numpy, params_to_torch

# the modules (each package's optim/__init__ re-exports functions of these names)
jadamw = importlib.import_module("repro.optim.adamw")
jsched = importlib.import_module("repro.optim.schedules")
tadamw = importlib.import_module("repro_torch.optim.adamw")
tsched = importlib.import_module("repro_torch.optim.schedules")

RTOL, ATOL = 1e-6, 1e-9


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "query": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                  "b": rng.normal(size=(3,)).astype(np.float32)},
        "passage": {"w": rng.normal(size=(4,)).astype(np.float32)},
    }


def _grads(step, params):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)


def _run(make_j, make_t, steps=6, rtol=RTOL, atol=ATOL):
    params = _params()
    jtx, ttx = make_j(), make_t()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_to_torch(params, "cpu")
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(steps):
        g = _grads(step, params)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jadamw.apply_updates(jp, ju)
        tu, ts = ttx.update(params_to_torch(g, "cpu"), ts, tp)
        tp = tadamw.apply_updates(tp, tu)
        got, want = params_to_numpy(tp), jax.device_get(jp)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=rtol, atol=atol), got, want)
    return js, ts


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _torch_leaves(tree):
    from repro_torch.common.treemath import tree_leaves

    return [x.float().numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_chain_with_clip_matches_jax_update_for_update(weight_decay):
    sched = dict(peak_lr=0.05, warmup_steps=2, total_steps=8)
    js, ts = _run(
        lambda: jadamw.chain(jadamw.clip_by_global_norm(2.0), jadamw.adamw(
            jsched.linear_warmup_linear_decay(**sched), weight_decay=weight_decay)),
        lambda: tadamw.chain(tadamw.clip_by_global_norm(2.0), tadamw.adamw(
            tsched.linear_warmup_linear_decay(**sched), weight_decay=weight_decay)),
    )
    assert int(ts[1].count) == int(js[1].count) == 6
    for a, b in zip(_torch_leaves(ts[1].mu) + _torch_leaves(ts[1].nu),
                    _leaves(js[1].mu) + _leaves(js[1].nu)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)


def test_adamw_decay_mask_matches_jax():
    def mask(params):
        return {"query": {"w": True, "b": False}, "passage": {"w": True}}

    _run(lambda: jadamw.adamw(0.01, weight_decay=0.1, mask=mask),
         lambda: tadamw.adamw(0.01, weight_decay=0.1, mask=mask))


def test_adamw_bf16_moments_match_jax():
    js, ts = _run(lambda: jadamw.adamw(0.01, moment_dtype=jnp.bfloat16),
                  lambda: tadamw.adamw(0.01, moment_dtype=torch.bfloat16), rtol=1e-5, atol=1e-7)
    for a, b in zip(_torch_leaves(ts.mu), _leaves(js.mu)):
        assert ts.mu["query"]["w"].dtype == torch.bfloat16
        np.testing.assert_allclose(a, b, rtol=2 ** -8, atol=1e-9)


def test_adamw_keep_master_params_matches_jax():
    """bf16 params with fp32 masters in the state: the params are re-rounded
    from the masters every step, in both packages."""
    params = _params(1)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    tp = {k: {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in v.items()}
          for k, v in params.items()}
    jtx = jadamw.adamw(0.01, keep_master_params=True, weight_decay=0.01)
    ttx = tadamw.adamw(0.01, keep_master_params=True, weight_decay=0.01)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = _grads(step, params)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jadamw.apply_updates(jp, ju)
        tu, ts = ttx.update(params_to_torch(g, "cpu"), ts, tp)
        tp = tadamw.apply_updates(tp, tu)
        for a, b in zip(_torch_leaves(ts.master), _leaves(js.master)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        for a, b in zip(_torch_leaves(tp), _leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=2 ** -8, atol=0)
    assert tp["query"]["w"].dtype == torch.bfloat16


def test_sgd_and_clip_alone_match_jax():
    _run(lambda: jadamw.sgd(0.1), lambda: tadamw.sgd(0.1))
    _run(lambda: jadamw.chain(jadamw.clip_by_global_norm(0.5), jadamw.sgd(jsched.constant_schedule(0.1))),
         lambda: tadamw.chain(tadamw.clip_by_global_norm(0.5), tadamw.sgd(tsched.constant_schedule(0.1))))


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (0.3,)),
    ("linear_warmup_linear_decay", (2e-5, 10, 100)),
    ("linear_warmup_linear_decay", (1e-3, 0, 5)),
    ("cosine_decay", (1e-3, 5, 50)),
    ("cosine_decay", (1e-3, 5, 50, 0.1)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in [0, 1, 3, 5, 9, 10, 11, 49, 50, 99, 100, 150]:
        np.testing.assert_allclose(float(tf(torch.tensor(step, dtype=torch.int32))),
                                   float(jf(jnp.asarray(step, jnp.int32))), rtol=RTOL, atol=1e-9)


def test_treemath_matches_jax():
    """The tree helpers the optimizer and the metrics use; the global norm
    squares bf16 leaves in fp32."""
    from repro.common import treemath as jtm
    from repro_torch.common import treemath as ttm

    params = _params(2)
    params["passage"]["h"] = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    tp, jp = params_to_torch(params, "cpu"), jax.tree_util.tree_map(jnp.asarray, params)
    for got, want in (
        (ttm.tree_add(tp, tp), jtm.tree_add(jp, jp)),
        (ttm.tree_scale(tp, 0.25), jtm.tree_scale(jp, 0.25)),
        (ttm.tree_zeros_like(tp), jtm.tree_zeros_like(jp)),
    ):
        for a, b in zip(_torch_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    bf = ttm.tree_cast(tp, torch.bfloat16)
    assert bf["query"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(ttm.tree_global_norm(bf)),
                               float(jtm.tree_global_norm(jtm.tree_cast(jp, jnp.bfloat16))),
                               rtol=1e-6)
    assert float(ttm.tree_global_norm({})) == 0.0
