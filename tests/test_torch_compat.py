"""compat.py carries JAX params into the port and back bit for bit, and the
port's own init gives the same tree (keys, shapes, dtypes) as the JAX one."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.launch.train import tiny_bert as jax_tiny_bert
from repro.models.towers import make_bert_dual_encoder as jax_dual_encoder
from repro_torch.compat import params_to_numpy, params_to_torch
from repro_torch.launch.serve import tiny_bert
from repro_torch.models.towers import make_bert_dual_encoder


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("shared", [False, True])
def test_jax_params_round_trip_bit_exact(shared):
    params = jax.device_get(
        jax_dual_encoder(jax_tiny_bert(), shared=shared).init(jax.random.PRNGKey(3))
    )
    back = params_to_numpy(params_to_torch(params, "cpu"))
    a, b = list(_leaves(params)), list(_leaves(back))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), key


@pytest.mark.parametrize("dtype", ["int32", "bool", "bfloat16"])
def test_round_trip_keeps_other_dtypes(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)) * 100
    x = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x.astype(dtype)
    t = params_to_torch({"a": {"b": x}}, "cpu")["a"]["b"]
    y = params_to_numpy({"a": {"b": t}})["a"]["b"]
    assert y.dtype == x.dtype
    assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


def test_port_init_has_the_jax_layout():
    jax_params = jax.device_get(jax_dual_encoder(jax_tiny_bert()).init(jax.random.PRNGKey(0)))
    port = make_bert_dual_encoder(tiny_bert()).init(torch.Generator().manual_seed(0), "cpu")
    a = [(k, v.shape, str(v.dtype)) for k, v in _leaves(jax_params)]
    b = [(k, tuple(v.shape), str(params_to_numpy(v).dtype)) for k, v in _leaves(port)]
    assert a == b
