"""The port's embedding_bag op on CPU tensors (its plain version, ref.py,
and the autograd Function around it) against the JAX package's op (the
Pallas kernel in interpret mode, as the JAX tests run it off-TPU) and its
``embedding_bag_ref``, on the same numpy inputs: the sweep, grad-scatter and
empty-bag cases of ``tests/test_kernels.py``.

Tolerances are the JAX tests': 1e-6 for fp32 sums (the same adds, in lookup
order on both sides), 2e-2 for bf16 (both round after every add, the JAX
reference through segment_sum's own order), 1e-5 for gradients (a
scatter-add of the same cotangent rows).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_embedding_bag_ref
from repro_torch.core.precision import tensor_to_numpy
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_error, embedding_bag_ref

SWEEP = [(64, 128, 32, 8), (256, 128, 100, 10), (1000, 256, 17, 5)]


def _inputs(v, d, l, n_bags, seed, bf16=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(ml_dtypes.bfloat16 if bf16 else np.float32)
    indices = rng.integers(0, v, l).astype(np.int32)
    bag_ids = np.sort(rng.integers(0, n_bags, l)).astype(np.int32)
    return table, indices, bag_ids


def _torch(*arrays):
    out = []
    for a in arrays:
        if a.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a.copy()))
    return out


@pytest.mark.parametrize("v,d,l,n_bags", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_kernel(v, d, l, n_bags, dtype):
    table, indices, bag_ids = _inputs(v, d, l, n_bags, v + l, bf16=dtype == "bfloat16")
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(indices), jnp.asarray(bag_ids),
                             n_bags, True)
    got = ops.embedding_bag(*_torch(table, indices, bag_ids), n_bags)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tensor_to_numpy(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("v,d,l,n_bags", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(v, d, l, n_bags, dtype):
    table, indices, bag_ids = _inputs(v, d, l, n_bags, v * l, bf16=dtype == "bfloat16")
    want = jax_embedding_bag_ref(jnp.asarray(table), jnp.asarray(indices), jnp.asarray(bag_ids),
                                 n_bags)
    got = embedding_bag_ref(*_torch(table, indices, bag_ids), n_bags)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tensor_to_numpy(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_ref_takes_any_bag_order_as_segment_sum():
    table, indices, bag_ids = _inputs(300, 16, 200, 40, 9)
    perm = np.random.default_rng(1).permutation(200)
    indices, bag_ids = indices[perm], bag_ids[perm]
    want = jax_embedding_bag_ref(jnp.asarray(table), jnp.asarray(indices), jnp.asarray(bag_ids), 40)
    got = embedding_bag_ref(*_torch(table, indices, bag_ids), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ref_sums_each_bag_in_lookup_order_in_the_table_dtype():
    """bf16 rounds after every add, in lookup order: 256 + 1 + 1 stays 256,
    while 1 + 1 + 256 is 258."""
    table = torch.tensor([[256.0], [1.0]], dtype=torch.bfloat16)
    out = embedding_bag_ref(table, torch.tensor([0, 1, 1, 1, 1, 0]), torch.tensor([0, 0, 0, 1, 1, 1]), 2)
    assert out[:, 0].tolist() == [256.0, 258.0]


def test_grad_scatter_matches_jax():
    table, indices, bag_ids = _inputs(32, 128, 16, 4, 21)

    def f_kernel(t):
        return (jax_embedding_bag(t, jnp.asarray(indices), jnp.asarray(bag_ids), 4, True) ** 2).sum()

    want = jax.grad(f_kernel)(jnp.asarray(table))
    t, idx, bags = _torch(table, indices, bag_ids)
    t.requires_grad_(True)
    (ops.embedding_bag(t, idx, bags, 4) ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_grad_matches_the_plain_versions_autograd():
    table, indices, bag_ids = _inputs(50, 8, 300, 30, 2)
    w = torch.randn(30, 8, generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in (ops.embedding_bag, embedding_bag_ref):
        t, idx, bags = _torch(table, indices, bag_ids)
        t.requires_grad_(True)
        (fn(t, idx, bags, 30) * w).sum().backward()
        grads.append(t.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def test_empty_bags_are_zero_as_in_jax():
    table = np.ones((8, 128), np.float32)
    indices, bag_ids = np.array([0, 1], np.int32), np.array([0, 3], np.int32)
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(indices), jnp.asarray(bag_ids), 4, True)
    got = ops.embedding_bag(*_torch(table, indices, bag_ids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got[1], torch.zeros(128)) and torch.equal(got[2], torch.zeros(128))


def test_int64_ids_are_cast_and_take_no_gradient():
    table, indices, bag_ids = _inputs(40, 4, 60, 7, 5)
    t, idx, bags = _torch(table, indices, bag_ids)
    a = ops.embedding_bag(t, idx.long(), bags.long(), 7)
    assert torch.equal(a, ops.embedding_bag(t, idx, bags, 7))
    t.requires_grad_(True)
    ops.embedding_bag(t, idx.long(), bags.long(), 7).sum().backward()
    assert t.grad.shape == t.shape


def test_error_check_scales_with_the_bags():
    table, indices, bag_ids = _inputs(100, 4, 400, 20, 3)
    t, idx, bags = _torch(table, indices, bag_ids)
    out = embedding_bag_ref(t, idx, bags, 20)
    assert embedding_bag_error(out, t, idx, bags, 20) == {"max_abs_err": 0.0, "equal": True,
                                                         "worst": 0.0}
    err = embedding_bag_error(out + 1e-3, t, idx, bags, 20)
    assert not err["equal"] and err["worst"] > 1.0            # fp32: 1e-6 of sum |row|
    bt = t.bfloat16()
    out = embedding_bag_ref(bt, idx, bags, 20).float()
    # one bf16 ulp of a bag's sum is within 2^-8 n_bag sum|row|
    bumped = out + out.abs() * 2.0 ** -8
    assert embedding_bag_error(bumped.bfloat16(), bt, idx, bags, 20)["worst"] <= 1.0


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "shape", "n_bags", "strided"])
def test_wrapper_rejects_bad_input(bad):
    table = torch.randn(10, 4)
    idx, bags = torch.tensor([1, 2, 3]), torch.tensor([0, 0, 1])
    n = 2
    if bad == "dtype":
        table = table.half()
    elif bad == "index_dtype":
        idx = idx.float()
    elif bad == "shape":
        bags = bags[:2]
    elif bad == "n_bags":
        n = -1
    else:
        table = table.T.contiguous().T
    with pytest.raises((ValueError, TypeError)):
        ops.embedding_bag(table, idx, bags, n)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    table, indices, bag_ids = _inputs(30, 6, 50, 9, 4)
    before = ops.embedding_bag.launches
    got = ops.embedding_bag(*_torch(table, indices, bag_ids), 9)
    assert torch.equal(got, embedding_bag_ref(*_torch(table, indices, bag_ids), 9))
    assert ops.embedding_bag.launches == before
