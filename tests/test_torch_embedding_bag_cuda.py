"""The hand-written CUDA embedding_bag kernel against its plain version, on
the card. Marked ``cuda``: without a GPU (and nvcc) every test here skips.

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_embedding_bag_cuda.py

Tolerance: the forward equals the plain version bit for bit, in fp32 and
bf16 alike (the kernel makes the same adds in the same order, in the
table's dtype; ``ref.embedding_bag_error`` also reports the share of a
rounding allowance used, as a diagnostic). The backward within 1e-5 of the
largest |grad|: ``index_add_`` adds each row's gradients with atomics, in an
order that varies.
"""

import pytest
import torch

from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_error, embedding_bag_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bags(dev, v, l, n_bags, seed, dtype=torch.int32):
    g = torch.Generator(device=dev).manual_seed(seed)
    indices = torch.randint(0, v, (l,), generator=g, device=dev).to(dtype)
    bag_ids = torch.sort(torch.randint(0, n_bags, (l,), generator=g, device=dev)).values.to(dtype)
    return indices, bag_ids


def _check(table, indices, bag_ids, n_bags):
    before = ops.embedding_bag.launches
    out = ops.embedding_bag(table, indices, bag_ids, n_bags)
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 1
    assert out.dtype == table.dtype and out.shape == (n_bags, table.shape[1])
    err = embedding_bag_error(out, table, indices, bag_ids, n_bags)
    assert err["equal"], err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [10, 16, 64, 128])
def test_kernel_matches_plain(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(d)
    table = torch.randn((5000, d), generator=g, device=dev).to(dtype)
    indices, bag_ids = _bags(dev, 5000, 20000, 3000, seed=d)
    _check(table, indices, bag_ids, 3000)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 256, 300])
def test_kernel_takes_any_width(dev, d):
    g = torch.Generator(device=dev).manual_seed(d)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((700, d), generator=g, device=dev).to(dtype)
        indices, bag_ids = _bags(dev, 700, 3000, 400, seed=d)
        _check(table, indices, bag_ids, 400)


@pytest.mark.cuda
def test_unaligned_table_view(dev):
    """A view whose base is 4-byte aligned only: narrower loads."""
    table = torch.randn((16 * 1000 + 1,), device=dev)[1:].view(1000, 16)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    indices, bag_ids = _bags(dev, 1000, 4000, 500, seed=1)
    _check(table, indices, bag_ids, 500)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_single_and_whole_bags(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn((300, 16), generator=g, device=dev).to(dtype)
    # bags 0, 2 and 5 empty (5 is the last), 1 and 3 one lookup each
    bag_ids = torch.tensor([1, 3, 4, 4, 4], device=dev)
    indices = torch.tensor([5, 6, 7, 8, 9], device=dev)
    out = _check(table, indices, bag_ids, 6)
    for b in (0, 2, 5):
        assert torch.equal(out[b], torch.zeros_like(out[b]))
    assert torch.equal(out[1], table[5]) and torch.equal(out[3], table[6])
    # every lookup in one bag, between two empty ones
    indices = torch.randint(0, 300, (5000,), generator=g, device=dev)
    out = _check(table, indices, torch.ones(5000, dtype=torch.int64, device=dev), 3)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    # no lookups at all
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    out = _check(table, empty, empty, 4)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_strided_index_views(dev, dtype):
    """Indices and bag ids as column views of (L, 3) tensors: the wrapper
    hands the kernel dense copies."""
    table = torch.randn((3000, 16), device=dev)
    indices, bag_ids = _bags(dev, 3000, 6000, 900, seed=9, dtype=dtype)
    wide_i = torch.stack([indices, indices.flip(0), indices], dim=1)
    wide_b = torch.stack([bag_ids.flip(0), bag_ids, bag_ids], dim=1)
    assert not wide_i[:, 0].is_contiguous() and not wide_b[:, 1].is_contiguous()
    out = _check(table, wide_i[:, 0], wide_b[:, 1], 900)
    assert torch.equal(out, ops.embedding_bag(table, indices, bag_ids, 900))


@pytest.mark.cuda
def test_int64_indices(dev):
    table = torch.randn((2000, 64), device=dev)
    indices, bag_ids = _bags(dev, 2000, 5000, 700, seed=3, dtype=torch.int64)
    out = _check(table, indices, bag_ids, 700)
    assert torch.equal(out, ops.embedding_bag(table, indices.int(), bag_ids.int(), 700))


@pytest.mark.cuda
def test_table_past_two_to_the_31_elements(dev):
    """2^27 x 16 fp32 = 2^31 elements: row offsets need 64 bits."""
    rows = 1 << 27
    table = torch.empty((rows, 16), device=dev)
    table.uniform_(-1, 1)
    g = torch.Generator(device=dev).manual_seed(4)
    indices = torch.randint(rows - 100_000, rows, (50_000,), generator=g, device=dev)
    indices[::7] = torch.randint(0, rows, (indices[::7].numel(),), generator=g, device=dev)
    bag_ids = torch.sort(torch.randint(0, 9000, (50_000,), generator=g, device=dev)).values
    _check(table, indices, bag_ids, 9000)


@pytest.mark.cuda
def test_autograd_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    base = torch.randn((4000, 16), generator=g, device=dev)
    indices, bag_ids = _bags(dev, 4000, 30000, 2000, seed=11)
    w = torch.randn((2000, 16), generator=g, device=dev)
    grads = []
    for fn in (ops.embedding_bag, embedding_bag_ref):
        t = base.clone().requires_grad_(True)
        (fn(t, indices, bag_ids, 2000) * w).sum().backward()
        grads.append(t.grad)
    scale = grads[1].abs().max().item()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    table = torch.randn((100, 16), device=dev)
    indices, bag_ids = _bags(dev, 100, 50, 10, seed=5)
    with pytest.raises(TypeError):
        ops.embedding_bag(table.half(), indices, bag_ids, 10)
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(table.T.contiguous().T, indices, bag_ids, 10)
    with pytest.raises(ValueError):
        ops.embedding_bag(table, indices.cpu(), bag_ids, 10)
