"""The hand-written CUDA fused_topk kernel against its plain version, on the
card. Marked ``cuda``: without a GPU (and nvcc) every test here skips.

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_fused_topk_cuda.py

Tolerance: the kernel and the reference both accumulate exact products of
the inputs in fp32, in another order, so scores agree to 1e-4 of the score
scale; ids agree at every slot whose reference score is clear of its
neighbours by more than twice that (at least half the slots are, so the id
check is not vacuous), and exactly wherever the data are small
integers (exact sums, so ties are real ties and go to the lowest id).
"""

import pytest
import torch

from repro_torch.core.precision import NEG_INF
from repro_torch.kernels.fused_topk import ops
from repro_torch.kernels.fused_topk.ref import topk_mismatch, topk_scores_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _check(q, p, k, col_valid=None, exact=False):
    before = ops.fused_topk.launches
    s, i = ops.fused_topk(q, p, k, col_valid=col_valid)
    torch.cuda.synchronize()
    assert ops.fused_topk.launches == before + 1
    rs, ri = topk_scores_ref(q, p, k + 1, col_valid=col_valid)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert s.shape == i.shape == (q.shape[0], k)
    if exact:
        assert torch.equal(i, ri[:, :k])
        assert torch.equal(s, rs[:, :k])
        return
    atol = 1e-4 * max(1.0, rs[rs > NEG_INF / 2].abs().max().item())
    err, bad, clear = topk_mismatch(s, i, rs, ri, atol)
    assert err <= atol, (err, atol)
    assert bad == 0
    assert clear >= i.numel() // 2, (clear, i.numel())    # the id check compared ids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n,d,k", [
    (70, 1000, 96, 10),      # ragged Q and N, vector loads
    (1, 129, 768, 100),      # one query, N one past a tile, d=768
    (65, 777, 20, 128),      # d not a multiple of 8: scalar loads, k at the shared limit
    (5, 300_000, 64, 100),   # many column splits merged in pass 2
    (3, 50, 33, 1),
])
def test_kernel_matches_plain(dev, dtype, n_q, n, d, k):
    q = _rand((n_q, d), dtype, dev, 0)
    p = _rand((n, d), dtype, dev, 1)
    _check(q, p, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_masked_columns(dev, dtype):
    q = _rand((40, 64), dtype, dev, 2)
    p = _rand((5000, 64), dtype, dev, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    valid = torch.rand(5000, generator=g, device=dev) > 0.3
    _check(q, p, 50, col_valid=valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ties_go_to_lowest_id(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    base = torch.randint(-3, 4, (40, 32), generator=g, device=dev)
    p = base[torch.randint(0, 40, (3000,), generator=g, device=dev)].to(dtype)
    q = torch.randint(-3, 4, (33, 32), generator=g, device=dev).to(dtype)
    _check(q, p, 100, exact=True)


def _small_ints(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-3, 4, shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n,d,k", [
    (70, 3000, 96, 129),      # one past the shared-memory k
    (130, 5000, 768, 256),    # three query tiles, d=768
    (9, 2000, 20, 513),       # scalar loads, kp = 1024
])
def test_kernel_large_k_matches_plain(dev, dtype, n_q, n, d, k):
    q = _rand((n_q, d), dtype, dev, 10)
    p = _rand((n, d), dtype, dev, 11)
    _check(q, p, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_large_k_many_splits_exact(dev, dtype):
    """k = 1000 over 300k columns (many column splits, row states in global
    memory) on small integers: exact sums, real ties, so every slot must
    equal the plain version's (at this density random scores leave too few
    slots clear of their neighbours for the tolerance check)."""
    q = _small_ints((5, 64), dtype, dev, 15)
    p = _small_ints((300_000, 64), dtype, dev, 16)
    _check(q, p, 1000, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n,d,k", [
    (9, 6000, 64, 1025),      # kp = 2048: bitonic stages on the global states
    (70, 9000, 48, 4096),     # kp = 4096, two query tiles
    (5, 3000, 32, 3500),      # k > N, kp = 4096: the slots past N are empty
])
def test_kernel_k_past_shared_staging_exact(dev, dtype, n_q, n, d, k):
    """k past 1024, where a full offer buffer is sorted in the global row
    state itself, on small integers (exact sums): every slot must equal the
    plain version's, empty ones (-1e30, -1)."""
    q = _small_ints((n_q, d), dtype, dev, 20)
    p = _small_ints((n, d), dtype, dev, 21)
    _check(q, p, k, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k,max_splits", [(1000, 1), (1500, 1), (1500, 2), (4096, 3)])
def test_kernel_state_bytes_limits_the_splits(dev, monkeypatch, k, max_splits):
    """A STATE_BYTES that holds only ``max_splits`` splits' row states: the
    split plan is cut to it, and each split then sees many more columns than
    kp, so its offer buffer fills and is sorted again and again (in shared
    staging at kp = 1024, in the global state past it)."""
    q = _small_ints((20, 32), torch.float32, dev, 22)
    p = _small_ints((20_000, 32), torch.float32, dev, 23)
    kp = ops.state_pairs(k)
    monkeypatch.setattr(ops, "STATE_BYTES", max_splits * ops.BLOCK_Q * 2 * kp * 8)
    plans = []
    real_plan = ops.split_plan

    def plan(*args):
        plans.append(real_plan(*args))
        return plans[-1]

    monkeypatch.setattr(ops, "split_plan", plan)
    _check(q, p, k, exact=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plans[0][0] == max_splits < real_plan(20, 20_000, sms)[0]
    assert plans[0][1] > kp            # each split's columns overflow its buffer


@pytest.mark.cuda
def test_kernel_large_k_masked_ties_and_past_n(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    q = _rand((40, 64), torch.bfloat16, dev, 13)
    p = _rand((2000, 64), torch.bfloat16, dev, 14)
    valid = torch.rand(2000, generator=g, device=dev) > 0.3
    _check(q, p, 300, col_valid=valid)
    base = torch.randint(-3, 4, (40, 32), generator=g, device=dev)
    p = base[torch.randint(0, 40, (3000,), generator=g, device=dev)].float()
    q = torch.randint(-3, 4, (33, 32), generator=g, device=dev).float()
    _check(q, p, 300, exact=True)
    s, i = ops.fused_topk(q, p[:200], 300)             # k > N
    assert torch.equal(i[:, 200:], torch.full_like(i[:, 200:], -1))
    assert torch.equal(s[:, 200:], torch.full_like(s[:, 200:], NEG_INF))


@pytest.mark.cuda
def test_kernel_k_exceeds_valid_columns(dev):
    q = _rand((9, 64), torch.bfloat16, dev, 6)
    p = _rand((300, 64), torch.bfloat16, dev, 7)
    valid = torch.zeros(300, dtype=torch.bool, device=dev)
    valid[::7] = True                                  # 43 valid columns
    s, i = ops.fused_topk(q, p, 100, col_valid=valid)
    rs, ri = topk_scores_ref(q, p, 101, col_valid=valid)
    assert torch.equal(i[:, 43:], torch.full_like(i[:, 43:], -1))
    assert torch.equal(s[:, 43:], torch.full_like(s[:, 43:], NEG_INF))
    err, bad, clear = topk_mismatch(s, i, rs, ri, 1e-3)
    assert err <= 1e-3 and bad == 0 and clear >= i.numel() // 2
    small_s, small_i = ops.fused_topk(q, p[:20], 30)   # k > N
    assert torch.equal(small_i[:, 20:], torch.full_like(small_i[:, 20:], -1))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    q = _rand((4, 64), torch.bfloat16, dev, 8)
    p = _rand((100, 64), torch.bfloat16, dev, 9)
    with pytest.raises(ValueError, match="k <="):
        ops.fused_topk(q, p, ops.K_MAX + 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_topk(q, p.T.contiguous().T, 5)
    with pytest.raises(TypeError):
        ops.fused_topk(q.half(), p, 5)
