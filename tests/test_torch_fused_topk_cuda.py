"""The hand-written CUDA fused_topk kernels against their plain version, on
the card: bf16 through the Hopper kernel (TMA ring, wgmma scores, selection
from registers; ``ops.fused_topk.paths["hopper"]``), fp32 through the
CUDA-core kernel. Marked ``cuda``: without a GPU (and nvcc) every test here
skips.

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


def _check(q, p, k, col_valid=None, exact=False, inv_tau=1.0):
    before, paths = ops.fused_topk.launches, dict(ops.fused_topk.paths)
    s, i = ops.fused_topk(q, p, k, col_valid=col_valid, inv_tau=inv_tau)
    torch.cuda.synchronize()
    assert ops.fused_topk.launches == before + 1
    path = ops.path_of(torch.promote_types(q.dtype, p.dtype), q.shape[1], k)
    assert ops.fused_topk.paths[path] == paths[path] + 1      # the path it reports took it
    rs, ri = topk_scores_ref(q, p, k + 1, col_valid=col_valid, inv_tau=inv_tau)
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


# ---- the Hopper kernel (bf16) ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n,d,k", [
    (1, 5121, 768, 100),      # one query; N one past a tile edge; the served width
    (32, 5119, 768, 100),     # a served batch (spread query tile); N one short of a tile
    (65, 3000, 768, 100),     # two query tiles, one row in the second; the ring wraps
    (2047, 3000, 64, 100),    # eval-like ragged Q: 32 query tiles
    (5, 300_000, 64, 100),    # many column splits merged by the select pass
    (33, 1000, 20, 10),       # d = 20: rows copied with zero columns to 24
    (70, 1000, 33, 128),      # d = 33: padded to 40; k at the fp32 path's shared limit
    (9, 2000, 96, 1),
    (40, 4000, 768, 256),     # k > 128 at the served width
])
def test_hopper_kernel_matches_plain(dev, n_q, n, d, k):
    q = _rand((n_q, d), torch.bfloat16, dev, 30)
    p = _rand((n, d), torch.bfloat16, dev, 31)
    _check(q, p, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [32, 40, 70])
def test_hopper_kernel_k1000_at_the_served_width_exact(dev, n_q):
    """k = 1000 at d = 768 on small integers (exact sums): every slot must
    equal the plain version's (random scores this dense leave too few slots
    clear of the tolerance to compare ids)."""
    q = _small_ints((n_q, 768), torch.bfloat16, dev, 45)
    p = _small_ints((20_000, 768), torch.bfloat16, dev, 46)
    _check(q, p, 1000, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [32, 100])
def test_hopper_kernel_masked_columns(dev, n_q):
    q = _rand((n_q, 768), torch.bfloat16, dev, 32)
    p = _rand((5000, 768), torch.bfloat16, dev, 33)
    g = torch.Generator(device=dev).manual_seed(34)
    valid = torch.rand(5000, generator=g, device=dev) > 0.3
    _check(q, p, 100, col_valid=valid)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [100, 128, 129, 1000, 1025])
@pytest.mark.parametrize("n_q", [7, 40])
def test_hopper_kernel_exact_ties(dev, k, n_q):
    """Small integers: exact sums, so ties are real ties; every slot must
    equal the plain version's (ties to the lowest id), across the pools'
    cuts (the bar met exactly) and the select pass."""
    g = torch.Generator(device=dev).manual_seed(35 + k)
    base = torch.randint(-3, 4, (40, 32), generator=g, device=dev)
    p = base[torch.randint(0, 40, (6000,), generator=g, device=dev)].to(torch.bfloat16)
    q = torch.randint(-3, 4, (n_q, 32), generator=g, device=dev).to(torch.bfloat16)
    _check(q, p, k, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("inv_tau", [20.0, 0.05])
def test_hopper_kernel_inv_tau(dev, inv_tau):
    q = _rand((33, 768), torch.bfloat16, dev, 36)
    p = _rand((4000, 768), torch.bfloat16, dev, 37)
    _check(q, p, 100, inv_tau=inv_tau)
    # a power of two scales small-integer scores exactly: ties stay ties
    g = torch.Generator(device=dev).manual_seed(38)
    qi = torch.randint(-3, 4, (20, 64), generator=g, device=dev).to(torch.bfloat16)
    pi = torch.randint(-3, 4, (3000, 64), generator=g, device=dev).to(torch.bfloat16)
    _check(qi, pi, 129, exact=True, inv_tau=0.5)


@pytest.mark.cuda
def test_hopper_kernel_unaligned_base_is_copied(dev):
    flat = _rand((300 * 64 + 1,), torch.bfloat16, dev, 39)
    p = flat[1:].view(300, 64)                        # 2 bytes off 16
    assert p.data_ptr() % 16 != 0
    _check(_rand((5, 64), torch.bfloat16, dev, 40), p, 20)


@pytest.mark.cuda
def test_wider_bf16_rows_are_widened_to_fp32(dev):
    d = ops.HOPPER_D_MAX + 64
    q = _rand((3, d), torch.bfloat16, dev, 41)
    p = _rand((500, d), torch.bfloat16, dev, 42)
    before = ops.fused_topk.paths["fp32_widened"]
    _check(q, p, 10)
    assert ops.fused_topk.paths["fp32_widened"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,k", [(32, 100), (2048, 100), (32, 1000), (2048, 20)])
def test_served_width_takes_the_hopper_kernel(dev, n_q, k):
    """The serve_topk, eval_topk and Top@k eval shapes (d = 768, bf16) take
    the Hopper kernel, as ops reports its path."""
    q = _rand((n_q, 768), torch.bfloat16, dev, 43)
    p = _rand((3000, 768), torch.bfloat16, dev, 44)
    ops.reset_launches()
    ops.fused_topk(q, p, k)
    assert ops.fused_topk.paths == {**dict.fromkeys(ops.PATHS, 0), "hopper": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 768, 1024, ops.HOPPER_D_MAX])
@pytest.mark.parametrize("n_q", [32, 2048])
@pytest.mark.parametrize("k", [100, 256, 1000])
def test_scan_smem_mirror_matches_the_kernel(dev, d, n_q, k):
    spread, stages, stage_keys = ops.scan_plan(d, k, n_q)
    lib = ops._library()
    assert ops.scan_smem_bytes(d, spread, stages, stage_keys) == \
        lib.fused_topk_scan_smem_bytes(d, int(spread), stages, stage_keys)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ops.BF16_KERNELS)
def test_no_bf16_kernel_uses_local_memory(dev, name):
    """The card reports 0 bytes of local memory (stack and spills) for each
    bf16 kernel."""
    assert ops.kernel_attributes(name)["local_bytes"] == 0


# ---- rows past a resident query tile (the LM retriever's 2048) --------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n,d,k", [
    (33, 5121, 1032, 100),              # resident, as before: d <= RESIDENT_D_MAX
    (33, 5121, 1280, 100),              # streamed: the narrowest; N one past a tile
    (70, 3000, 2048, 20),               # the LM width and eval k; ragged Q
    (256, 4096, 2048, 20),              # the lm eval shape
    (65, 3001, 2048, 129),              # k > 128: pools of 512 keys staged, 3 stages
    (2047, 3000, 2560, 100),            # stablelm-3b's width; 32 query tiles
    (1, 2000, 2048, 100),               # spread, resident at 2 stages
    (40, 1000, ops.HOPPER_D_MAX, 10),   # the widest row the Hopper scan takes
])
def test_hopper_kernel_wide_rows_match_plain(dev, n_q, n, d, k):
    q = _rand((n_q, d), torch.bfloat16, dev, 60)
    p = _rand((n, d), torch.bfloat16, dev, 61)
    ops.reset_launches()
    _check(q, p, k)
    assert ops.fused_topk.paths == {**dict.fromkeys(ops.PATHS, 0), "hopper": 1}
    layout = ops.scan_plan(d, k, n_q)[0]
    assert (layout == ops.STREAMED) == (d > ops.RESIDENT_D_MAX and n_q > 32), layout


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [7, 40, 300])
@pytest.mark.parametrize("k", [20, 100, 129, 1000])
def test_hopper_kernel_wide_rows_exact_ties_and_masked_tiles(dev, n_q, k):
    """Small integers at d = 2048 (exact sums: ties go to the lowest id),
    with two wholly masked index tiles and a masked tail: every slot equals
    the plain version's. k = 1000 cuts the pools in global memory (spread
    at 7 rows, streamed at 40 and 300), which random rows this dense cannot
    check: too few of their slots are clear of the tolerance."""
    g = torch.Generator(device=dev).manual_seed(62 + k)
    base = torch.randint(-2, 3, (40, 2048), generator=g, device=dev)
    p = base[torch.randint(0, 40, (3001,), generator=g, device=dev)].to(torch.bfloat16)
    q = torch.randint(-2, 3, (n_q, 2048), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.ones(3001, dtype=torch.bool, device=dev)
    valid[128:384] = False
    valid[-500:] = False
    _check(q, p, k, col_valid=valid, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,k", [(256, 20), (2048, 100), (32, 100)])
def test_lm_width_takes_the_hopper_kernel(dev, n_q, k):
    """The lm eval's search and Q = 2048 at d = 2048 (bf16) take the Hopper
    kernel, and match the fp32_widened route they took before (the bf16
    rows widened to the fp32 kernel)."""
    q = _rand((n_q, 2048), torch.bfloat16, dev, 63)
    p = _rand((4096, 2048), torch.bfloat16, dev, 64)
    ops.reset_launches()
    s, i = ops.fused_topk(q, p, k)
    assert ops.fused_topk.paths == {**dict.fromkeys(ops.PATHS, 0), "hopper": 1}
    ws, wi = ops.fused_topk(q.float(), p.float(), k)
    rs, ri = topk_scores_ref(q, p, k + 1)
    atol = 1e-4 * rs.abs().max().item()
    for ss, ii in ((s, i), (ws, wi)):
        err, bad, clear = topk_mismatch(ss, ii, rs, ri, atol)
        assert err <= atol and bad == 0 and clear >= ii.numel() // 2
