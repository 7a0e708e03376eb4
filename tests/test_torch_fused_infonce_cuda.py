"""The hand-written CUDA fused_infonce kernels (forward, dQ, dP) against
their plain version, on the card. Marked ``cuda``: without a GPU (and nvcc)
every test here skips. Imports no JAX.

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_fused_infonce_cuda.py

Tolerances, each against the dense fp32 reference (ref.py) on the same
inputs:
  * lse, pos, amax: 1e-5 of the largest |logit| (both sum exact products of
    the inputs in fp32, in another order);
  * dQ, dP under bf16: 1e-2 of the largest |reference gradient| (the kernel
    rounds each softmax coefficient to bf16 before its product, as the TPU
    kernel does, and the result to bf16: 2^-8 relative each);
  * dQ, dP under fp32: 1e-4 of the largest |reference gradient| (fp32
    summation order only).
"""

import pytest
import torch

from repro_torch.core.precision import NEG_INF
from repro_torch.kernels.fused_infonce import ops
from repro_torch.kernels.fused_infonce.ref import infonce_stats_ref, infonce_stats_vjp_ref

D = 768
N_PATH = 2064          # 8 local positives + 8 hard negatives + 2048 bank columns


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed, scale=0.2):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(x, ref, rtol_of_max, what):
    x, ref = x.float(), ref.float()
    tol = rtol_of_max * ref.abs().max().item()
    err = (x - ref).abs().max().item()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"
    return err


def _check(q, p, labels, valid, inv_tau=1.0, grads=True):
    """Forward and both backward kernels against the reference; returns the
    kernel outputs."""
    before = (ops.fused_infonce_fwd.launches, ops.fused_infonce_dq.launches,
              ops.fused_infonce_dp.launches)
    qk = q.clone().requires_grad_(grads)
    pk = p.clone().requires_grad_(grads)
    lse, pos, amax = ops.fused_infonce_stats(qk, pk, labels, valid, inv_tau)
    torch.cuda.synchronize()
    rl, rp, ra = infonce_stats_ref(q, p, labels, valid, inv_tau=inv_tau)
    # scale of the tolerance: the largest |logit| of a valid column; a label
    # on a masked column has pos = NEG_INF on both sides, exactly
    live = rp > NEG_INF / 2
    assert torch.equal(pos > NEG_INF / 2, live)
    logits = torch.cat([ra, rp])
    logits = logits[logits > NEG_INF / 2]
    scale = 1e-5 * max(1.0, logits.abs().max().item() if logits.numel() else 1.0)
    for x, r, name in ((lse, rl, "lse"), (pos[live], rp[live], "pos"), (amax, ra, "amax")):
        assert x.dtype == torch.float32
        assert torch.isfinite(x).all(), name
        err = (x - r).abs().max().item() if x.numel() else 0.0
        assert err <= scale, f"{name}: max abs err {err} > {scale}"
    assert ops.fused_infonce_fwd.launches == before[0] + 1
    if not grads:
        return lse, pos, amax
    g = torch.Generator(device=q.device).manual_seed(99)
    g_lse = torch.rand(q.shape[0], generator=g, device=q.device)
    g_pos = -torch.rand(q.shape[0], generator=g, device=q.device)
    dq, dp = torch.autograd.grad((lse, pos), (qk, pk), (g_lse, g_pos))
    torch.cuda.synchronize()
    assert ops.fused_infonce_dq.launches == before[1] + 1
    assert ops.fused_infonce_dp.launches == before[2] + 1
    rdq, rdp = infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos, inv_tau=inv_tau)
    assert dq.dtype == q.dtype and dp.dtype == p.dtype
    rtol = 1e-2 if torch.bfloat16 in (q.dtype, p.dtype) else 1e-4
    _close(dq, rdq, rtol, "dq")
    _close(dp, rdp, rtol, "dp")
    return lse, pos, amax


def _grads(q, p, labels, valid, g_lse, g_pos, inv_tau=1.0):
    """dQ and dP straight from the two kernels, for the forward's lse."""
    lse = ops.fused_infonce_fwd(q, p, labels, valid, inv_tau)[0]
    args = (q, p, labels, valid, lse, g_lse, g_pos, inv_tau)
    return ops.fused_infonce_dq(*args), ops.fused_infonce_dp(*args)


def _cotangents(m, dev, seed=99):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(m, generator=g, device=dev), -torch.rand(m, generator=g, device=dev)


def _check_grads(q, p, labels, valid, g_lse, g_pos, inv_tau=1.0):
    dq, dp = _grads(q, p, labels, valid, g_lse, g_pos, inv_tau)
    torch.cuda.synchronize()
    rdq, rdp = infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos, inv_tau=inv_tau)
    _close(dq, rdq, 1e-2, "dq")
    _close(dp, rdp, 1e-2, "dp")
    return dq, dp


def _path_case(m, dev, n_masked=1000):
    q = _rand((m, D), torch.bfloat16, dev, 0)
    p = _rand((N_PATH, D), torch.bfloat16, dev, 1)
    valid = torch.ones(N_PATH, dtype=torch.bool, device=dev)
    if n_masked:
        valid[-n_masked:] = False
    if m == 8:
        labels = torch.arange(m, dtype=torch.int32, device=dev)
        labels[5], labels[6] = -3, N_PATH + 7            # out of range: pos = 0
    else:
        labels = (16 + torch.arange(m, device=dev) % 2048).to(torch.int32)
    return q, p, labels, valid


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_path_shapes_bf16(dev, m):
    """A contaccum_bf16 chunk: local queries (M=8, some labels out of range)
    and the query-bank rows (M=2048), the last 1000 bank columns invalid.
    dP (and dQ at M=8) run on the Hopper path."""
    q, p, labels, valid = _path_case(m, dev)
    ops.reset_launches()
    lse, pos, _ = _check(q, p, labels, valid)
    if m == 8:
        assert pos[5].item() == 0.0 and pos[6].item() == 0.0
    assert ops.fused_infonce_fwd.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    assert ops.fused_infonce_dp.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    assert ops.fused_infonce_dq.paths == (
        {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0} if m == 8 else {"hopper": 0, "wmma": 1, "fp32": 0, "tf32x3": 0})


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_path_shapes_every_column_valid(dev, m):
    """The train phase's case after warm-up: no masked passage tile to skip."""
    q, p, labels, _ = _path_case(m, dev, n_masked=0)
    _check_grads(q, p, labels, None, *_cotangents(m, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_two_calls_are_bit_identical(dev, m):
    """No float atomics and a fixed summation order: the same inputs give
    the same bits."""
    q, p, labels, valid = _path_case(m, dev)
    g_lse, g_pos = _cotangents(m, dev)
    first = _grads(q, p, labels, valid, g_lse, g_pos)
    for _ in range(2):
        again = _grads(q, p, labels, valid, g_lse, g_pos)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n_masked", [1000, 0])
@pytest.mark.parametrize("m", [8, 2048])
def test_forward_two_calls_are_bit_identical(dev, m, n_masked):
    """The forward's tile partials merge in a fixed order: the same inputs
    give the same bits, on the Hopper path at both chunk shapes."""
    q, p, labels, valid = _path_case(m, dev, n_masked)
    ops.reset_launches()
    first = ops.fused_infonce_fwd(q, p, labels, valid)
    for _ in range(2):
        again = ops.fused_infonce_fwd(q, p, labels, valid)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert ops.fused_infonce_fwd.paths == {"hopper": 3, "wmma": 0, "fp32": 0, "tf32x3": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(8, N_PATH, D), (2048, N_PATH, D), (37, 301, 96),
                                   (2048, 300, 96), (16, 129, 64), (17, 4100, 40), (1, 1, 8)])
def test_forward_path_counts(dev, m, n, d):
    """Every bf16 forward with rows of a multiple of 16 bytes up to
    HOPPER_D_MAX takes the Hopper path (the small kernel up to 16 rows, the
    many-row kernel above), ragged N and d = 96 included, and matches the
    reference."""
    q = _rand((m, d), torch.bfloat16, dev, 30)
    p = _rand((n, d), torch.bfloat16, dev, 31)
    g = torch.Generator(device=dev).manual_seed(32)
    valid = torch.rand(n, generator=g, device=dev) > 0.3
    labels = torch.randint(-2, n + 2, (m,), generator=g, device=dev).to(torch.int32)
    ops.reset_launches()
    _check(q, p, labels, valid, inv_tau=1.5, grads=False)
    assert ops.fused_infonce_fwd.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 100])
def test_forward_wholly_masked_tiles_and_rows(dev, m):
    """A passage tile whose columns are all masked is skipped and still
    counts its in-range columns: with labels in it pos is -1e30; with every
    column masked each row's lse is the finite -1e30 + log N of ref.py,
    bit for bit, and amax is -1e30."""
    q = _rand((m, 256), torch.bfloat16, dev, 33)
    p = _rand((300, 256), torch.bfloat16, dev, 34)
    valid = torch.ones(300, dtype=torch.bool, device=dev)
    valid[64:128] = False
    valid[250:] = False
    labels = torch.arange(m, dtype=torch.int32, device=dev) * 3
    labels[0], labels[1] = 70, 260           # in the masked tile; in the masked tail
    ops.reset_launches()
    _, pos, _ = _check(q, p, labels, valid, grads=False)
    assert (pos[:2] == NEG_INF).all()
    none = torch.zeros(300, dtype=torch.bool, device=dev)
    lse, pos, amax = ops.fused_infonce_fwd(q, p, labels, none)
    rl, rp, ra = infonce_stats_ref(q, p, labels, none)
    assert torch.isfinite(lse).all() and torch.equal(lse, rl)
    assert torch.equal(amax, ra) and (amax == NEG_INF).all()
    assert torch.equal(pos, rp)
    assert ops.fused_infonce_fwd.paths == {"hopper": 2, "wmma": 0, "fp32": 0, "tf32x3": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 100])
def test_fully_masked_passage_tile(dev, m):
    """Passages 64..127 (one whole tile) and 250..299 masked: their dP rows
    are exactly 0 and the rest match the reference."""
    q = _rand((m, 256), torch.bfloat16, dev, 20)
    p = _rand((300, 256), torch.bfloat16, dev, 21)
    valid = torch.ones(300, dtype=torch.bool, device=dev)
    valid[64:128] = False
    valid[250:] = False
    labels = torch.arange(m, dtype=torch.int32, device=dev) % 64
    dq, dp = _check_grads(q, p, labels, valid, *_cotangents(m, dev))
    assert not dp[~valid].float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
@pytest.mark.parametrize("which", ["g_lse", "g_pos"])
def test_one_cotangent_alone(dev, m, which):
    """Only the softmax term (g_pos = 0) or only the one-hot term (g_lse =
    0) of the coefficient."""
    q = _rand((m, D), torch.bfloat16, dev, 22)
    p = _rand((N_PATH, D), torch.bfloat16, dev, 23)
    labels = torch.arange(m, dtype=torch.int32, device=dev) * 3
    g_lse, g_pos = _cotangents(m, dev)
    if which == "g_lse":
        g_pos = torch.zeros_like(g_pos)
    else:
        g_lse = torch.zeros_like(g_lse)
    dq, dp = _check_grads(q, p, labels, None, g_lse, g_pos)
    if which == "g_pos":   # only the labelled passages get a gradient
        hit = torch.zeros(N_PATH, dtype=torch.bool, device=dev)
        hit[labels.long()] = True
        assert not dp[~hit].float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_label_on_a_masked_passage(dev, m):
    """A label that points at a masked column adds no one-hot term there."""
    q = _rand((m, 128), torch.bfloat16, dev, 24)
    p = _rand((200, 128), torch.bfloat16, dev, 25)
    valid = torch.ones(200, dtype=torch.bool, device=dev)
    valid[150:] = False
    labels = torch.arange(m, dtype=torch.int32, device=dev) % 200
    labels[0] = 170
    _check_grads(q, p, labels, valid, *_cotangents(m, dev))


@pytest.mark.cuda
def test_unaligned_base_is_copied_for_tma(dev):
    q = _rand((8, D), torch.bfloat16, dev, 26)
    big = _rand((N_PATH * D + 1,), torch.bfloat16, dev, 27)
    p = big[1:].view(N_PATH, D)                 # a base 2 bytes past alignment
    assert p.data_ptr() % 16
    labels = torch.arange(8, dtype=torch.int32, device=dev)
    ops.reset_launches()
    _check_grads(q, p, labels, None, *_cotangents(8, dev))
    assert ops.fused_infonce_dp.paths["hopper"] == 1


@pytest.mark.cuda
def test_hopper_kernels_keep_to_registers(dev):
    """No local memory (spills or stack) in the kernels of the train path's
    forward, dQ and dP, as the card reports them."""
    for name in ops.HOPPER_KERNELS:
        attrs = ops.kernel_attributes(name)
        assert attrs["local_bytes"] == 0, (name, attrs)
        assert 0 < attrs["registers"] <= 255


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(37, 301, 96), (130, 70, 768), (1, 1, 8), (65, 4100, 40),
                                   (16, 129, 64), (17, 2064, 768), (1000, 500, 200),
                                   (100, 300, 192), (1000, 300, 64), (2048, 300, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_shapes(dev, m, n, d, dtype):
    """M and N not multiples of any tile; d=40 takes the scalar loads; N=4100
    splits the columns and M=130 three row tiles. Under bf16 dP runs on the
    Hopper path (M=1 and 16 the small kernel, M=1000 two cluster ranks) and
    dQ on it up to M=16. The last three reach the cluster kernel's uneven
    d-chunk splits: d=192 gives one rank 3 chunks (a warpgroup with one);
    d=64 over 2 ranks and d=128 over 3 leave a rank with no chunk (its own
    cluster-barrier path) beside ranks whose warpgroup has one."""
    q = _rand((m, d), dtype, dev, 2)
    p = _rand((n, d), dtype, dev, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    valid = torch.rand(n, generator=g, device=dev) > 0.2
    labels = torch.randint(0, n, (m,), generator=g, device=dev).to(torch.int32)
    _check(q, p, labels, valid, inv_tau=1.5)


@pytest.mark.cuda
def test_mixed_types_promote_to_fp32(dev):
    q = _rand((20, 64), torch.bfloat16, dev, 5)
    p = _rand((300, 64), torch.float32, dev, 6)
    labels = torch.arange(20, dtype=torch.int32, device=dev)
    _check(q, p, labels, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_rows_stay_finite(dev, dtype):
    q = _rand((10, 128), dtype, dev, 7)
    p = _rand((200, 128), dtype, dev, 8)
    valid = torch.zeros(200, dtype=torch.bool, device=dev)
    labels = torch.arange(10, dtype=torch.int32, device=dev)
    qk, pk = q.clone().requires_grad_(), p.clone().requires_grad_()
    lse, pos, amax = ops.fused_infonce_stats(qk, pk, labels, valid)
    assert torch.isfinite(lse).all() and (lse < NEG_INF / 2).all()
    assert (pos == NEG_INF).all() and (amax == NEG_INF).all()
    dq, dp = torch.autograd.grad((lse - pos).sum(), (qk, pk))
    assert torch.equal(dq, torch.zeros_like(dq)) and torch.equal(dp, torch.zeros_like(dp))


@pytest.mark.cuda
def test_bank_rows_launch_no_dq(dev):
    """A detached q (the query-bank buffer) gets no dQ launch."""
    q = _rand((2048, D), torch.bfloat16, dev, 9)
    p = _rand((N_PATH, D), torch.bfloat16, dev, 10).requires_grad_()
    labels = (16 + torch.arange(2048, device=dev)).to(torch.int32)
    before = ops.fused_infonce_dq.launches, ops.fused_infonce_dp.launches
    lse, pos, _ = ops.fused_infonce_stats(q, p, labels, None)
    (lse - pos).sum().backward()
    assert (ops.fused_infonce_dq.launches, ops.fused_infonce_dp.launches) == (
        before[0], before[1] + 1)
    assert p.grad is not None and torch.isfinite(p.grad.float()).all()


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached ref.py")

    monkeypatch.setattr(ops, "infonce_stats_ref", refuse)
    monkeypatch.setattr(ops, "infonce_stats_vjp_ref", refuse)
    q = _rand((8, 64), torch.bfloat16, dev, 11).requires_grad_()
    p = _rand((100, 64), torch.bfloat16, dev, 12).requires_grad_()
    labels = torch.arange(8, dtype=torch.int32, device=dev)
    lse, pos, _ = ops.fused_infonce_stats(q, p, labels, None)
    (lse - pos).sum().backward()
    assert q.grad is not None and p.grad is not None


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(dev):
    q = _rand((4, 64), torch.bfloat16, dev, 13)
    p = _rand((100, 64), torch.bfloat16, dev, 14)
    labels = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_infonce_fwd(q, p.T.contiguous().T, labels)
    with pytest.raises(TypeError):
        ops.fused_infonce_fwd(q.half(), p, labels)
    with pytest.raises(ValueError, match="int32"):
        ops.fused_infonce_fwd(q, p, labels.long())
    with pytest.raises(ValueError, match="on"):
        ops.fused_infonce_fwd(q, p.cpu(), labels)


# ---- past SMALL_D_MAX (the LM retriever's 2048-wide reps) --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [1032, 1280, 2048, 2560, ops.HOPPER_D_MAX])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 2048])
def test_wide_rows_dp_takes_the_hopper_path(dev, m, d):
    """dP past SMALL_D_MAX runs on the Hopper path up to HOPPER_D_MAX: at up
    to 16 rows the split kernel (clusters of small_ranks(d) blocks, each
    rank on its share of the d-chunks: 8 and 9 of 17 at d = 1032, 16 each at
    2048 and 8192, 13-14 at 2560), above the cluster kernel (its ranks'
    shares end in groups of fewer than 4 chunks). Ragged N with a wholly
    masked passage tile and a masked tail, labels out of range and on a
    masked column; the rows of masked passages are exactly 0, two calls give
    the same bits, the forward takes the Hopper path and dQ too at up to 16
    rows (above, wmma: dQ of many rows has no caller)."""
    n = N_PATH if m in (8, 2048) else 1001
    q = _rand((m, d), torch.bfloat16, dev, 50)
    p = _rand((n, d), torch.bfloat16, dev, 51)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[64:128] = False
    valid[-300:] = False
    g = torch.Generator(device=dev).manual_seed(52)
    labels = torch.randint(-1, n + 1, (m,), generator=g, device=dev).to(torch.int32)
    labels[0] = 100                                 # on a masked column
    g_lse, g_pos = _cotangents(m, dev)
    ops.reset_launches()
    dq, dp = _check_grads(q, p, labels, valid, g_lse, g_pos)
    assert not dp[~valid].float().abs().max().item()
    assert ops.fused_infonce_dp.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    assert ops.fused_infonce_dq.paths == (
        {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0} if m <= ops.SMALL_M else
        {"hopper": 0, "wmma": 1, "fp32": 0, "tf32x3": 0})
    assert ops.fused_infonce_fwd.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    lse = ops.fused_infonce_fwd(q, p, labels, valid)[0]
    args = (q, p, labels, valid, lse, g_lse, g_pos)
    assert torch.equal(ops.fused_infonce_dp(*args), ops.fused_infonce_dp(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_wide_rows_dp_every_column_valid_and_its_parent_route(dev, m):
    """The lm chunk with every column valid (no masked tile to skip), on
    the Hopper path and on the wmma kernels the parent ran
    (``grad_on_path``, which counts no launch): both within 1e-2 of the
    largest reference gradient."""
    q = _rand((m, 2048), torch.bfloat16, dev, 53)
    p = _rand((N_PATH, 2048), torch.bfloat16, dev, 54)
    labels = (torch.arange(m, device=dev) + (0 if m == 8 else 16)).to(torch.int32)
    g_lse, g_pos = _cotangents(m, dev)
    lse = ops.fused_infonce_fwd(q, p, labels, None)[0]
    rdp = infonce_stats_vjp_ref(q, p, labels, None, g_lse, g_pos)[1]
    ops.reset_launches()
    dp = ops.fused_infonce_dp(q, p, labels, None, lse, g_lse, g_pos)
    parent = ops.grad_on_path("dp", "wmma", q, p, labels, None, lse, g_lse, g_pos)
    torch.cuda.synchronize()
    assert ops.fused_infonce_dp.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    _close(dp, rdp, 1e-2, "dp")
    _close(parent, rdp, 1e-2, "dp on the wmma path")


@pytest.mark.cuda
def test_split_dp_needs_its_ranks(dev):
    """Past SMALL_D_MAX one block cannot hold the small kernel's tile: the
    library refuses a split of one rank, or of shares above 16 chunks."""
    q = _rand((8, 2048), torch.bfloat16, dev, 55)
    p = _rand((300, 2048), torch.bfloat16, dev, 56)
    labels = torch.arange(8, dtype=torch.int32, device=dev)
    g_lse, g_pos = _cotangents(8, dev)
    lse = ops.fused_infonce_fwd(q, p, labels, None)[0]
    lib, out = ops._library(), torch.empty_like(p)
    for ranks in (1, 9):
        err = lib.fused_infonce_dp_hopper_launch(
            q.data_ptr(), p.data_ptr(), labels.data_ptr(), None, lse.data_ptr(),
            g_lse.data_ptr(), g_pos.data_ptr(), out.data_ptr(), 8, 300, 2048, ranks, 0, 1.0,
            torch.cuda.current_stream().cuda_stream)
        assert err != 0, ranks


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1032, 2048, 2560, ops.HOPPER_D_MAX])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 2048])
def test_wide_rows_forward_and_dq_take_the_hopper_path(dev, m, d):
    """The forward past SMALL_D_MAX on the Hopper path at every M (up to 16
    rows the split kernel, rank 0 of each cluster writing the tile's
    partials; above, the many-row kernel), and dQ at up to 16 rows (the
    split kernel, each rank its columns of the tile's partial), against
    ref.py: a wholly masked passage tile and a masked tail, labels outside
    [0, N) and on a masked column (pos -1e30); two calls give the same bits
    and the launches are counted on their paths."""
    n = N_PATH if m in (8, 2048) else 1001
    q = _rand((m, d), torch.bfloat16, dev, 60)
    p = _rand((n, d), torch.bfloat16, dev, 61)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[64:128] = False
    valid[-300:] = False
    g = torch.Generator(device=dev).manual_seed(62)
    labels = torch.randint(-1, n + 1, (m,), generator=g, device=dev).to(torch.int32)
    labels[0] = 100                                 # on a masked column
    ops.reset_launches()
    _, pos, _ = _check(q, p, labels, valid)
    assert (pos[0] == NEG_INF).item()
    small = m <= ops.SMALL_M
    assert ops.fused_infonce_fwd.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    assert ops.fused_infonce_dq.paths == (
        {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0} if small else {"hopper": 0, "wmma": 1, "fp32": 0, "tf32x3": 0})
    first = ops.fused_infonce_fwd(q, p, labels, valid)
    assert all(torch.equal(a, b) for a, b in zip(first, ops.fused_infonce_fwd(q, p, labels, valid)))
    if small:
        g_lse, g_pos = _cotangents(m, dev)
        args = (q, p, labels, valid, first[0], g_lse, g_pos)
        assert torch.equal(ops.fused_infonce_dq(*args), ops.fused_infonce_dq(*args))
        assert ops.hopper_blocks("fwd", m, n, d=d) == -(-n // 64) * ops.small_ranks(d)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_wide_rows_wholly_masked_rows(dev, m):
    """Every column masked at d = 2048: each row's lse is ref.py's finite
    -1e30 + log N bit for bit, amax and pos (labels in range) -1e30, and
    dQ is zero (the split dQ's ranks zero their columns of each tile)."""
    q = _rand((m, 2048), torch.bfloat16, dev, 63)
    p = _rand((300, 2048), torch.bfloat16, dev, 64)
    none = torch.zeros(300, dtype=torch.bool, device=dev)
    labels = (torch.arange(m, device=dev) % 300).to(torch.int32)
    ops.reset_launches()
    lse, pos, amax = ops.fused_infonce_fwd(q, p, labels, none)
    rl, rp, ra = infonce_stats_ref(q, p, labels, none)
    assert torch.isfinite(lse).all() and torch.equal(lse, rl)
    assert torch.equal(amax, ra) and (amax == NEG_INF).all() and torch.equal(pos, rp)
    g_lse, g_pos = _cotangents(m, dev)
    dq = ops.fused_infonce_dq(q, p, labels, none, lse, g_lse, g_pos)
    assert not dq.float().abs().max().item()
    assert ops.fused_infonce_fwd.paths["hopper"] == 1
    assert ops.fused_infonce_dq.paths["hopper" if m == 8 else "wmma"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_wide_rows_forward_and_dq_every_column_valid_and_their_parent_route(dev, m):
    """The lm chunk with every column valid, the forward (and dQ at M = 8)
    on the Hopper path and on the wmma kernels the parent ran
    (``stats_on_path``, ``grad_on_path``, which count no launch): the
    statistics within 1e-5 of the largest |logit|, dQ within 1e-2 of the
    largest reference gradient."""
    q = _rand((m, 2048), torch.bfloat16, dev, 65)
    p = _rand((N_PATH, 2048), torch.bfloat16, dev, 66)
    labels = (torch.arange(m, device=dev) + (0 if m == 8 else 16)).to(torch.int32)
    g_lse, g_pos = _cotangents(m, dev)
    rl, rp, ra = infonce_stats_ref(q, p, labels, None)
    tol = 1e-5 * max(1.0, torch.cat([rp, ra]).abs().max().item())
    ops.reset_launches()
    for route, stats in (("hopper", ops.fused_infonce_fwd(q, p, labels, None)),
                         ("wmma", ops.stats_on_path("wmma", q, p, labels, None))):
        for x, r, name in zip(stats, (rl, rp, ra), ("lse", "pos", "amax")):
            assert (x - r).abs().max().item() <= tol, (route, name)
    assert ops.fused_infonce_fwd.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}
    if m == 8:
        lse = ops.fused_infonce_fwd(q, p, labels, None)[0]
        rdq = infonce_stats_vjp_ref(q, p, labels, None, g_lse, g_pos)[0]
        _close(ops.fused_infonce_dq(q, p, labels, None, lse, g_lse, g_pos), rdq, 1e-2, "dq")
        _close(ops.grad_on_path("dq", "wmma", q, p, labels, None, lse, g_lse, g_pos), rdq, 1e-2,
               "dq on the wmma path")
        assert ops.fused_infonce_dq.paths == {"hopper": 1, "wmma": 0, "fp32": 0, "tf32x3": 0}


@pytest.mark.cuda
def test_split_fwd_and_dq_need_their_ranks(dev):
    """As for dP: past SMALL_D_MAX the library refuses a forward or dQ of
    up to 16 rows in one rank, or in shares above 16 chunks, and the
    wrapper raises on a refused launch."""
    q = _rand((8, 2048), torch.bfloat16, dev, 67)
    p = _rand((300, 2048), torch.bfloat16, dev, 68)
    labels = torch.arange(8, dtype=torch.int32, device=dev)
    g_lse, g_pos = _cotangents(8, dev)
    lse = ops.fused_infonce_fwd(q, p, labels, None)[0]
    lib, stream = ops._library(), torch.cuda.current_stream().cuda_stream
    stats = [torch.empty(8, device=dev) for _ in range(3)]
    part = torch.empty((3, 8, 5), device=dev)
    partial = torch.empty((5, 8, 2048), device=dev)
    out = torch.empty_like(q)
    for ranks in (1, 9):
        err = lib.fused_infonce_fwd_hopper_launch(
            q.data_ptr(), p.data_ptr(), labels.data_ptr(), None,
            *(t.data_ptr() for t in stats), part.data_ptr(), 8, 300, 2048, 0, ranks, 1.0, stream)
        assert err != 0, ("fwd", ranks)
        err = lib.fused_infonce_dq_hopper_launch(
            q.data_ptr(), p.data_ptr(), labels.data_ptr(), None, lse.data_ptr(),
            g_lse.data_ptr(), g_pos.data_ptr(), out.data_ptr(), partial.data_ptr(), 8, 300, 2048,
            ranks, 1.0, stream)
        assert err != 0, ("dq", ranks)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops._raise_on(err, "fused_infonce dq (Hopper)", lib)


# ---- fp32 dQ and dP on 3xTF32 ("tf32x3") -------------------------------------

def _fp32_case(m, n, d, dev, seed, scale=0.2, n_masked=0):
    q = _rand((m, d), torch.float32, dev, seed, scale)
    p = _rand((n, d), torch.float32, dev, seed + 1, scale)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if n_masked:
        valid[-n_masked:] = False
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    labels = torch.randint(0, n, (m,), generator=g, device=dev).to(torch.int32)
    return q, p, labels, valid


def _fp32_grads(q, p, labels, valid, g_lse, g_pos, inv_tau=1.0):
    """dQ and dP of the fp32 kernels, each held to the plain version at 1e-4
    of its largest |g| and to ref.py in float64 at most 10x the plain
    version's own error against it (chip_smoke.py's FP64_ERR_RATIO), taken
    against the forward's lse; the forward, dQ and dP all on the "tf32x3"
    path."""
    ops.reset_launches()
    lse = ops.fused_infonce_fwd(q, p, labels, valid, inv_tau)[0]
    args = (q, p, labels, valid, lse, g_lse, g_pos, inv_tau)
    dq, dp = ops.fused_infonce_dq(*args), ops.fused_infonce_dp(*args)
    torch.cuda.synchronize()
    for fn in (ops.fused_infonce_fwd, ops.fused_infonce_dq, ops.fused_infonce_dp):
        assert fn.paths == {"hopper": 0, "wmma": 0, "fp32": 0, "tf32x3": 1}
    plain = infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos, inv_tau=inv_tau)
    exact = infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos, inv_tau=inv_tau,
                                  dtype=torch.float64)
    for got, want, want64, what in zip((dq, dp), plain, exact, ("dq", "dp")):
        assert got.dtype == torch.float32
        _close(got, want, 1e-4, what)
        err = (got.double() - want64).abs().max().item()
        plain_err = (want.double() - want64).abs().max().item()
        assert err <= 10 * plain_err, f"{what}: fp64 error {err} > 10 x {plain_err}"
    return dq, dp


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(37, 301, 96), (130, 70, 768), (1, 1, 4), (65, 4100, 40),
                                   (5, 37, 200), (1000, 500, 196), (2048, 2064, 768),
                                   (32, 8256, 768), (8224, 64, 768)])
def test_tf32x3_ragged_shapes(dev, m, n, d):
    """M and N not multiples of the 64-row tile or the 32-row step, d from 4
    (one rank, most of its columns TMA's zeros) to 768 (4 ranks) and 196 (2
    ranks, the second on 4 columns); the local rows' dQ and the in-batch
    chunk's dP split their contraction axis (29 and 30 splits on an H100)."""
    q, p, labels, valid = _fp32_case(m, n, d, dev, 60, n_masked=n // 7)
    _fp32_grads(q, p, labels, valid, *_cotangents(m, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_tf32x3_all_masked_tiles(dev, m):
    """Passages 64..127 (one whole dP tile) and the last 400 masked (whole
    steps of dQ's split ranges at M = 8): the masked passages' dP rows are
    exactly 0 and the rest match; every passage masked gives zeros."""
    q, p, labels, valid = _fp32_case(m, 1000, 256, dev, 70)
    valid[64:128] = False
    valid[600:] = False
    labels %= 64
    dq, dp = _fp32_grads(q, p, labels, valid, *_cotangents(m, dev))
    assert not dp[~valid].abs().max().item()
    valid[:] = False
    dq, dp = _grads(q, p, labels, valid, *_cotangents(m, dev))
    assert torch.equal(dq, torch.zeros_like(dq)) and torch.equal(dp, torch.zeros_like(dp))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_tf32x3_label_on_a_masked_passage(dev, m):
    q, p, labels, valid = _fp32_case(m, 200, 128, dev, 80)
    valid[150:] = False
    labels %= 150
    labels[0] = 170
    labels[1] = -4                      # outside [0, N): no one-hot term either
    _fp32_grads(q, p, labels, valid, *_cotangents(m, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["g_lse", "g_pos"])
def test_tf32x3_one_cotangent_alone(dev, which):
    q, p, labels, valid = _fp32_case(300, 2064, 768, dev, 90)
    g_lse, g_pos = _cotangents(300, dev)
    if which == "g_lse":
        g_pos = torch.zeros_like(g_pos)
    else:
        g_lse = torch.zeros_like(g_lse)
    dq, dp = _fp32_grads(q, p, labels, valid, g_lse, g_pos)
    if which == "g_pos":   # only the labelled passages get a gradient
        hit = torch.zeros(2064, dtype=torch.bool, device=dev)
        hit[labels.long()] = True
        assert not dp[~hit].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(32, 8256), (2048, 2064), (8224, 64)])
def test_tf32x3_two_calls_are_bit_identical(dev, m, n):
    """Fixed orders everywhere (rank order, chunk order, split order): the
    same inputs give the same bits."""
    q, p, labels, valid = _fp32_case(m, n, 768, dev, 100, scale=1.0)
    g_lse, g_pos = _cotangents(m, dev)
    first = _grads(q, p, labels, valid, g_lse, g_pos)
    second = _grads(q, p, labels, valid, g_lse, g_pos)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.2, 1.0])
def test_tf32x3_against_float64(dev, scale):
    """At the bank rows' width and the xdev phase's magnitudes (scale 1:
    rows of norm ~27.7, logits up to ~100), both gradients within 10x of
    the fp32 plain version's own error against ref.py in float64."""
    q, p, labels, valid = _fp32_case(2048, 2064, 768, dev, 110, scale=scale)
    _fp32_grads(q, p, labels, valid, *_cotangents(2048, dev))


@pytest.mark.cuda
def test_fp32_route_at_other_widths(dev):
    """d = 42 (rows of 168 bytes, no TMA) takes the CUDA-core "fp32" kernels; at d
    = 40 grad_on_path runs them too, and both routes agree with the plain
    version."""
    q, p, labels, valid = _fp32_case(37, 301, 42, dev, 120)
    g_lse, g_pos = _cotangents(37, dev)
    ops.reset_launches()
    dq, dp = _grads(q, p, labels, valid, g_lse, g_pos)
    assert ops.fused_infonce_dq.paths["fp32"] == ops.fused_infonce_dp.paths["fp32"] == 1
    rdq, rdp = infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos)
    _close(dq, rdq, 1e-4, "dq")
    _close(dp, rdp, 1e-4, "dp")
    q, p, labels, valid = _fp32_case(37, 301, 40, dev, 121)
    lse = ops.fused_infonce_fwd(q, p, labels, valid)[0]
    rdq, rdp = infonce_stats_vjp_ref(q, p, labels, valid, g_lse, g_pos)
    for route in ("fp32", "tf32x3"):
        _close(ops.grad_on_path("dq", route, q, p, labels, valid, lse, g_lse, g_pos), rdq, 1e-4,
               f"dq {route}")
        _close(ops.grad_on_path("dp", route, q, p, labels, valid, lse, g_lse, g_pos), rdp, 1e-4,
               f"dp {route}")
    with pytest.raises(ValueError):   # the 3xTF32 kernels take no d off a multiple of 4
        ops.grad_on_path("dq", "tf32x3", *_fp32_case(8, 64, 42, dev, 122), lse[:8],
                         g_lse[:8], g_pos[:8])


@pytest.mark.cuda
def test_tf32x3_unaligned_base_is_copied_for_tma(dev):
    q, p, labels, valid = _fp32_case(40, 300, 96, dev, 130)
    big = _rand((300 * 96 + 1,), torch.float32, dev, 131)
    p = big[1:].view(300, 96)                  # a base 4 bytes past alignment
    assert p.data_ptr() % 16
    _fp32_grads(q, p, labels, valid, *_cotangents(40, dev))


@pytest.mark.cuda
def test_tf32x3_kernels_keep_to_registers(dev):
    """No spills or local memory in the 3xTF32 path's kernels."""
    for name in ops.TF32X3_KERNELS:
        attrs = ops.kernel_attributes(name)
        assert attrs["local_bytes"] == 0, (name, attrs)
        assert 0 < attrs["registers"] <= 255


# ---- the fp32 forward on 3xTF32 ------------------------------------------------

def _fwd64(q, p, labels, valid, inv_tau=1.0, path="tf32x3"):
    """The forward on ``path`` (``ops.path_of``'s route for these operands),
    held to the plain version (1e-5 of the largest |logit|) and to ref.py in
    float64: lse within 10x (FP64_ERR_RATIO) of the fp32 plain version's own
    error there, or of one fp32 ulp of the largest |lse| where that is
    larger (a tiny problem's plain lse can be exact). Returns (lse, pos,
    amax)."""
    ops.reset_launches()
    got = _check(q, p, labels, valid, inv_tau, grads=False)
    assert ops.fused_infonce_fwd.paths[path] == 1, ops.fused_infonce_fwd.paths
    plain = infonce_stats_ref(q, p, labels, valid, inv_tau=inv_tau)[0]
    exact = infonce_stats_ref(q, p, labels, valid, inv_tau=inv_tau, dtype=torch.float64)[0]
    live = exact > NEG_INF / 2
    if live.any():
        err = (got[0].double() - exact)[live].abs().max().item()
        own = (plain.double() - exact)[live].abs().max().item()
        ulp = 2.0 ** -23 * exact[live].abs().max().item()
        assert err <= 10 * max(own, ulp), f"lse: fp64 error {err} > 10 x {max(own, ulp)}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(37, 301, 96), (1, 1, 4), (130, 70, 768), (65, 4100, 40),
                                   (129, 129, 8), (1000, 500, 196), (300, 500, 8192),
                                   (2179, 384, 768), (32, 8256, 768), (8224, 64, 768)])
def test_tf32x3_forward_ragged_shapes(dev, m, n, d):
    """M and N off the 128-row tile (M = 2179: a last group of one query
    tile), d from 4 (one chunk of 32 columns, most of it TMA's zeros) to
    8192, a seventh of the passages masked, inv_tau 1.5; the 32 local rows
    (the second warpgroup idle) and the 64-column in-batch chunk."""
    q, p, labels, valid = _fp32_case(m, n, d, dev, 140, n_masked=n // 7)
    _fwd64(q, p, labels, valid, inv_tau=1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_tf32x3_forward_wholly_masked_tiles_and_rows(dev, m):
    """Passages 128..255 (one whole tile) masked, labels in it and on a
    masked passage of a computed tile, labels outside [0, N) and past N
    inside the last tile's range: pos -1e30 or 0 as ref.py gives them; then
    every passage masked: lse about -1e30 and finite, pos and amax -1e30."""
    q, p, labels, valid = _fp32_case(m, 300, 256, dev, 150)
    valid[128:256] = False
    valid[5] = False
    labels[0], labels[1], labels[2], labels[3] = 200, 5, -3, 310
    lse, pos, amax = _fwd64(q, p, labels, valid)
    assert (pos[:2] == NEG_INF).all() and (pos[2:4] == 0.0).all()
    valid[:] = False
    ops.reset_launches()
    lse, pos, amax = ops.fused_infonce_fwd(q, p, labels, valid)
    assert ops.fused_infonce_fwd.paths["tf32x3"] == 1
    assert torch.isfinite(lse).all() and (lse < NEG_INF / 2).all()
    assert torch.equal(lse, infonce_stats_ref(q, p, labels, valid)[0])
    assert (amax == NEG_INF).all() and (pos[4:] == NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(8192, 8256), (32, 8256), (8224, 64)])
def test_tf32x3_forward_two_calls_are_bit_identical(dev, m, n):
    """No atomics, fixed orders (the shuffles of a row's 4 threads, the
    merge's): the same inputs give the same bits."""
    q, p, labels, valid = _fp32_case(m, n, 768, dev, 160, scale=1.0)
    first = ops.fused_infonce_fwd(q, p, labels, valid)
    second = ops.fused_infonce_fwd(q, p, labels, valid)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.2, 1.0])
def test_tf32x3_forward_against_float64(dev, scale):
    """The xdev bank rows (M = 8192 against N = 8256, d = 768) at small
    logits and at the xdev phase's magnitudes (scale 1: logits up to ~150):
    lse within 10x of the plain version's own float64 error (dQ and dP
    taken against it: test_tf32x3_against_float64)."""
    _fwd64(*_fp32_case(8192, 8256, 768, dev, 170, scale=scale))


@pytest.mark.cuda
def test_tf32x3_forward_unaligned_base_is_copied_for_tma(dev):
    q, p, labels, valid = _fp32_case(40, 300, 96, dev, 180)
    big = _rand((40 * 96 + 1,), torch.float32, dev, 181)
    q = big[1:].view(40, 96)                   # a base 4 bytes past alignment
    assert q.data_ptr() % 16
    _fwd64(q, p, labels, valid)


@pytest.mark.cuda
def test_fp32_forward_route_at_other_widths(dev):
    """d = 42 (rows of 168 bytes, no TMA) keeps the CUDA-core "fp32" forward;
    stats_on_path runs either fp32 route where its kernel takes the shape,
    both held to the plain version, and refuses the others."""
    q, p, labels, valid = _fp32_case(37, 301, 42, dev, 190)
    _fwd64(q, p, labels, valid, path="fp32")
    q, p, labels, valid = _fp32_case(37, 301, 40, dev, 191)
    want = infonce_stats_ref(q, p, labels, valid)
    for route in ("fp32", "tf32x3"):
        got = ops.stats_on_path(route, q, p, labels, valid)
        for x, r, what in zip(got, want, ("lse", "pos", "amax")):
            _close(x, r, 1e-5, f"{what} {route}")
    with pytest.raises(ValueError):   # no d off a multiple of 4
        ops.stats_on_path("tf32x3", *_fp32_case(8, 64, 42, dev, 192))
    with pytest.raises(ValueError):   # the bf16 routes take no fp32 operands
        ops.stats_on_path("hopper", q, p, labels, valid)


def _ulps(x, exact):
    """x - exact in fp32 ulps of exact (float64 in, float64 out)."""
    e = exact.float()
    return (x.double() - exact) / (torch.nextafter(e.abs(), torch.full_like(e, float("inf")))
                                   - e.abs()).double()


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.1, 0.3, 0.8, 1.5])
def test_tf32x3_scores_carry_no_truncation_bias(dev, scale):
    """The 3xTF32 scores of the forward, dQ and dP (each 16 columns of d in
    a fresh accumulator, moved an ulp away from zero) sit within half an ulp
    of float64 on average, and within 0.2 ulp of each other: 4096 rows near
    one vector (scores from ~7 to ~1800 by scale), one row's score each,
    read from the forward's pos and from the coefficients exp(s - lse) of dQ
    and dP given lse = the exact score rounded (g_lse 1, no label). The
    tensor cores' truncation alone leaves them 0.6-1.1 ulp short."""
    g = torch.Generator(device=dev).manual_seed(200)
    base = torch.randn((1, 768), generator=g, device=dev) * scale
    rows = base + torch.randn((4096, 768), generator=g, device=dev) * scale * 0.05
    exact = (rows.double() @ base.double().T)[:, 0]
    lse = exact.float().contiguous()
    one, zero = torch.ones_like(lse), torch.zeros_like(lse)
    none = torch.full((4096,), -1, dtype=torch.int32, device=dev)
    k = int(base[0].abs().argmax())
    fwd = ops.fused_infonce_fwd(rows, base, torch.zeros(4096, dtype=torch.int32, device=dev))[1]
    dq = ops.grad_on_path("dq", "tf32x3", rows, base, none, None, lse, one, zero)
    dp = ops.grad_on_path("dp", "tf32x3", base, rows, none[:1], None, lse[:1].contiguous(),
                          one[:1], zero[:1])
    biases = {"fwd": _ulps(fwd, exact).mean().item(),
              "dq": _ulps(lse.double() + torch.log(dq[:, k].double() / base[0, k].double()),
                          exact).mean().item(),
              "dp": _ulps(lse[0].double() + torch.log(dp[:, k].double() / base[0, k].double()),
                          exact).mean().item()}
    assert all(abs(b) <= 0.5 for b in biases.values()), biases
    assert max(biases.values()) - min(biases.values()) <= 0.2, biases
