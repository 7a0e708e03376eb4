"""The MoE FFN (models/moe.py) and an MoE LM's serving on the card. Marked
``cuda``: without a GPU every test here skips. Imports no JAX.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_cuda.py

- A group's output does not depend on the other groups of the call: at
  olmoe-1b-7b's width (d 2048, 64 experts, top 8, d_expert 1024, groups of
  1024, bf16) the groups shared by a call of 64 groups and one of 62 give
  bit-equal outputs. The router's fp32 product runs one GEMM a group for
  this: one GEMM over all G*g rows sums in an order that depends on G*g on
  the card, and a last-bit change of a router logit can move a token to
  another expert.
- fp32 on the card against the CPU, each branch: outputs within 1e-4
  relative plus 1e-4 of the largest |y| (the same arithmetic in another
  summation order), the dropped share exactly, the aux loss within 1e-5.
- A small MoE LM's decode step keeps the cache's storage, launches no
  flash kernel and never waits for the card (a sync raises under
  sync_debug_mode "error").
- A small MoE LM's lm_loss through the flash kernel under remat "full"
  against "none": the backward's recompute routes each layer as its
  forward did (the routed and kept masks equal), so the losses, the aux
  term and the dropped shares are equal and every gradient leaf agrees
  within 1e-3 of its largest |g| (the embedding's backward adds with
  atomics, in an order that varies).
"""

import dataclasses

import pytest
import torch

from repro_torch.common.treemath import tree_leaves, tree_map
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import lm, moe

OLMOE = get_arch("olmoe-1b-7b").model_cfg


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(cfg, generator, device):
    params = moe.init_moe(generator, cfg.d_model, cfg.moe, 1, device=device)
    return {k: v[0] for k, v in params.items()}


@pytest.mark.cuda
def test_group_outputs_do_not_depend_on_the_group_count(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    lp = _layer(OLMOE, g, dev)
    x = torch.randn((64 * 1024, OLMOE.d_model), generator=g, device=dev).to(torch.bfloat16)
    keep = torch.cat([torch.arange(0, 31 * 1024), torch.arange(32 * 1024, 63 * 1024)]).to(dev)
    full, m_full = moe.moe_ffn(lp, x, OLMOE.moe)
    part, m_part = moe.moe_ffn(lp, x[keep], OLMOE.moe)
    assert float(m_full["moe_dropped_frac"]) > 0
    torch.testing.assert_close(full[keep], part, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,vectorize", [(64, True), (256, True), (256, False)],
                         ids=["one_group", "vectorized", "scan"])
def test_moe_ffn_on_the_card_matches_the_cpu_fp32(dev, t, vectorize):
    cfg = moe.MoEConfig(n_experts=16, top_k=4, d_expert=128, capacity_factor=1.0,
                        group_size=64, vectorize_groups=vectorize)
    lp = {k: v[0] for k, v in moe.init_moe(torch.Generator().manual_seed(1), 256, cfg, 1,
                                           device="cpu").items()}
    x = torch.randn((t, 256), generator=torch.Generator().manual_seed(2))
    want, m_want = moe.moe_ffn(lp, x, cfg)
    got, m_got = moe.moe_ffn(tree_map(lambda w: w.to(dev), lp), x.to(dev), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
    assert float(m_want["moe_dropped_frac"]) > 0
    assert float(m_got["moe_dropped_frac"]) == float(m_want["moe_dropped_frac"])
    torch.testing.assert_close(m_got["moe_aux_loss"].cpu(), m_want["moe_aux_loss"],
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_moe_decode_writes_the_cache_in_place_without_a_host_sync(dev):
    cfg = dataclasses.replace(OLMOE, n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                              vocab_size=1024, attention_impl="pallas",
                              moe=dataclasses.replace(OLMOE.moe, d_expert=128))
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, 1024, (2, 520), generator=torch.Generator(device=dev).manual_seed(3),
                           device=dev)
    cache, _ = lm.prefill(params, cfg, tokens[:, :512], max_seq=1024)
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr())
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(512, 520):
            cache, logits = lm.decode_step(params, cfg, cache, tokens[:, t])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (cache.k.data_ptr(), cache.v.data_ptr()) == ptrs
    assert ops.flash_attention.launches == 0
    assert cache.length.tolist() == [520, 520] and bool(torch.isfinite(logits.float()).all())


@pytest.mark.cuda
def test_moe_lm_loss_under_full_remat_equals_no_remat(dev, monkeypatch):
    cfg = dataclasses.replace(OLMOE, n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                              vocab_size=1024, attention_impl="pallas",
                              moe=dataclasses.replace(OLMOE.moe, d_expert=128, group_size=256))
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, 1024, (2, 512), generator=torch.Generator(device=dev).manual_seed(4),
                           device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    targets[:, -1] = -1
    route, calls = moe._route, []

    def recorded(*args):
        out = route(*args)
        calls.append((out[3].bool(), out[4].bool()))        # routed and kept masks
        return out

    monkeypatch.setattr(moe, "_route", recorded)
    runs = {}
    for remat in ("none", "full"):
        calls.clear()
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, aux = lm.lm_loss(leaves, dataclasses.replace(cfg, remat=remat), tokens, targets)
        loss.backward()
        runs[remat] = (loss.item(), aux["moe_aux"].item(), list(calls),
                       [t.grad for t in tree_leaves(leaves)])
    (loss, moe_aux, none_calls, none_g), (f_loss, f_aux, full_calls, full_g) = (
        runs["none"], runs["full"])
    assert (f_loss, f_aux) == (loss, moe_aux)
    # the forward calls each layer's routing once, the backward's recompute
    # once more, the last layer first
    assert len(none_calls) == 2 and len(full_calls) == 4
    for i, (routed, kept) in enumerate(none_calls):
        for j, mask in ((0, routed), (1, kept)):
            assert torch.equal(full_calls[i][j], mask) and torch.equal(full_calls[3 - i][j], mask)
    dropped = [1.0 - kept.sum().item() / routed.sum().item() for routed, kept in none_calls]
    assert max(dropped) > 0
    for got, want in zip(full_g, none_g):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())
