"""The LM retriever's blocks with the flash kernel (``attention_impl="pallas"``)
against the same blocks with chunked attention, on the card, at
internlm2-1.8b's width (d_model 2048, 16 heads, 8 KV heads of 128, d_ff
8192) and the retriever's passes (B=8, S=32 and 256, causal, bf16); and
the causal-LM train cell (``lm_loss``, ``launch.steps._lm_train_program``)
at a small internlm2 (2 layers, d_model 256, its 16 heads and 8 KV heads
of 128, vocab 1024, S=512). Marked ``cuda``: without a GPU (and nvcc)
every test here skips. Imports no JAX.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py

Tolerances: the flash block's output may depart from the chunked block's no
further on average than the chunked bf16 block departs from its fp32 twin,
and no element further than that twin's largest departure plus one bf16
ulp of the largest |output| (the attention's probabilities are rounded to
bf16 per tile in the kernel and after normalising in the chunked path; the
rest of the block is the same ops). Gradients (the flash op's backward
recomputes through chunked attention): global norm within 2e-2 relative,
as chip_smoke.py holds a flash train step to a plain one. ``lm_loss``
through the flash kernel against chunked attention: the loss within 2e-3
relative and each gradient leaf within 2e-2 of its largest |g| (the
port's bf16 backward allowance; chip_smoke.py's lm_train phase holds the
full-width cell to the same). One fp32 train-cell step on the card against
the CPU: the loss within 1e-4 relative, AdamW's first moment (a tenth of
the clipped gradient) within 1e-4 of its largest entry, and the params
within 1e-4 relative plus 1e-3 of the largest move (a step moves a param
by about lr whatever the size of its gradient, so an element whose
gradient is near 0 may move either way). Serving (``prefill``,
``decode_step``) at the same small internlm2: fp32 chunked on the card
against the CPU, the caches and logits within 1e-4 relative plus 1e-4 of
their largest entry; bf16 through the flash kernel against chunked
attention, the prefill's cache and logits by the flash block's rule above
(the chunked bf16 run's departure from its fp32 twin, plus one bf16 ulp),
and the generation against one forward over the same tokens at
chip_smoke.py's lm_serve limits (mean |difference| 0.02, largest 0.25, on
logits of unit spread).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.common.treemath import tree_global_norm, tree_leaves, tree_map
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import steps
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.towers import make_lm_dual_encoder

GRAD_RTOL = 2e-2
INTERNLM2 = get_arch("internlm2-1.8b").model_cfg


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _block_out(cfg, lp, x, grad):
    """One block's output (B, S, d) and, with ``grad``, the gradients of
    sum(out * w) w.r.t. its params (w fixed, seeded)."""
    s = x.shape[1]
    cos, sin = L.rotary_embedding(torch.arange(s, device=x.device), cfg.dh, cfg.rope_theta,
                                  cfg.dtype)
    lp = {k: ({n: t.detach().requires_grad_(grad) for n, t in v.items()} if isinstance(v, dict)
              else v.detach().requires_grad_(grad)) for k, v in lp.items()}
    out, _, _ = lm._block(cfg, lp, x.to(cfg.dtype), cos, sin, causal=True)
    if not grad:
        return out.float(), None
    w = torch.randn(out.shape, generator=torch.Generator(device=x.device).manual_seed(3),
                    device=x.device)
    (out.float() * w).sum().backward()
    return out.detach().float(), tree_global_norm([t.grad for t in tree_leaves(lp)])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 256])
def test_internlm2_block_with_flash_matches_chunked(dev, s):
    cfg = dataclasses.replace(INTERNLM2, n_layers=1, dtype=torch.bfloat16)
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lp = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0])
          for k, v in params["layers"].items()}
    x = torch.randn((8, s, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    ops.reset_launches()
    flash, g_flash = _block_out(dataclasses.replace(cfg, attention_impl="pallas"), lp, x, True)
    assert ops.flash_attention.launches == ops.flash_attention.paths["hopper"] == 1
    plain, g_plain = _block_out(chunked, lp, x, True)
    fp32, _ = _block_out(dataclasses.replace(chunked, dtype=torch.float32), lp, x, False)
    assert bool(torch.isfinite(flash).all())
    diff, floor = (flash - plain).abs(), (plain - fp32).abs()
    ulp = 2.0 ** (math.floor(math.log2(plain.abs().max().item())) - 7)
    assert diff.mean() <= floor.mean(), (diff.mean().item(), floor.mean().item())
    assert diff.max() <= floor.max() + ulp, (diff.max().item(), floor.max().item(), ulp)
    assert abs(g_flash.item() - g_plain.item()) <= GRAD_RTOL * g_plain.item()


@pytest.mark.cuda
def test_lm_towers_launch_the_kernel_per_layer_on_the_hopper_path(dev):
    """An encode and its backward under remat="full": the kernel runs once
    a layer, and once more a layer in the backward's recompute, every launch
    on the bf16 Hopper path; the reps stay close to the chunked towers'."""
    cfg = dataclasses.replace(INTERNLM2, n_layers=2, d_model=512, n_heads=4, n_kv_heads=2,
                              d_ff=1024, vocab_size=1000, attention_impl="pallas", remat="full")
    enc = make_lm_dual_encoder(cfg, precision="bf16_banks")
    params = enc.init(torch.Generator(device=dev).manual_seed(0), dev)
    for t in tree_leaves(params["passage"]):
        t.requires_grad_(True)
    tokens = torch.randint(0, 1000, (8, 256), generator=torch.Generator(device=dev).manual_seed(2),
                           device=dev)
    ops.reset_launches()
    reps = enc.encode_passage(params, tokens)
    assert ops.flash_attention.launches == cfg.n_layers
    reps.float().square().sum().backward()
    assert ops.flash_attention.launches == ops.flash_attention.paths["hopper"] == 2 * cfg.n_layers
    assert reps.dtype == torch.bfloat16 and reps.shape == (8, 512)
    with torch.inference_mode():
        chunked = make_lm_dual_encoder(dataclasses.replace(cfg, attention_impl="chunked"),
                                       precision="bf16_banks").encode_passage(params, tokens)
    torch.testing.assert_close(reps.detach().float(), chunked.float(), rtol=0, atol=0.05)


LOSS_RTOL = 2e-3
SMALL_LM = dataclasses.replace(INTERNLM2, n_layers=2, d_model=256, d_ff=512, vocab_size=1024,
                               remat="full")
SMALL_CELL = ShapeCell("train_4k", "train", {"seq_len": 512, "global_batch": 8})


def _next_token_batch(shape, seed, device):
    tokens = torch.randint(0, SMALL_LM.vocab_size, shape,
                           generator=torch.Generator().manual_seed(seed), dtype=torch.int32)
    targets = torch.roll(tokens, -1, dims=-1)
    targets[..., -1] = -1
    return tokens.to(device), targets.to(device)


def _loss_and_grads(cfg, params, tokens, targets):
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = lm.lm_loss(leaves, cfg, tokens, targets)
    loss.backward()
    return loss.item(), [t.grad for t in tree_leaves(leaves)]


@pytest.mark.cuda
def test_lm_loss_with_flash_matches_chunked(dev):
    """The chunked LM loss and its gradient with the flash kernel (forward
    and remat recompute: 2 launches a layer, on the Hopper path) against
    chunked attention on the same card, params and tokens."""
    cfg = dataclasses.replace(SMALL_LM, attention_impl="pallas")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens, targets = _next_token_batch((4, 512), 1, dev)
    ops.reset_launches()
    loss, grads = _loss_and_grads(cfg, params, tokens, targets)
    assert ops.flash_attention.launches == ops.flash_attention.paths["hopper"] == 2 * cfg.n_layers
    want, want_grads = _loss_and_grads(dataclasses.replace(cfg, attention_impl="chunked"),
                                       params, tokens, targets)
    assert math.isfinite(loss) and abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    for g, w in zip(grads, want_grads):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= GRAD_RTOL * scale, ((g - w).abs().max().item(), scale)


@pytest.mark.cuda
def test_train_cell_step_on_the_card_matches_the_cpu_fp32(dev):
    """One step of the train cell (4 microbatches of 2) in fp32 with chunked
    attention, on the card and on the CPU from the same params."""
    arch = dataclasses.replace(get_arch("internlm2-1.8b"), model_cfg=dataclasses.replace(
        SMALL_LM, dtype=torch.float32, attention_impl="chunked"))
    states, metrics = [], []
    for device in (dev, torch.device("cpu")):
        prog = steps._lm_train_program(arch, SMALL_CELL, device)
        state = prog.init(torch.Generator().manual_seed(0))      # drawn on the CPU
        state, m = prog.fn(state, *_next_token_batch(tuple(prog.args[1].shape), 2, device))
        states.append(state)
        metrics.append(m["loss"].item())
    assert int(states[0].step) == 1
    assert abs(metrics[0] - metrics[1]) <= 1e-4 * abs(metrics[1]), metrics
    gpu, cpu = states
    start = lm.init_lm(arch.model_cfg, torch.Generator().manual_seed(0), "cpu")
    mu_gpu, mu_cpu = gpu.opt[1].mu, cpu.opt[1].mu
    for a, b in zip(tree_leaves(mu_gpu), tree_leaves(mu_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * b.abs().max().item())
    for a, b, p0 in zip(tree_leaves(gpu.params), tree_leaves(cpu.params), tree_leaves(start)):
        moved = (b - p0).abs().max().item()
        assert moved > 0
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-3 * moved)


@pytest.mark.cuda
def test_train_step_launches_the_kernel_per_layer_and_microbatch(dev):
    """A bf16 train step with the flash kernel under remat="full": n_layers
    x 2 (forward, recompute) x m launches, all on the Hopper path."""
    arch = dataclasses.replace(get_arch("internlm2-1.8b"),
                               model_cfg=dataclasses.replace(SMALL_LM, attention_impl="pallas"))
    prog = steps._lm_train_program(arch, SMALL_CELL, dev)
    m = prog.static_info["microbatches"]
    state = prog.init(torch.Generator(device=dev).manual_seed(0))
    ops.reset_launches()
    state, metrics = prog.fn(state, *_next_token_batch(tuple(prog.args[1].shape), 3, dev))
    want = SMALL_LM.n_layers * 2 * m
    assert ops.flash_attention.launches == ops.flash_attention.paths["hopper"] == want
    assert math.isfinite(metrics["loss"].item()) and int(state.step) == 1


SERVE_TF_MEAN, SERVE_TF_MAX = 0.02, 0.25


def _serve_tokens(b, s, seed, device):
    return torch.randint(0, SMALL_LM.vocab_size, (b, s), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed)).to(device)


def _generate(cfg, params, tokens, prompt, max_seq):
    """prefill of tokens[:, :prompt], then decode of the rest: the cache and
    the (B, 1 + S - prompt, V) logits in fp32."""
    cache, logits = lm.prefill(params, cfg, tokens[:, :prompt], max_seq=max_seq)
    out = [logits.float()]
    for t in range(prompt, tokens.shape[1]):
        cache, logits = lm.decode_step(params, cfg, cache, tokens[:, t])
        out.append(logits.float())
    return cache, torch.stack(out, 1)


@pytest.mark.cuda
def test_prefill_and_decode_on_the_card_match_the_cpu_fp32(dev):
    """prefill of 512 tokens into 520 slots, then four decode steps, fp32
    with chunked attention, on the card and on the CPU from the same params."""
    cfg = dataclasses.replace(SMALL_LM, dtype=torch.float32, attention_impl="chunked")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _serve_tokens(2, 516, 4, "cpu")
    got = _generate(cfg, tree_map(lambda t: t.to(dev), params), tokens.to(dev), 512, 520)
    want = _generate(cfg, params, tokens, 512, 520)
    for a, b in ((got[0].k, want[0].k), (got[0].v, want[0].v), (got[1], want[1])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    assert got[0].length.tolist() == want[0].length.tolist() == [516, 516]


@pytest.mark.cuda
def test_flash_prefill_matches_chunked_and_teacher_forcing(dev):
    """bf16: the prefill through the flash kernel (one launch a layer, on
    the Hopper path) against chunked attention, and prefill of 512 tokens
    plus 8 decode steps against one forward over 1024 tokens."""
    cfg = dataclasses.replace(SMALL_LM, attention_impl="pallas")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = _serve_tokens(4, 1024, 5, dev)
    ops.reset_launches()
    cache, logits = lm.prefill(params, cfg, tokens[:, :512])
    assert ops.flash_attention.launches == ops.flash_attention.paths["hopper"] == cfg.n_layers
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    want_cache, want_logits = lm.prefill(params, chunked, tokens[:, :512])
    fp32_cache, fp32_logits = lm.prefill(params, dataclasses.replace(chunked, dtype=torch.float32),
                                         tokens[:, :512])
    for got, want, twin in ((cache.k, want_cache.k, fp32_cache.k),
                            (cache.v, want_cache.v, fp32_cache.v),
                            (logits, want_logits, fp32_logits)):
        diff, floor = (got.float() - want.float()).abs(), (want.float() - twin).abs()
        ulp = 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
        assert diff.mean() <= floor.mean(), (diff.mean().item(), floor.mean().item())
        assert diff.max() <= floor.max() + ulp, (diff.max().item(), floor.max().item(), ulp)
    _, gen = _generate(cfg, params, tokens[:, :520], 512, 1024)
    with torch.no_grad():
        x, _, _ = lm.backbone(params, cfg, tokens)
        want = lm._head(params, cfg, x[:, 511:520]).float()
    diff = (gen - want).abs()
    assert bool(torch.isfinite(gen).all())
    assert diff.mean() <= SERVE_TF_MEAN and diff.max() <= SERVE_TF_MAX, (
        diff.mean().item(), diff.max().item())


@pytest.mark.cuda
def test_decode_writes_the_cache_in_place_without_a_host_sync(dev):
    """decode_step keeps the cache's storage, launches no flash kernel, and
    never waits for the card (a sync raises under sync_debug_mode "error")."""
    cfg = dataclasses.replace(SMALL_LM, attention_impl="pallas")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = _serve_tokens(2, 520, 6, dev)
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
def test_serve_cells_launch_the_kernel_once_a_layer(dev):
    """The prefill cell's fn: n_layers launches, all on the Hopper path; the
    decode cell's fn on its full cache (the write clamped to the last
    slot): none."""
    arch = dataclasses.replace(get_arch("internlm2-1.8b"),
                               model_cfg=dataclasses.replace(SMALL_LM, attention_impl="pallas"))
    pre = steps._lm_prefill_program(arch, ShapeCell("prefill_32k", "prefill",
                                                    {"seq_len": 512, "global_batch": 4}), dev)
    dec = steps._lm_decode_program(arch, ShapeCell("decode_32k", "decode",
                                                   {"seq_len": 512, "global_batch": 4}), dev)
    params = pre.init(torch.Generator(device=dev).manual_seed(0))
    tokens = _serve_tokens(4, 512, 7, dev)
    ops.reset_launches()
    cache, logits = pre.fn(params, tokens)
    assert ops.flash_attention.launches == ops.flash_attention.paths["hopper"] == SMALL_LM.n_layers
    cache, logits = dec.fn(params, cache, tokens[:, 0])
    assert ops.flash_attention.launches == SMALL_LM.n_layers
    assert logits.shape == (4, SMALL_LM.vocab_size) and cache.length.tolist() == [513] * 4
