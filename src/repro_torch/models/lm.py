"""Decoder-only causal LM, as ``repro.models.lm``: ``LMConfig``, ``init_lm``,
``_block``, ``_remat_wrap``, ``backbone``, ``encode_pooled`` (the backbone
of a retriever, GTR/E5 style), the LM head ``_head``, the chunked
next-token cross entropy ``lm_loss``, and serving: ``KVCache``,
``prefill`` and ``decode_step``.

Modern pre-norm transformer: RMSNorm, RoPE (split halves), GQA attention
through ``models.attention.attention`` (causal, no key mask), SwiGLU FFN or
the mixture-of-experts FFN of ``models.moe`` (``LMConfig.moe``), optional
QKV bias, optionally tied embeddings. Parameters are nested dicts
of tensors in the JAX package's layout, the per-layer weights stacked on a
leading ``n_layers`` axis under ``layers``, so ``compat.params_to_torch``
carries a JAX tree across unchanged.

``scan_layers`` picks ``lax.scan`` or an unrolled loop in the JAX package;
the port runs a Python loop over the layers for either value, so one config
drives both packages and the values do not depend on it. ``remat``:
"none" keeps every activation, "full" recomputes each layer in the backward
(``torch.utils.checkpoint``), "dots" keeps the projection matmuls' outputs
and recomputes the rest (selective checkpointing; JAX's
``dots_with_no_batch_dims_saveable``).

``lm_loss`` builds the logits ``loss_chunk`` positions of the sequence at a
time, each chunk under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``
of the scanned chunk), so neither (B, S, V) nor any chunk's (B, c, V)
logits are kept for the backward. Where JAX asserts ``S % c == 0`` the port
raises ``ValueError``.

``prefill`` allocates the (L, B, max_seq, Hk, Dh) cache once and each
layer writes its k and v into its slot as the loop goes (JAX stacks the
layers' k and v, then pads). ``decode_step`` writes the new token's k and v
into the cache in place, at ``length[0]`` for every row with the start
clamped to ``S_max - 1`` as ``dynamic_update_slice`` clamps it, through a
device index (no host sync a token): it consumes its input cache, as the
JAX decode cell donates it, and the cache it returns shares its storage.
Both run under ``torch.no_grad()``.

An MoE layer routes its tokens as JAX's does: the (B*S, d) tokens of a
forward or a prefill in groups of ``group_size``, the B tokens of a decode
step as one group, so a token's capacity drops depend on the tokens it is
grouped with. ``backbone`` returns the layers' mean ``moe_aux_loss``, which
``lm_loss`` adds to the token loss.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import NamedTuple, Optional, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.device import resolve_device
from repro_torch.core.precision import STATS_DTYPE
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    # execution
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "chunked"       # "plain" | "chunked" | "pallas" (models.attention)
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512                 # sequence chunk of lm_loss (ROADMAP A9b)
    remat: str = "full"                   # none | full | dots
    scan_layers: bool = True              # JAX: scan vs unrolled layers; the port loops either way

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.moe:
            ffn = d * self.moe.n_experts * self.moe.d_expert * 3 + d * self.moe.n_experts
        else:
            ffn = d * self.d_ff * 3
        per_layer = attn + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        ffn = d * self.moe.top_k * self.moe.d_expert * 3 + d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, S_max, Hk, Dh) in cfg.dtype
    v: torch.Tensor        # (L, B, S_max, Hk, Dh) in cfg.dtype
    length: torch.Tensor   # (B,) int32: the valid prefix


def init_lm(
    cfg: LMConfig,
    generator: torch.Generator,
    device: Union[None, str, torch.device] = "cuda",
):
    """Random weights drawn from ``generator`` on its own device and placed
    on ``device`` (CUDA unless ``device="cpu"``), in ``cfg.param_dtype``.
    ``device="meta"`` gives the tree's shapes and types, allocating and
    drawing nothing (a cell's stand-in inputs)."""
    meta = device is not None and torch.device(device).type == "meta"
    device = torch.device("meta") if meta else resolve_device(device)
    draw_on = device if meta else generator.device
    d, dh, h, hk = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    nl, pd = cfg.n_layers, cfg.param_dtype

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=draw_on) * std
        return w.to(device=device, dtype=pd)

    def stack(shape, fan_in):
        return normal((nl,) + shape, fan_in ** -0.5)

    def const(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    attn = {
        "wq": stack((d, h * dh), d),
        "wk": stack((d, hk * dh), d),
        "wv": stack((d, hk * dh), d),
        "wo": stack((h * dh, d), h * dh),
    }
    if cfg.qkv_bias:
        attn["bq"] = const((nl, h * dh), 0.0)
        attn["bk"] = const((nl, hk * dh), 0.0)
        attn["bv"] = const((nl, hk * dh), 0.0)
    if cfg.moe is not None:
        ffn = init_moe(generator, d, cfg.moe, nl, pd, device)
    else:
        ffn = {
            "w_gate": stack((d, cfg.d_ff), d),
            "w_up": stack((d, cfg.d_ff), d),
            "w_down": stack((cfg.d_ff, d), cfg.d_ff),
        }
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "layers": {
            "ln1": const((nl, d), 1.0),
            "ln2": const((nl, d), 1.0),
            "attn": attn,
            "ffn": ffn,
        },
        "final_norm": const((d,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return params


def _qkv(cfg: LMConfig, lp, x, cos, sin):
    """The attention's inputs of one block: RMSNorm, the q, k and v
    projections (with their biases under ``qkv_bias``) and RoPE. x (B, S, d)
    -> q (B, S, H, Dh), k and v (B, S, Hk, Dh)."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    dt = cfg.dtype
    y = L.rms_norm(lp["ln1"], x, eps=cfg.norm_eps)
    ap = lp["attn"]
    q = y @ ap["wq"].to(dt)
    k = y @ ap["wk"].to(dt)
    v = y @ ap["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    q = L.apply_rotary(q.reshape(b, s, h, dh), cos, sin)
    k = L.apply_rotary(k.reshape(b, s, hk, dh), cos, sin)
    return q, k, v.reshape(b, s, hk, dh)


def _out_ffn(cfg: LMConfig, lp, x, o):
    """The rest of one block: the output projection of the attention's o
    (B, S, H, Dh) onto the residual x (B, S, d), then the FFN: SwiGLU, or
    the MoE on the (B*S, d) tokens. Returns (x', the MoE's metrics, {}
    without MoE)."""
    b, s, d = x.shape
    dt = cfg.dtype
    x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"].to(dt)
    y = L.rms_norm(lp["ln2"], x, eps=cfg.norm_eps)
    fp = lp["ffn"]
    if cfg.moe is not None:
        ff, aux = moe_ffn(fp, y.reshape(b * s, d), cfg.moe)
        return x + ff.reshape(b, s, d), aux
    ff = L.swiglu(y @ fp["w_gate"].to(dt), y @ fp["w_up"].to(dt)) @ fp["w_down"].to(dt)
    return x + ff, {}


def _block(cfg: LMConfig, lp, x, cos, sin, *, kv_mask=None, causal=True):
    """One transformer block. lp: per-layer params (no leading L dim).
    x: (B, S, d). Returns (x', aux_metrics, (k, v))."""
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    o = attention(
        q, k, v,
        impl=cfg.attention_impl,
        causal=causal,
        kv_mask=kv_mask,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
    )
    x, aux = _out_ffn(cfg, lp, x, o)
    return x, aux, (k, v)


#: the matmuls with no batch dimension (each projection: activations x a
#: weight matrix, which torch runs as one mm); the attention's einsums are
#: batched (bmm) and recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: LMConfig, fn):
    """``fn`` under the config's remat policy while autograd records; as is
    otherwise (nothing to recompute)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kwargs = {}
    elif cfg.remat == "dots":
        kwargs = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)

    return wrapped


def _per_layer(tree, n: int) -> list:
    """The stacked (n, ...) leaves of ``tree`` as n per-layer trees. Each
    leaf is unbound once, so the backward of the n slices is one stack."""
    if isinstance(tree, Mapping):
        subs = {k: _per_layer(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def _layers(params, cfg: LMConfig, tokens: torch.Tensor, store_kv=None):
    """tokens (B, S) through the embedding, every layer (under the config's
    remat policy) and the final norm: ((B, S, d), the sum of the layers'
    ``moe_aux_loss``, 0 without MoE). ``store_kv(i, k, v)``, if given,
    takes layer i's (k, v) as the loop goes."""
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = L.rotary_embedding(torch.arange(tokens.shape[1], device=tokens.device), cfg.dh,
                                  cfg.rope_theta, cfg.dtype)

    def layer_fn(x, lp):
        x, aux, kv = _block(cfg, lp, x, cos, sin, causal=True)
        return x, aux.get("moe_aux_loss"), (kv if store_kv is not None else None)

    layer_fn = _remat_wrap(cfg, layer_fn)
    moe_aux = torch.zeros((), dtype=STATS_DTYPE, device=x.device)
    for i, lp in enumerate(_per_layer(params["layers"], cfg.n_layers)):
        x, aux, kv = layer_fn(x, lp)
        if aux is not None:
            moe_aux = moe_aux + aux
        if store_kv is not None:
            store_kv(i, *kv)
    return L.rms_norm(params["final_norm"], x, eps=cfg.norm_eps), moe_aux


def backbone(params, cfg: LMConfig, tokens: torch.Tensor, *, collect_cache: bool = False):
    """tokens (B, S) -> (final hidden states (B, S, d), the layers' mean MoE
    aux loss (0 without MoE), the stacked (k, v) of every layer with
    ``collect_cache`` else None)."""
    kv_list = []
    x, moe_aux = _layers(params, cfg, tokens,
                         (lambda i, k, v: kv_list.append((k, v))) if collect_cache else None)
    kvs = tuple(torch.stack(t) for t in zip(*kv_list)) if collect_cache else None
    return x, moe_aux / cfg.n_layers, kvs


def encode_pooled(params, cfg: LMConfig, tokens: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LM-as-retriever embedding (GTR/E5 style): the final hidden states
    mean-pooled over the valid positions (all of them without a mask)."""
    x, _, _ = backbone(params, cfg, tokens)
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def _head_weight(params, cfg: LMConfig) -> torch.Tensor:
    """(d, V) in the compute dtype: ``embed.T`` under ``tie_embeddings``,
    else ``lm_head``."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return w.to(cfg.dtype)


def _head(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits (..., V) in the compute dtype: bf16 logits are rounded to bf16,
    as JAX's are, before any caller widens them."""
    return x @ _head_weight(params, cfg)


def _chunk_loss(w: torch.Tensor, xc: torch.Tensor, tc: torch.Tensor):
    """(sum of the masked token losses, count of targets >= 0) of one chunk:
    xc (B, c, d), tc (B, c) with -1 for padding. The (B, c, V) fp32 logits
    live only inside this call."""
    logits = (xc @ w).to(STATS_DTYPE)
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.gather(logits, -1, torch.clamp(tc, min=0).long()[..., None])[..., 0]
    mask = (tc >= 0).to(STATS_DTYPE)
    return ((lse - pos) * mask).sum(), mask.sum()


def lm_loss(params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor):
    """Chunked next-token cross entropy. tokens, targets: (B, S); a target of
    -1 is padding (masked out). Returns (mean token loss + MoE aux,
    {"lm_loss", "moe_aux", "tokens"}). The logits are built ``loss_chunk``
    positions at a time, each chunk recomputed in the backward instead of
    kept (``torch.utils.checkpoint``), so (B, S, V) never materialises."""
    x, moe_aux, _ = backbone(params, cfg, tokens)
    b, s, _ = x.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"seq_len {s} is not a multiple of loss_chunk {c}")
    w = _head_weight(params, cfg)
    loss_sum = torch.zeros((), dtype=STATS_DTYPE, device=x.device)
    count = torch.zeros((), dtype=STATS_DTYPE, device=x.device)
    for i0 in range(0, s, c):
        xc, tc = x[:, i0 : i0 + c], targets[:, i0 : i0 + c]
        if torch.is_grad_enabled():
            part, n = checkpoint(_chunk_loss, w, xc, tc, use_reentrant=False)
        else:
            part, n = _chunk_loss(w, xc, tc)
        loss_sum, count = loss_sum + part, count + n
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss + moe_aux, {"lm_loss": loss, "moe_aux": moe_aux, "tokens": count}


@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens: torch.Tensor, *, max_seq: Optional[int] = None):
    """The KV cache of a prompt, tokens (B, S), and its last position's
    logits (B, V). The cache has ``max_seq`` slots (S when that is None or
    smaller, as in JAX): k and v are allocated once, each layer writes its
    (k, v) into rows [0, S) of its slot as the loop goes, rows past S are
    zero, and ``length`` is S."""
    b, s = tokens.shape
    shape = (cfg.n_layers, b, max(max_seq or s, s), cfg.n_kv_heads, cfg.dh)
    k_cache = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
    v_cache = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
    k_cache[:, :, s:].zero_()
    v_cache[:, :, s:].zero_()

    def store(i, k, v):
        k_cache[i, :, :s].copy_(k)
        v_cache[i, :, :s].copy_(v)

    x, _ = _layers(params, cfg, tokens, store)
    cache = KVCache(k_cache, v_cache, torch.full((b,), s, dtype=torch.int32, device=tokens.device))
    return cache, _head(params, cfg, x[:, -1:])[:, 0]


@torch.no_grad()
def decode_step(params, cfg: LMConfig, cache: KVCache, token: torch.Tensor):
    """One decode step: token (B,) -> (the cache with the token's k and v and
    ``length + 1``, its logits (B, V)). The input cache is consumed: each
    layer writes the token's (k, v) into ``cache.k`` and ``cache.v`` in
    place, at position ``length[0]`` for every row (clamped to
    ``S_max - 1``, as JAX's ``dynamic_update_slice`` clamps its start), and
    the returned cache shares their storage. Each row's RoPE position is
    its own ``length``; the attention sees its first ``length + 1`` rows.
    An MoE layer routes the step's B tokens as one group."""
    dt = cfg.dtype
    x = params["embed"][token[:, None]].to(dt)                       # (B, 1, d)
    pos = cache.length
    cos, sin = L.rotary_embedding(pos[:, None], cfg.dh, cfg.rope_theta, dt)
    at = pos[:1].long().clamp(0, cache.k.shape[2] - 1)               # on the device
    for i, lp in enumerate(_per_layer(params["layers"], cfg.n_layers)):
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        kc, vc = cache.k[i], cache.v[i]                               # (B, S_max, Hk, Dh)
        kc.index_copy_(1, at, k.to(kc.dtype))
        vc.index_copy_(1, at, v.to(vc.dtype))
        o = decode_attention(q, kc.to(dt), vc.to(dt), cache_len=pos + 1)
        x, _ = _out_ffn(cfg, lp, x, o)
    x = L.rms_norm(params["final_norm"], x, eps=cfg.norm_eps)
    return KVCache(cache.k, cache.v, cache.length + 1), _head(params, cfg, x)[:, 0]
