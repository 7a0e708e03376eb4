"""BERT-base encoder, the paper's backbone (bert-base-uncased) for the DPR
dual encoder: post-LN transformer, learned positions, tanh-GELU FFN, biases
throughout, raw final-layer [CLS] as the representation (no pooler).

Parameters are nested dicts of tensors in the JAX package's layout, the
per-layer weights stacked on a leading ``n_layers`` axis, so carrying weights
across (compat.py) is a straight copy. ``attention_impl`` picks the
attention path of ``models.attention.attention`` ("plain", "chunked", or
"pallas": the hand-written flash kernel). Any ``remat`` other than "none"
runs each layer under ``torch.utils.checkpoint`` (the JAX package applies
``jax.checkpoint`` to the layer for every such value): its activations are
recomputed in the backward instead of kept; the values do not change.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.precision import PrecisionPolicy, resolve_precision
from repro_torch.models import layers as L
from repro_torch.models.attention import attention

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    name: str = "bert-base-uncased"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 30522
    max_position: int = 512
    type_vocab: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "plain"   # "plain" | "chunked" | "pallas" (models.attention)
    remat: str = "none"             # anything but "none": recompute each layer in the backward

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads

    def with_precision(self, policy: Union[str, PrecisionPolicy]) -> "BertConfig":
        """Bind a PrecisionPolicy: params stored in ``param_dtype``, cast to
        ``compute_dtype`` (``dtype``) at application; layer_norm keeps fp32
        internals."""
        policy = resolve_precision(policy)
        return dataclasses.replace(
            self, dtype=policy.compute_dtype, param_dtype=policy.param_dtype
        )


def init_bert(
    cfg: BertConfig,
    generator: torch.Generator,
    device: Union[str, torch.device],
) -> Params:
    """Random weights, drawn on the CPU from ``generator`` (so the same seed
    gives the same weights on any device) and placed on ``device``."""
    d, nl, pd = cfg.d_model, cfg.n_layers, cfg.param_dtype

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(device=device, dtype=pd)

    def stack(shape, fan_in):
        return normal((nl,) + shape, fan_in ** -0.5)

    def const(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    return {
        "embed": {
            "word": normal((cfg.vocab_size, d), 0.02),
            "pos": normal((cfg.max_position, d), 0.02),
            "type": normal((cfg.type_vocab, d), 0.02),
            "ln_s": const((d,), 1.0),
            "ln_b": const((d,), 0.0),
        },
        "layers": {
            "wqkv": stack((d, 3 * d), d),
            "bqkv": const((nl, 3 * d), 0.0),
            "wo": stack((d, d), d),
            "bo": const((nl, d), 0.0),
            "ln1_s": const((nl, d), 1.0),
            "ln1_b": const((nl, d), 0.0),
            "w1": stack((d, cfg.d_ff), d),
            "b1": const((nl, cfg.d_ff), 0.0),
            "w2": stack((cfg.d_ff, d), cfg.d_ff),
            "b2": const((nl, d), 0.0),
            "ln2_s": const((nl, d), 1.0),
            "ln2_b": const((nl, d), 0.0),
        },
    }


def bert_hidden(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, d). With no mask every
    position attends, padding included, as in the JAX package."""
    b, s = tokens.shape
    dt = cfg.dtype
    h, dh, d = cfg.n_heads, cfg.dh, cfg.d_model
    emb = params["embed"]
    x = (emb["word"][tokens] + emb["pos"][None, :s] + emb["type"][0][None, None]).to(dt)
    x = L.layer_norm(emb["ln_s"], emb["ln_b"], x, eps=cfg.norm_eps)
    # unbind once: the backward of the n_layers slices is one stack, not
    # n_layers full-size scatters
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}

    def layer(x, lp):
        lp = {name: w.to(dt) for name, w in lp.items()}
        qkv = x @ lp["wqkv"] + lp["bqkv"]
        q, k, v = (t.reshape(b, s, h, dh) for t in qkv.split(d, dim=-1))
        o = attention(q, k, v, impl=cfg.attention_impl, causal=False, kv_mask=mask)
        att = o.reshape(b, s, d) @ lp["wo"] + lp["bo"]
        x = L.layer_norm(lp["ln1_s"], lp["ln1_b"], x + att, eps=cfg.norm_eps)
        ff = L.gelu(x @ lp["w1"] + lp["b1"])
        ff = ff @ lp["w2"] + lp["b2"]
        return L.layer_norm(lp["ln2_s"], lp["ln2_b"], x + ff, eps=cfg.norm_eps)

    for i in range(cfg.n_layers):
        lp = {name: ws[i] for name, ws in layers.items()}
        if cfg.remat != "none" and torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = layer(x, lp)
    return x


def bert_encode(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[CLS] representation, (B, d): DPR's sentence embedding."""
    return bert_hidden(params, cfg, tokens, mask)[:, 0]
