"""Dual encoders binding backbones to the core DualEncoder interface
(``repro.models.towers``): the paper's BERT towers, each giving the raw
final-layer [CLS] representation, and the LM-retriever variant (GTR/E5
style), a causal-LM backbone with mean pooling. Both give params
``{"query": ..., "passage": ...}``."""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.precision import apply_compute_dtype
from repro_torch.core.types import DualEncoder
from repro_torch.models.bert import BertConfig, bert_encode, init_bert
from repro_torch.models.lm import LMConfig, encode_pooled, init_lm


def _as_tokens(batch):
    """Batches may be {'tokens': ..., 'mask': ...} dicts or token tensors."""
    if isinstance(batch, dict):
        return batch["tokens"], batch.get("mask")
    return batch, None


def make_bert_dual_encoder(
    cfg: BertConfig, *, shared: bool = False, precision=None
) -> DualEncoder:
    """``precision`` (a PrecisionPolicy or preset name) rebinds the towers'
    dtypes via ``BertConfig.with_precision``: params stored fp32, activations
    and the emitted representations in ``compute_dtype``. None keeps cfg's."""
    if precision is not None:
        cfg = cfg.with_precision(precision)

    def init(generator: torch.Generator, device: Union[str, torch.device]):
        q = init_bert(cfg, generator, device)
        p = q if shared else init_bert(cfg, generator, device)
        return {"query": q, "passage": p}

    def encode_query(params, batch):
        tokens, mask = _as_tokens(batch)
        return bert_encode(params["query"], cfg, tokens, mask)

    def encode_passage(params, batch):
        tokens, mask = _as_tokens(batch)
        return bert_encode(params["passage"], cfg, tokens, mask)

    def compute_copy(params):
        """Each tower's layer weights in the compute dtype (the layers cast
        them to it before any use, so the copy gives the same reps) and its
        embedding tables as stored (they are summed before the cast)."""
        return {
            tower: {
                "embed": {k: v.detach().clone() for k, v in tp["embed"].items()},
                "layers": {k: v.detach().to(cfg.dtype, copy=True)
                           for k, v in tp["layers"].items()},
            }
            for tower, tp in params.items()
        }

    return DualEncoder(
        init=init,
        encode_query=encode_query,
        encode_passage=encode_passage,
        rep_dim=cfg.d_model,
        compute_copy=compute_copy,
    )


def make_lm_dual_encoder(
    cfg: LMConfig, *, shared: bool = True, precision=None
) -> DualEncoder:
    """LM-as-retriever: mean pooling over valid positions of a causal-LM
    backbone. ``shared=True`` (the default, as in JAX) gives both towers the
    same tensors at init; every update differentiates each tower's leaves
    apart (as JAX's pytrees do), so the towers part after the first step.
    ``init(generator, device="cuda")`` runs on CUDA unless given
    ``device="cpu"``. ``precision`` wraps the encoder with the generic
    compute-dtype caster (``core.precision.apply_compute_dtype``): LMConfig
    carries its own dtype, so the policy is applied at the DualEncoder
    boundary."""

    def init(generator: torch.Generator, device: Union[str, torch.device] = "cuda"):
        q = init_lm(cfg, generator, device)
        p = q if shared else init_lm(cfg, generator, device)
        return {"query": q, "passage": p}

    def encode_query(params, batch):
        tokens, mask = _as_tokens(batch)
        return encode_pooled(params["query"], cfg, tokens, mask)

    def encode_passage(params, batch):
        tokens, mask = _as_tokens(batch)
        return encode_pooled(params["passage"], cfg, tokens, mask)

    enc = DualEncoder(
        init=init,
        encode_query=encode_query,
        encode_passage=encode_passage,
        rep_dim=cfg.d_model,
    )
    return enc if precision is None else apply_compute_dtype(enc, precision)
