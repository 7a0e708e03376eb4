"""Recsys ranking models, as ``repro.models.recsys``: DLRM (dot
interaction), DCN-v2 (cross network), DeepFM (factorization machine branch).

All per-field tables are stacked into ONE table with per-field row offsets
(the stacked layout of the JAX package), and a lookup is a gather of that
table (``embedding_lookup``); multi-hot bags are a gather plus a masked mean
(``embedding_bag``). Neither calls the embedding-bag kernel, because the JAX
functions do not. Params are nested dicts (and lists of per-layer dicts) of
tensors in the JAX layout, so ``compat.py`` carries them across as they are.

A lookup past the table differs from JAX: ``jnp.take`` fills such rows with
NaN, torch indexing raises (a device assert on CUDA). Indices are per-field
local ids in [0, vocab), as every caller gives them.

Not yet ported: the multi-device lookups (``make_psum_scatter_lookup`` and a
``lookup_sharding`` other than None raise, ROADMAP A8). A ``lookup_fn`` the
caller passes is used, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.precision import STATS_DTYPE
from repro_torch.models.layers import dense_init

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int
    vocab_sizes: Tuple[int, ...]          # rows per sparse field
    embed_dim: int
    interaction: str                      # "dot" | "cross" | "fm"
    bot_mlp: Tuple[int, ...] = ()         # dense-feature tower (DLRM)
    top_mlp: Tuple[int, ...] = ()         # final tower (ends in 1 logit)
    n_cross_layers: int = 0               # DCN-v2
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # the JAX package's sharding constraint on the (B, F, D) lookup; only
    # None is ported (a mesh is ROADMAP A8)
    lookup_sharding: Any = None
    # an explicit lookup (table, flat_idx) -> (B, F, D), used when given
    lookup_fn: Any = None
    # stacked-table rows are padded to a multiple of this (the JAX package's
    # 256-way sharding); padding rows are never indexed
    row_pad_multiple: int = 512

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        raw = int(sum(self.vocab_sizes))
        m = self.row_pad_multiple
        return ((raw + m - 1) // m) * m if m else raw

    def field_offsets(self, device: Device = "cpu") -> torch.Tensor:
        """(n_sparse,) int32: each field's first row in the stacked table."""
        offs = np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]])
        return torch.as_tensor(offs, device=device).to(torch.int32)

    def param_count(self) -> int:
        n = self.total_rows * self.embed_dim
        dims_in = self._concat_dim()
        for mlp, d0 in ((self.bot_mlp, self.n_dense), (self.top_mlp, dims_in)):
            prev = d0
            for d in mlp:
                n += prev * d + d
                prev = d
        if self.interaction == "cross":
            x0 = self.n_dense + self.n_sparse * self.embed_dim
            n += self.n_cross_layers * (x0 * x0 + x0)
        return n

    def _concat_dim(self) -> int:
        """Input width of the top MLP."""
        f, d = self.n_sparse, self.embed_dim
        if self.interaction == "dot":
            n_items = f + 1  # embeddings + bottom-MLP output
            return (n_items * (n_items - 1)) // 2 + (self.bot_mlp[-1] if self.bot_mlp else 0)
        if self.interaction == "cross":
            x0 = self.n_dense + f * d
            return x0 + (self.top_mlp[-1] if self.top_mlp else 0)  # cross ++ deep
        if self.interaction == "fm":
            return f * d
        raise ValueError(self.interaction)


def _mlp_init(generator: torch.Generator, dims: Sequence[int], d_in: int, pd, device: Device):
    layers = []
    prev = d_in
    for d in dims:
        layers.append({
            "w": dense_init(generator, prev, d, dtype=pd, device=device),
            "b": torch.zeros((d,), dtype=pd, device=device),
        })
        prev = d
    return layers


def _mlp_apply(layers, x: torch.Tensor, *, final_relu: bool = False) -> torch.Tensor:
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < len(layers) - 1 or final_relu:
            x = torch.relu(x)
    return x


def init_recsys(generator: torch.Generator, cfg: RecsysConfig, *, device: Device):
    """Params drawn from ``generator`` (on ``device``): the stacked table
    uniform in [-0.05, 0.05), the MLPs by ``dense_init``, biases zero."""
    pd = cfg.param_dtype
    table = torch.rand((cfg.total_rows, cfg.embed_dim), generator=generator, device=device)
    params = {"table": table.mul_(0.1).sub_(0.05).to(pd)}   # in place: the table is the bulk
    if cfg.bot_mlp:
        params["bot"] = _mlp_init(generator, cfg.bot_mlp, cfg.n_dense, pd, device)
    if cfg.interaction == "cross":
        x0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        params["cross"] = [
            {"w": dense_init(generator, x0, x0, scale=0.1 / x0 ** 0.5, dtype=pd, device=device),
             "b": torch.zeros((x0,), dtype=pd, device=device)}
            for _ in range(cfg.n_cross_layers)
        ]
        params["deep"] = _mlp_init(generator, cfg.top_mlp, x0, pd, device)
        params["final"] = {
            "w": dense_init(generator, x0 + cfg.top_mlp[-1], 1, dtype=pd, device=device),
            "b": torch.zeros((1,), dtype=pd, device=device),
        }
    elif cfg.interaction == "fm":
        w_first = torch.randn((cfg.total_rows,), generator=generator, device=device) * 0.01
        params["w_first"] = w_first.to(pd)
        params["deep"] = _mlp_init(
            generator, tuple(cfg.top_mlp) + (1,), cfg.n_sparse * cfg.embed_dim, pd, device
        )
    else:  # dot
        params["top"] = _mlp_init(generator, cfg.top_mlp, cfg._concat_dim(), pd, device)
    return params


def _offsets(cfg: RecsysConfig, like: torch.Tensor) -> torch.Tensor:
    return cfg.field_offsets(like.device).to(like.dtype)


def embedding_lookup(params, cfg: RecsysConfig, sparse_idx: torch.Tensor) -> torch.Tensor:
    """(B, n_sparse) per-field indices -> (B, n_sparse, embed_dim). Indices
    are per-field local; the stacked-table offset is added here."""
    if cfg.lookup_sharding is not None:
        raise NotImplementedError("lookup_sharding is not yet ported to repro_torch (ROADMAP A8)")
    flat = sparse_idx + _offsets(cfg, sparse_idx)[None, :]
    if cfg.lookup_fn is not None:
        return cfg.lookup_fn(params["table"], flat).to(cfg.dtype)
    return params["table"][flat.long()].to(cfg.dtype)


def make_psum_scatter_lookup(*args, **kwargs):
    """The JAX package's explicit-collective lookup over a mesh."""
    raise NotImplementedError(
        "make_psum_scatter_lookup (a lookup over a device mesh) is not yet ported to "
        "repro_torch (ROADMAP A8)"
    )


def embedding_bag(params, cfg: RecsysConfig, multi_hot: torch.Tensor, lengths: torch.Tensor):
    """Multi-hot bags: (B, F, L) indices + (B, F) valid lengths -> mean-pooled
    (B, F, D): gather + masked mean, as in JAX."""
    b, f, l = multi_hot.shape
    flat = multi_hot + _offsets(cfg, multi_hot)[None, :, None]
    vecs = params["table"][flat.long()].to(cfg.dtype)                  # (B, F, L, D)
    mask = (torch.arange(l, device=multi_hot.device)[None, None, :]
            < lengths[..., None]).to(cfg.dtype)
    s = (vecs * mask[..., None]).sum(2)
    return s / torch.clamp(mask.sum(2, keepdim=True)[..., 0][..., None], min=1.0)


def _dot_interaction(emb: torch.Tensor, bot: Optional[torch.Tensor]) -> torch.Tensor:
    """DLRM pairwise dots: emb (B, F, D) [+ bot (B, D)] -> (B, n_pairs [+D]).
    Pairs in row-major order of the upper triangle, as ``jnp.triu_indices``."""
    items = emb if bot is None else torch.cat([bot[:, None, :], emb], dim=1)
    f = items.shape[1]
    sims = torch.einsum("bfd,bgd->bfg", items, items)
    iu, ju = torch.triu_indices(f, f, 1, device=items.device)
    pairs = sims[:, iu, ju]
    return pairs if bot is None else torch.cat([bot, pairs], dim=-1)


def _cross_deep(params, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for lp in params["cross"]:
        x = x0 * (x @ lp["w"] + lp["b"]) + x
    deep = _mlp_apply(params["deep"], x0, final_relu=True)
    z = torch.cat([x, deep], dim=-1)
    return _mlp_apply([params["final"]], z)[:, 0]


def _fm(params, emb: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    s = emb.sum(1)
    fm2 = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
    deep = _mlp_apply(params["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    return first + fm2 + deep


def forward(params, cfg: RecsysConfig, dense: torch.Tensor, sparse_idx: torch.Tensor) -> torch.Tensor:
    """Per-example logits (B,)."""
    emb = embedding_lookup(params, cfg, sparse_idx)        # (B, F, D)
    dense = dense.to(cfg.dtype)
    if cfg.interaction == "dot":
        bot = _mlp_apply(params["bot"], dense, final_relu=True)
        z = _dot_interaction(emb, bot)
        return _mlp_apply(params["top"], z)[:, 0]
    if cfg.interaction == "cross":
        return _cross_deep(params, torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1))
    if cfg.interaction == "fm":
        flat_idx = sparse_idx + _offsets(cfg, sparse_idx)[None, :]
        first = params["w_first"][flat_idx.long()].sum(-1)
        return _fm(params, emb, first)
    raise ValueError(cfg.interaction)


def bce_loss(params, cfg: RecsysConfig, dense, sparse_idx, labels):
    """Mean binary cross entropy on the logits (fp32), and its accuracy."""
    logits = forward(params, cfg, dense, sparse_idx).to(STATS_DTYPE)
    labels = labels.to(STATS_DTYPE)
    loss = torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )
    acc = torch.mean(((logits > 0) == (labels > 0.5)).to(STATS_DTYPE))
    return loss, {"bce": loss, "accuracy": acc}


def score_candidates(
    params,
    cfg: RecsysConfig,
    dense: torch.Tensor,        # (1, n_dense) one user/query
    sparse_idx: torch.Tensor,   # (1, n_sparse) user-side fields
    cand_ids: torch.Tensor,     # (C,) candidate ids for field 0
) -> torch.Tensor:
    """The retrieval_cand shape: one query against C candidates, field 0's
    embedding swapped for each; the user side is looked up once."""
    emb_user = embedding_lookup(params, cfg, sparse_idx)   # (1, F, D)
    offs = _offsets(cfg, cand_ids)
    cand = params["table"][(cand_ids + offs[0]).long()].to(cfg.dtype)   # (C, D)
    c = cand.shape[0]
    emb = torch.cat([cand[:, None, :], emb_user[:, 1:, :].expand(c, -1, -1)], dim=1)
    dense_b = dense.to(cfg.dtype).expand(c, dense.shape[1])
    if cfg.interaction == "dot":
        bot = _mlp_apply(params["bot"], dense_b, final_relu=True)
        z = _dot_interaction(emb, bot)
        return _mlp_apply(params["top"], z)[:, 0]
    if cfg.interaction == "cross":
        return _cross_deep(params, torch.cat([dense_b, emb.reshape(c, -1)], dim=-1))
    # fm
    w_first = params["w_first"]
    first_user = w_first[(sparse_idx[0, 1:] + _offsets(cfg, sparse_idx)[1:]).long()].sum()
    first = first_user + w_first[(cand_ids + offs[0]).long()]
    return _fm(params, emb, first)
