"""Attention, as in ``repro.models.attention``: GQA over (batch, seq, heads,
head_dim) ("BSHD") tensors, three execution paths.

  * ``plain``   - one einsum pair over the full (Sq, Skv) logits.
  * ``chunked`` - online softmax over KV blocks, a Python loop over query
                  and KV blocks, so the live score tensor is (B, H,
                  q_chunk, kv_chunk). Without a kv_mask it goes through
                  ``flash_chunked_attention``, whose backward recomputes
                  the blocks instead of keeping them.
  * ``pallas``  - the hand-written flash kernel (kernels/flash_attention),
                  the port of the JAX package's Pallas kernel.

Logits are fp32 whatever the input type; masked positions get the finite
``NEG_INF``, so a row with no visible key averages all values instead of
giving NaN. The chunked paths start their running max at ``-inf`` as the
JAX package does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.precision import NEG_INF, STATS_DTYPE


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hk, D) -> (B, S, Hk*n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    b, s, hk, d = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, n_rep, d).reshape(b, s, hk * n_rep, d)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Skv, H, D) -> fp32 (B, H, Sq, Skv) scaled logits."""
    return torch.einsum("bqhd,bkhd->bhqk", q.to(STATS_DTYPE), k.to(STATS_DTYPE)) * scale


def plain_attention(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Skv, Hk, D)
    v: torch.Tensor,           # (B, Skv, Hk, D)
    *,
    causal: bool = False,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_mask: Optional[torch.Tensor] = None,   # (B, Skv) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    hk = k.shape[2]
    k = _repeat_kv(k, h // hk)
    v = _repeat_kv(v, h // hk)
    scale = scale if scale is not None else d ** -0.5
    logits = _scores(q, k, scale)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, NEG_INF)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _chunks(sq: int, skv: int, q_chunk: int, kv_chunk: int):
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(
            f"sequence lengths must be multiples of their chunks: Sq={sq} q_chunk="
            f"{q_chunk}, Skv={skv} kv_chunk={kv_chunk}"
        )
    return q_chunk, kv_chunk


def _block_logits(qb, kb, scale, causal, qi0, ki0):
    """fp32 (B, H, qc, kc) logits of one block, causal-masked."""
    s = _scores(qb, kb, scale)
    if causal:
        rows = qi0 + torch.arange(qb.shape[1], device=qb.device)[:, None]
        cols = ki0 + torch.arange(kb.shape[1], device=qb.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    return_lse: bool = False,
):
    """Memory-efficient attention: for each query block, a loop over KV
    blocks carries a running (max, sum-exp, weighted value) accumulator.
    Returns the output in q's type and, with ``return_lse``, the fp32 (B,
    Sq, H) log-sum-exp of each row. Plain autodiff through this keeps every
    block's probabilities for the backward; training uses
    ``flash_chunked_attention``."""
    b, sq, h, d = q.shape
    hk, skv = k.shape[2], k.shape[1]
    k = _repeat_kv(k, h // hk)
    v = _repeat_kv(v, h // hk)
    scale = scale if scale is not None else d ** -0.5
    q_chunk, kv_chunk = _chunks(sq, skv, q_chunk, kv_chunk)
    outs, lses = [], []
    for qi0 in range(0, sq, q_chunk):
        qb = q[:, qi0 : qi0 + q_chunk]
        m_run = torch.full((b, h, q_chunk), float("-inf"), dtype=STATS_DTYPE, device=q.device)
        l_run = torch.zeros((b, h, q_chunk), dtype=STATS_DTYPE, device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), dtype=STATS_DTYPE, device=q.device)
        for ki0 in range(0, skv, kv_chunk):
            kb, vb = k[:, ki0 : ki0 + kv_chunk], v[:, ki0 : ki0 + kv_chunk]
            logits = _block_logits(qb, kb, scale, causal, qi0, ki0)
            if kv_mask is not None:
                logits = logits.masked_fill(~kv_mask[:, None, None, ki0 : ki0 + kv_chunk], NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.to(STATS_DTYPE))
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-30)
        outs.append((acc / l_safe[..., None]).transpose(1, 2).to(q.dtype))
        lses.append((m_run + torch.log(l_safe)).transpose(1, 2))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=1)) if return_lse else out


# ---------------------------------------------------------------------------
# Flash-style training attention: a blockwise-recomputing backward. Autograd
# through ``chunked_attention`` keeps each (q block x kv block) probability
# tile for the backward, O(S^2) per layer; this backward recomputes the tiles
# from (q, k, v, out, lse), so what is kept is O(S * D).
# ---------------------------------------------------------------------------
class _FlashChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_chunk, kv_chunk):
        out, lse = chunked_attention(
            q, k, v, causal=causal, scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk,
            return_lse=True,
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(*ctx.cfg, q, k, v, out, lse, g)
        return dq, dk, dv, None, None, None, None


def _flash_bwd(causal, scale, q_chunk, kv_chunk, q, k, v, out, lse, g):
    b, sq, h, d = q.shape
    hk, skv = k.shape[2], k.shape[1]
    n_rep = h // hk
    sc = scale if scale is not None else d ** -0.5
    q_chunk, kv_chunk = _chunks(sq, skv, q_chunk, kv_chunk)
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    g = g.to(STATS_DTYPE)
    delta = torch.einsum("bqhd,bqhd->bqh", g, out.to(STATS_DTYPE))   # (B, Sq, H)
    q_starts, kv_starts = range(0, sq, q_chunk), range(0, skv, kv_chunk)

    def block(qi0, ki0):
        """p and ds of one (q block, kv block): fp32 (B, H, qc, kc)."""
        qi, gi = q[:, qi0 : qi0 + q_chunk], g[:, qi0 : qi0 + q_chunk]
        ki, vi = kr[:, ki0 : ki0 + kv_chunk], vr[:, ki0 : ki0 + kv_chunk]
        s = _block_logits(qi, ki, sc, causal, qi0, ki0)
        p = torch.exp(s - lse[:, qi0 : qi0 + q_chunk].transpose(1, 2)[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", gi, vi.to(STATS_DTYPE))
        ds = p * (dp - delta[:, qi0 : qi0 + q_chunk].transpose(1, 2)[..., None]) * sc
        return p, ds

    # pass 1: dq, each q block over the kv blocks
    dq = []
    for qi0 in q_starts:
        dq_acc = torch.zeros((b, q_chunk, h, d), dtype=STATS_DTYPE, device=q.device)
        for ki0 in kv_starts:
            _, ds = block(qi0, ki0)
            dq_acc = dq_acc + torch.einsum(
                "bhqk,bkhd->bqhd", ds, kr[:, ki0 : ki0 + kv_chunk].to(STATS_DTYPE))
        dq.append(dq_acc)
    dq = torch.cat(dq, dim=1).to(q.dtype)

    # pass 2: dk, dv, each kv block over the q blocks
    dk, dv = [], []
    for ki0 in kv_starts:
        dk_acc = torch.zeros((b, kv_chunk, h, d), dtype=STATS_DTYPE, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qi0 in q_starts:
            p, ds = block(qi0, ki0)
            dv_acc = dv_acc + torch.einsum("bhqk,bqhd->bkhd", p, g[:, qi0 : qi0 + q_chunk])
            dk_acc = dk_acc + torch.einsum(
                "bhqk,bqhd->bkhd", ds, q[:, qi0 : qi0 + q_chunk].to(STATS_DTYPE))
        dk.append(dk_acc)
        dv.append(dv_acc)
    dk, dv = torch.cat(dk, dim=1), torch.cat(dv, dim=1)
    # GQA: fold the repeated query-head groups back onto the kv heads
    if n_rep > 1:
        dk = dk.reshape(b, skv, hk, n_rep, d).sum(3)
        dv = dv.reshape(b, skv, hk, n_rep, d).sum(3)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """GQA attention with the flash memory profile in both directions. No
    kv_mask (the training paths are causal or unmasked); masked inference
    uses ``chunked_attention``."""
    return _FlashChunkedAttention.apply(q, k, v, causal, scale, q_chunk, kv_chunk)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D): one new token
    k_cache: torch.Tensor,  # (B, S, Hk, D)
    v_cache: torch.Tensor,  # (B, S, Hk, D)
    *,
    cache_len: Union[int, torch.Tensor],   # (B,) or scalar: valid prefix length
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One token against a KV cache whose first ``cache_len`` rows are valid."""
    skv = k_cache.shape[1]
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    mask = torch.arange(skv, device=q.device)[None, :] < cache_len
    return plain_attention(q, k_cache, v_cache, kv_mask=mask, scale=scale)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "chunked",
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    if impl == "plain":
        return plain_attention(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale)
    if impl == "chunked":
        if kv_mask is None:
            # differentiable path with the flash memory profile in both directions
            return flash_chunked_attention(q, k, v, causal, scale, q_chunk, kv_chunk)
        return chunked_attention(
            q, k, v, causal=causal, kv_mask=kv_mask, scale=scale,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as flash_ops

        return flash_ops.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
