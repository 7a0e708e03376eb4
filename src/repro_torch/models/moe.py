"""Mixture-of-experts FFN, as ``repro.models.moe``: token-choice top-k
routing with capacity dispatch (GShard/Switch style, MaxText's "dropping"
strategy).

Tokens are processed in groups of ``group_size``. Within a group a router
in fp32 picks each token's ``top_k`` experts; a k-hot dispatch tensor
(group, experts, capacity) routes the tokens into per-expert buffers of
``capacity`` slots by one einsum, the experts run as batched einsums over
the expert dim, and a combine einsum (the dispatch weighted by the gates,
rounded to the compute dtype first, as JAX rounds them) returns their
weighted outputs. A token past its expert's capacity in its group is
dropped for that expert. The formulation is JAX's, op for op: the dispatch
and combine stay dense one-hot einsums and no Pallas kernel is involved.

The three branches of ``moe_ffn`` are JAX's: one group; every group as one
batched chain (``vectorize_groups``, the default); and the groups one at a
time (JAX's ``lax.scan``, here a Python loop). All three run one body,
``_moe_groups_batched``: one group is its G = 1 case, and the loop feeds
it one group at a time. Where JAX asserts that the token count divides
into groups, the port raises ``ValueError``.

Each layer's params are ``router`` (d, E), ``w_gate`` and ``w_up`` (E, d,
f) and ``w_down`` (E, f, d); ``init_moe`` stacks them on a leading
``n_layers`` axis, JAX's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.models.layers import swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # expert hidden (a.k.a. moe_intermediate)
    capacity_factor: float = 1.25
    group_size: int = 1024         # tokens per dispatch group
    router_aux_weight: float = 0.01
    normalize_top_k: bool = True   # qwen3/mixtral-style renormalization
    vectorize_groups: bool = True  # every group in one batched chain, else a loop


def init_moe(
    generator: torch.Generator,
    d_model: int,
    cfg: MoEConfig,
    n_layers: int,
    param_dtype: torch.dtype = torch.float32,
    device: Union[None, str, torch.device] = "cuda",
):
    """Random MoE weights, each (n_layers, ...) normal over sqrt(fan in),
    drawn from ``generator`` on its own device and placed on ``device``
    (CUDA unless ``device="cpu"``); ``device="meta"`` draws nothing."""
    meta = device is not None and torch.device(device).type == "meta"
    device = torch.device("meta") if meta else resolve_device(device)
    draw_on = device if meta else generator.device
    e, f = cfg.n_experts, cfg.d_expert

    def stack(shape, fan_in):
        w = torch.randn((n_layers,) + shape, generator=generator, device=draw_on)
        return w.mul_(fan_in ** -0.5).to(device=device, dtype=param_dtype)

    return {
        "router": stack((d_model, e), d_model),
        "w_gate": stack((e, d_model, f), d_model),
        "w_up": stack((e, d_model, f), d_model),
        "w_down": stack((e, f, d_model), f),
    }


def _capacity(group_size: int, cfg: MoEConfig) -> int:
    c = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def _route(router: torch.Tensor, xs: torch.Tensor, cfg: MoEConfig, cap: int):
    """Routing of groups xs (G, g, d): the fp32 softmax probs (G, g, E),
    the dispatch and combine tensors (G, g, E, C) in xs's dtype, the
    0/1 routed mask and the 0/1 kept mask (G, g, E)."""
    x32 = xs.to(torch.float32)
    # one product a group (JAX's "Ggd,de->Gge"), not one over all G*g
    # rows: the card sums a folded GEMM in an order that depends on its row
    # count, which would make a group's routing depend on the other groups
    logits = torch.bmm(x32, router.expand(x32.shape[0], -1, -1))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)             # (G, g, k)
    if cfg.normalize_top_k:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    khot = F.one_hot(top_i, cfg.n_experts).to(torch.float32)        # (G, g, k, E)
    gates = (khot * top_p[..., None]).sum(-2)                       # (G, g, E)
    mask = khot.sum(-2)                                             # (G, g, E) 0/1

    # each token's slot in its expert's buffer: the earlier tokens of the
    # same group routed there; a slot past the capacity drops the token
    pos = torch.cumsum(mask, dim=-2) - 1.0
    keep = mask * (pos < cap).to(torch.float32)
    # JAX's one_hot(pos, cap) * keep: no slot (-1) where a token is not
    # kept. Compared in fp32: bf16 holds no integer past 256 exactly.
    slot = torch.where(keep > 0, pos, -1.0)
    disp = (slot[..., None] == torch.arange(cap, dtype=slot.dtype, device=xs.device)).to(xs.dtype)
    combine = disp * gates[..., None].to(xs.dtype)
    return probs, disp, combine, mask, keep


def _experts(params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buffers xe (..., E, C, d), batched
    over E, in xe's dtype."""
    dt = xe.dtype
    h = swiglu(
        torch.einsum("...ecd,edf->...ecf", xe, params["w_gate"].to(dt)),
        torch.einsum("...ecd,edf->...ecf", xe, params["w_up"].to(dt)),
    )
    return torch.einsum("...ecf,efd->...ecd", h, params["w_down"].to(dt))


def _moe_groups_batched(params, xs: torch.Tensor, cfg: MoEConfig, cap: int):
    """Dispatch groups xs (G, g, d) as one batched einsum chain -> (their
    outputs (G, g, d), the mean aux term, the dropped share)."""
    router = params["router"].to(torch.float32)
    probs, disp, combine, mask, keep = _route(router, xs, cfg, cap)
    xe = torch.einsum("Ggec,Ggd->Gecd", disp, xs)
    y = torch.einsum("Ggec,Gecd->Ggd", combine, _experts(params, xe))
    # Switch load-balance terms: share routed to each expert, mean router prob
    aux = (cfg.n_experts * torch.sum(mask.mean(1) * probs.mean(1), dim=-1)).mean()
    dropped = 1.0 - keep.sum() / torch.clamp(mask.sum(), min=1.0)
    return y, aux, dropped


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, dict]:
    """x (T, d) flattened tokens -> (T, d), and the metrics
    ``moe_aux_loss`` (``router_aux_weight`` x the mean Switch load-balance
    term) and ``moe_dropped_frac``. params are one layer's (no leading L
    dim). Raises ``ValueError`` unless T is a multiple of the group,
    min(group_size, T)."""
    t, d = x.shape
    g = min(cfg.group_size, t)
    if t % g:
        raise ValueError(f"token count {t} not divisible by group size {g}")
    n_groups = t // g
    cap = _capacity(g, cfg)

    xs = x.reshape(n_groups, g, d)
    if n_groups == 1 or cfg.vectorize_groups:
        # one group is the batched chain at G = 1
        y, aux_mean, drop_mean = _moe_groups_batched(params, xs, cfg, cap)
    else:
        steps = [_moe_groups_batched(params, xg[None], cfg, cap) for xg in xs]
        ys, auxs, drops = zip(*steps)
        y = torch.cat(ys)
        aux_mean, drop_mean = torch.stack(auxs).mean(), torch.stack(drops).mean()
    out = y.reshape(t, d)

    metrics = {
        "moe_aux_loss": cfg.router_aux_weight * aux_mean,
        "moe_dropped_frac": drop_mean,
    }
    return out, metrics
