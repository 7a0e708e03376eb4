"""The interface the towers return (the port's ``repro.core.types.DualEncoder``)."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class DualEncoder(NamedTuple):
    """Abstract dual encoder. ``params`` is a dict with keys 'query' and
    'passage' (which may alias for shared towers); the encode functions take
    the full params dict."""

    init: Callable[..., Any]                               # (generator, device) -> params
    encode_query: Callable[[Any, Any], torch.Tensor]       # (params, queries) -> (B, d)
    encode_passage: Callable[[Any, Any], torch.Tensor]     # (params, passages) -> (B, d)
    rep_dim: int
