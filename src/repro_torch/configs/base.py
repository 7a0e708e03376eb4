"""Config primitives, as ``repro.configs.base``: ``ArchSpec`` (an
architecture and its shape cells), the registry, and the per-family
shape-cell tables."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode | gnn_full | gnn_minibatch |
                       # gnn_mol | recsys_train | recsys_serve | recsys_retrieval |
                       # contrastive
    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                      # lm | bert | gnn | recsys
    model_cfg: Any
    shapes: Dict[str, ShapeCell]
    micro_batches: Dict[str, int] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def micro_batch(self, shape_name: str) -> int:
        return self.micro_batches.get(shape_name, 1)


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs():
    return sorted(_REGISTRY)


# ------------------------------------------------------------ LM shape cells
LM_SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeCell(
        "prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}
    ),
    "decode_32k": ShapeCell(
        "decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}
    ),
    "long_500k": ShapeCell(
        "long_500k", "decode", {"seq_len": 524288, "global_batch": 1}
    ),
}

# ----------------------------------------------------------- GNN shape cells
GNN_SHAPES: Dict[str, ShapeCell] = {
    "full_graph_sm": ShapeCell(
        "full_graph_sm",
        "gnn_full",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
    ),
    "minibatch_lg": ShapeCell(
        "minibatch_lg",
        "gnn_minibatch",
        {
            "n_nodes": 232965,
            "n_edges": 114615892,
            "batch_nodes": 1024,
            "fanouts": (15, 10),
            "d_feat": 602,
            "n_classes": 41,
        },
    ),
    "ogb_products": ShapeCell(
        "ogb_products",
        "gnn_full",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
    ),
    "molecule": ShapeCell(
        "molecule",
        "gnn_mol",
        {"n_nodes": 30, "n_edges": 64, "batch": 128},
    ),
}

# -------------------------------------------------------- recsys shape cells
RECSYS_SHAPES: Dict[str, ShapeCell] = {
    "train_batch": ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    "serve_p99": ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    "retrieval_cand": ShapeCell(
        "retrieval_cand", "recsys_retrieval", {"batch": 1, "n_candidates": 1_000_000}
    ),
}

# Criteo-1TB (MLPerf DLRM) per-field embedding cardinalities [arXiv:1906.00091]
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)
