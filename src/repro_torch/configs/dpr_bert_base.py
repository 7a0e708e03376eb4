"""dpr-bert-base: the paper's retriever (two bert-base-uncased towers) and
the shapes of its serving cells, as in ``repro.configs.dpr_bert_base``.

Only the retrieval cells are here; the training cells come with the training
slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models.bert import BertConfig

BERT_BASE = BertConfig(
    name="bert-base-uncased",
    n_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
    vocab_size=30522,
    max_position=512,
    dtype=torch.bfloat16,
)

#: online serving: one coalesced query batch against a 1M-passage index,
#: bf16 index rows (the policy's bank dtype), fp32 scores. The JAX cell
#: searches with the plain blocked matmul ("dense"); ``chip_smoke.py`` reads
#: these keys and serves through the fused kernel instead
SERVE_TOPK = {
    "n_queries": 32,
    "n_passages": 1 << 20,
    "top_k": 100,
    "q_len": 32,
    "search_impl": "dense",
    "precision": "bf16_banks",
}

#: the offline eval sweep: thousands of queries per pass through the fused
#: search kernel
EVAL_TOPK = {
    "n_queries": 2048,
    "n_passages": 1 << 20,
    "top_k": 100,
    "q_len": 32,
    "search_impl": "fused",
    "precision": "bf16_banks",
}
