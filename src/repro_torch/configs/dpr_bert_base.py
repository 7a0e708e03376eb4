"""dpr-bert-base: the paper's retriever (two bert-base-uncased towers) and
the shapes of its cells, as in ``repro.configs.dpr_bert_base``: the
single-device training cells, the cross-device ones and the retrieval
cells, as dicts.

Not here yet: ``contrastive_16k`` (a pod-scale batch).
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
    remat="full",
)

#: the paper's geometry: N_total=128, N_local=8, K=16, N_mem=2048 (NQ).
#: ``method`` defaults to contaccum where a cell does not name one.
_PAPER = {"global_batch": 128, "bank_size": 2048, "q_len": 32, "p_len": 256, "n_hard": 1}

#: single-device training cells (kind "contrastive")
PAPER_BATCH = {**_PAPER, "accum_steps": 1}
PAPER_BATCH_FUSED = {**_PAPER, "accum_steps": 1, "loss_impl": "fused"}
PAPER_BATCH_BF16 = {**_PAPER, "accum_steps": 1, "precision": "bf16_banks"}
#: the paper's K=16 accumulation with bf16 banks and the fused loss kernels:
#: the cell ``chip_smoke.py`` trains
CONTACCUM_BF16 = {
    **_PAPER, "method": "contaccum", "accum_steps": 16,
    "precision": "bf16_banks", "loss_impl": "fused",
}
#: the paper's geometry + asynchronously mined hard negatives (mining/):
#: each query carries 8 extra passage columns published by the ANCE-style
#: background refresh; direct backprop, no banks
PAPER_BATCH_MINED = {
    **_PAPER, "method": "mined", "accum_steps": 1, "bank_size": 0, "mined_negatives": 8,
}
#: the paper's K=16 ContAccum with 4 mined columns a query on top of the
#: dual banks: the contaccum x mined composition mining exists for. The JAX
#: cell runs fp32 with the dense loss; ``chip_smoke.py`` trains it with
#: CONTACCUM_BF16's precision and loss kernels
CONTACCUM_MINED = {**_PAPER, "method": "contaccum", "accum_steps": 16, "mined_negatives": 4}
CONTCACHE_BATCH = {**_PAPER, "method": "contcache", "accum_steps": 16}
PREBATCH_CACHE_BATCH = {**_PAPER, "method": "prebatch_cache", "accum_steps": 16}

#: the cross-device cells: the batch and the memory banks sharded over the
#: data-parallel ranks (``shard_banks``: bank_size / D slots a rank), fp32
#: (no ``precision``). ``contaccum_xdev`` all-gathers the passage-bank
#: columns for every loss evaluation (a transient (bank_size, d) block a
#: rank), ``contaccum_xdev_ring`` streams the D shards around the ring
#: instead (``loss_comm='ring'``: O(bank_size * d / D), the same loss),
#: ``contcache_xdev`` is the full-batch rep-cache backprop over the sharded
#: banks. ``global_batch`` is the whole group's; ``chip_smoke.py`` trains
#: contaccum_xdev and contaccum_xdev_ring at one rank's share of it
_XDEV = {"global_batch": 2048, "bank_size": 8192, "q_len": 32, "p_len": 256, "n_hard": 1,
         "xdev": True, "shard_banks": True}
CONTACCUM_XDEV = {**_XDEV, "method": "contaccum", "accum_steps": 4, "loss_impl": "fused"}
CONTACCUM_XDEV_RING = {**CONTACCUM_XDEV, "loss_comm": "ring"}
CONTCACHE_XDEV = {**_XDEV, "method": "contcache", "accum_steps": 16}

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
