"""Hard-negative mining, the port of ``repro.mining``: the training<->serving
connector.

ANCE-style (Xiong et al. 2020) periodic re-encode + mining, run through the
port's retrieval stack *during* training:

  * ``MinerConfig`` (config.py): refresh cadence, mining depth, the
    teleportation trust region (Sun et al. 2022), and the passthrough axes
    (search backend / index layout / precision) of the ``RetrieverConfig``
    the miner builds its index with.
  * ``NegativeTable`` / ``NegativeTableBuffer`` (table.py): the
    double-buffered per-query id table the loader joins against;
    publication is one atomic reference swap.
  * ``HardNegativeMiner`` (miner.py): snapshots the training params,
    re-encodes the corpus into an ``IndexStore``, mines top-k per training
    query through the dense/fused ``SearchBackend`` (the ``fused_topk``
    kernel on the card), filters gold + applies teleportation banding, and
    publishes the table; on a worker thread, on CUDA on its own stream.

The mined ids enter training as extra ``passage_hard`` columns
(data/loader.py ``MinedNegativeInjector``), so ``negatives="mined"``
composes with every BackpropStrategy and with the dual memory banks
(core/step_program.py ``MinedNegatives``).
"""

from repro_torch.mining.config import MinerConfig
from repro_torch.mining.miner import HardNegativeMiner, teleport_filter
from repro_torch.mining.table import NegativeTable, NegativeTableBuffer, empty_table

__all__ = [
    "MinerConfig",
    "HardNegativeMiner",
    "NegativeTable",
    "NegativeTableBuffer",
    "empty_table",
    "teleport_filter",
]
