"""dlrm-mlperf [recsys]: MLPerf DLRM benchmark config (Criteo 1TB):
n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 interaction=dot [arXiv:1906.00091]."""

from repro_torch.configs.base import ArchSpec, CRITEO_VOCABS, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(
    ArchSpec(
        arch_id="dlrm-mlperf",
        family="recsys",
        model_cfg=RecsysConfig(
            name="dlrm-mlperf",
            n_dense=13,
            vocab_sizes=CRITEO_VOCABS,
            embed_dim=128,
            interaction="dot",
            bot_mlp=(512, 256, 128),
            top_mlp=(1024, 1024, 512, 256, 1),
        ),
        shapes=RECSYS_SHAPES,
    )
)
