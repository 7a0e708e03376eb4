"""dlrm-rm2 [recsys]: n_dense=13 n_sparse=26 embed_dim=64 bot=13-512-256-64
top=512-512-256-1 interaction=dot [arXiv:1906.00091]."""

from repro_torch.configs.base import ArchSpec, CRITEO_VOCABS, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(
    ArchSpec(
        arch_id="dlrm-rm2",
        family="recsys",
        model_cfg=RecsysConfig(
            name="dlrm-rm2",
            n_dense=13,
            vocab_sizes=CRITEO_VOCABS,
            embed_dim=64,
            interaction="dot",
            bot_mlp=(512, 256, 64),
            top_mlp=(512, 512, 256, 1),
        ),
        shapes=RECSYS_SHAPES,
    )
)
