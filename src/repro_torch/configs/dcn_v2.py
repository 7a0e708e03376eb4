"""dcn-v2 [recsys]: n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512 interaction=cross [arXiv:2008.13535]."""

from repro_torch.configs.base import ArchSpec, CRITEO_VOCABS, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(
    ArchSpec(
        arch_id="dcn-v2",
        family="recsys",
        model_cfg=RecsysConfig(
            name="dcn-v2",
            n_dense=13,
            vocab_sizes=CRITEO_VOCABS,
            embed_dim=16,
            interaction="cross",
            n_cross_layers=3,
            top_mlp=(1024, 1024, 512),
        ),
        shapes=RECSYS_SHAPES,
    )
)
