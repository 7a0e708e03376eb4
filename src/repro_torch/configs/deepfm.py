"""deepfm [recsys]: n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm
[arXiv:1703.04247]. 39 fields = criteo's 26 categorical + 13 dense features
bucketized to 1000 bins each (the paper's treatment of numeric fields)."""

from repro_torch.configs.base import ArchSpec, CRITEO_VOCABS, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(
    ArchSpec(
        arch_id="deepfm",
        family="recsys",
        model_cfg=RecsysConfig(
            name="deepfm",
            n_dense=0,
            vocab_sizes=CRITEO_VOCABS + (1000,) * 13,
            embed_dim=10,
            interaction="fm",
            top_mlp=(400, 400, 400),
        ),
        shapes=RECSYS_SHAPES,
    )
)
