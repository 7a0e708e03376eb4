"""Architecture registry of the port: ``get_arch(arch_id)`` -> ArchSpec, as
``repro.configs``.

Registered: the LM archs internlm2-1.8b, stablelm-3b, qwen1.5-110b (dense),
olmoe-1b-7b and qwen3-moe-235b-a22b (MoE), whose train, prefill and decode
cells are ``launch/steps.py``'s (the two qwen archs are pod-scale: their
cells build on meta tensors only), and the four recsys archs (dcn-v2,
deepfm, dlrm-mlperf, dlrm-rm2). dpr-bert-base's towers and cells live in
``dpr_bert_base.py`` as plain dicts. Not yet ported: schnet (ROADMAP A9e).
"""

from repro_torch.configs.base import ArchSpec, ShapeCell, get_arch, list_archs, register

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    stablelm_3b,
    internlm2_1p8b,
    qwen1p5_110b,
    qwen3_moe_235b,
    olmoe_1b_7b,
    dcn_v2,
    deepfm,
    dlrm_mlperf,
    dlrm_rm2,
)

__all__ = ["ArchSpec", "ShapeCell", "get_arch", "register", "list_archs"]
