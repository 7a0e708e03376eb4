"""Architecture registry of the port: ``get_arch(arch_id)`` -> ArchSpec, as
``repro.configs``.

Registered so far: the LM archs internlm2-1.8b, stablelm-3b (dense) and
olmoe-1b-7b (MoE), whose train, prefill and decode cells are
``launch/steps.py``'s, and the four recsys archs (dcn-v2, deepfm,
dlrm-mlperf, dlrm-rm2). dpr-bert-base's towers and cells live in
``dpr_bert_base.py`` as plain dicts. Not yet ported: the pod-scale LM archs
qwen1.5-110b and qwen3-moe-235b-a22b (dry-run configs, ROADMAP A10) and
schnet (A9e).
"""

from repro_torch.configs.base import ArchSpec, ShapeCell, get_arch, list_archs, register

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    stablelm_3b,
    internlm2_1p8b,
    olmoe_1b_7b,
    dcn_v2,
    deepfm,
    dlrm_mlperf,
    dlrm_rm2,
)

__all__ = ["ArchSpec", "ShapeCell", "get_arch", "register", "list_archs"]
