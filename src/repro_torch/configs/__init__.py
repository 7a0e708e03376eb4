"""Architecture registry of the port: ``get_arch(arch_id)`` -> ArchSpec, as
``repro.configs``.

Registered so far: the dense LM archs (internlm2-1.8b, stablelm-3b; their
train, prefill and decode cells are ``launch/steps.py``'s) and the four
recsys archs
(dcn-v2, deepfm, dlrm-mlperf, dlrm-rm2). dpr-bert-base's towers and cells
live in ``dpr_bert_base.py`` as plain dicts. Not yet ported: the other LM
archs (qwen1.5-110b, qwen3-moe-235b-a22b, olmoe-1b-7b; ROADMAP A9c) and
schnet (A9e).
"""

from repro_torch.configs.base import ArchSpec, ShapeCell, get_arch, list_archs, register

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    stablelm_3b,
    internlm2_1p8b,
    dcn_v2,
    deepfm,
    dlrm_mlperf,
    dlrm_rm2,
)

__all__ = ["ArchSpec", "ShapeCell", "get_arch", "register", "list_archs"]
