"""Architecture registry of the port: ``get_arch(arch_id)`` -> ArchSpec, as
``repro.configs``.

Registered so far: the four recsys archs (dcn-v2, deepfm, dlrm-mlperf,
dlrm-rm2). dpr-bert-base's towers and cells live in ``dpr_bert_base.py`` as
plain dicts. Not yet ported: the LM archs (internlm2-1.8b, stablelm-3b,
qwen1.5-110b, qwen3-moe-235b-a22b, olmoe-1b-7b; ROADMAP A9a/A9c) and schnet
(A9e).
"""

from repro_torch.configs.base import ArchSpec, ShapeCell, get_arch, list_archs, register

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    dcn_v2,
    deepfm,
    dlrm_mlperf,
    dlrm_rm2,
)

__all__ = ["ArchSpec", "ShapeCell", "get_arch", "register", "list_archs"]
