from repro_torch.kernels.fused_topk.ops import fused_topk

__all__ = ["fused_topk"]
