from repro_torch.kernels.fused_infonce.ops import (
    fused_infonce_loss,
    fused_infonce_rows,
    fused_infonce_stats,
    merge_row_stats,
)

__all__ = ["fused_infonce_loss", "fused_infonce_rows", "fused_infonce_stats", "merge_row_stats"]
