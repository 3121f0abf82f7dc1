from repro_torch.kernels.fused_sync.ops import (  # noqa: F401
    fused_pack_phi,
    select_topk_rows,
)
