from repro_torch.kernels.radix_select.kernel import (  # noqa: F401
    radix_select,
    radix_topk,
)
