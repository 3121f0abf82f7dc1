from repro_torch.kernels.sgdm.kernel import (  # noqa: F401
    sgdm_plain,
    sgdm_update,
    takes,
)
