from repro_torch.kernels.flash_attn import kernel, ops, ref  # noqa: F401
