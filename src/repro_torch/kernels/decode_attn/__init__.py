from repro_torch.kernels.decode_attn import kernel, ref  # noqa: F401
