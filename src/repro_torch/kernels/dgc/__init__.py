from repro_torch.kernels.dgc import ops, ref  # noqa: F401
