from repro_torch.kernels.histogram import ops, ref  # noqa: F401
