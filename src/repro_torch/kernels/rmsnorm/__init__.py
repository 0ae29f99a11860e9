from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: F401
