from repro_torch.kernels.mamba_scan.ops import ssd  # noqa: F401
