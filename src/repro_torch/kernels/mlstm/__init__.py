from repro_torch.kernels.mlstm.ops import mlstm  # noqa: F401
