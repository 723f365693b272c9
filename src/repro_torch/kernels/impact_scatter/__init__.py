from repro_torch.kernels.impact_scatter.ops import impact_scatter, impact_scatter_batched  # noqa: F401
