from repro_torch.kernels.block_prune_csr.ops import block_prune_csr_batched  # noqa: F401
