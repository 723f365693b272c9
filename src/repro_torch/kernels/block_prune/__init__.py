from repro_torch.kernels.block_prune.ops import block_prune, block_prune_batched  # noqa: F401
