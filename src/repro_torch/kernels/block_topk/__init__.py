from repro_torch.kernels.block_topk.ops import block_topk, block_topk_batched  # noqa: F401
