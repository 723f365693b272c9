from repro_torch.kernels.sparse_score.ops import sparse_score, sparse_score_batched  # noqa: F401
