from repro_torch.metrics.ir_metrics import mrr_at_k, recall_at_k  # noqa: F401
