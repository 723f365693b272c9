from repro_torch.metrics.ir_metrics import mrr_at_k, recall_at_k  # noqa: F401
from repro_torch.metrics.latency import LatencyStats, summarize_latencies  # noqa: F401
