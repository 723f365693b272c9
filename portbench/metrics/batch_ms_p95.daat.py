"""95th percentile of the benchmark's span around each ``search_batch``."""
from portbench.stats import percentile


def read(run):
    return percentile(run.records.get("batch_ms", ()), 95)
