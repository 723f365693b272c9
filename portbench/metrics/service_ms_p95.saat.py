"""95th percentile of the benchmark's span around each flush's
``search_batch`` call (it ends in the server's device sync)."""
from portbench.stats import percentile


def read(run):
    return percentile(run.records.get("service_ms", ()), 95)
