"""95th percentile of how late the load generator sent each request after
its due time."""
from portbench.stats import percentile


def read(run):
    return percentile(run.records.get("late_ms", ()), 95)
