"""95th percentile over every request of the window, from its due send time
to its result on the host."""
from portbench.stats import percentile


def read(run):
    return percentile(run.records.get("latency_ms", ()), 95)
