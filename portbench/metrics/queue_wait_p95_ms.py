"""95th percentile of the admission queue's wait (``Completion.wait_ms``:
submit to flush)."""
from portbench.stats import percentile


def read(run):
    return percentile(run.records.get("queue_wait_ms", ()), 95)
