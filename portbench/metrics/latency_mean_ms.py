"""Mean over every request of the window, due send time to result on the host."""
from portbench.stats import mean


def read(run):
    return mean(run.records.get("latency_ms", ()))
