"""Phase-2 trips of a batch (``WorkStats.chunks``, the batch's largest),
mean over the window's batches."""
from portbench.stats import mean


def read(run):
    return mean(run.records.get("trips_max", ()))
