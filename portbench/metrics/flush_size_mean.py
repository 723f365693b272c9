"""Real requests a flush of the admission queue (``FlushRecord.n_real``), mean."""
from portbench.stats import mean


def read(run):
    return mean(run.records.get("flush_sizes", ()))
