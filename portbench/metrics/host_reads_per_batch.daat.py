"""Host reads of the device a batch's DAAT dispatch, mean over the sampled
batches the port's op recorder traced after the window."""
from portbench.stats import mean


def read(run):
    return mean(run.records.get("host_reads", ()))
