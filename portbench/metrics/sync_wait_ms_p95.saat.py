"""95th percentile of the server's wait for the card at the end of a batch
(the program's ``server.sync`` span), ms."""
from portbench.program_spans import host_ms
from portbench.stats import percentile


def read(run):
    ms = host_ms(run, "server.sync")
    return None if ms is None else percentile(ms, 95)
