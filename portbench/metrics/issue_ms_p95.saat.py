"""95th percentile of the server's host time a batch outside its device
sync: the program's ``server.search_batch`` span less its ``server.sync``
child, ms."""
from portbench.program_spans import children_ms
from portbench.stats import percentile


def read(run):
    found = children_ms(run, "server.search_batch", "server.sync")
    return None if found is None else percentile(found[0] - found[1], 95)
