"""95th percentile of the admission queue's flush (the program's
``queue.flush`` span: a flush's entry to its completions built), ms."""
from portbench.program_spans import host_ms
from portbench.stats import percentile


def read(run):
    ms = host_ms(run, "queue.flush")
    return None if ms is None else percentile(ms, 95)
