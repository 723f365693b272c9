"""The host's time a flush issuing the fused scatter and top-k kernel (B1)
and its pool merge: the program's ``saat.b1`` span, mean over the window's
flushes, ms."""
from portbench.program_spans import host_ms_per_group
from portbench.stats import mean


def read(run):
    ms = host_ms_per_group(run, ("saat.b1",))
    return None if ms is None else mean(ms)
