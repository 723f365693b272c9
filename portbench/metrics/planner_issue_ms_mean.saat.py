"""The host's time a flush issuing SAAT's planner: the program's
``saat.plan``, ``saat.gather`` and ``saat.tile_sort`` spans, summed a
flush, mean over the window's flushes, ms. The host launches these phases'
ops one by one, and a flush's service waits on that issue."""
from portbench.program_spans import host_ms_per_group
from portbench.stats import mean


def read(run):
    ms = host_ms_per_group(run, ("saat.plan", "saat.gather", "saat.tile_sort"))
    return None if ms is None else mean(ms)
