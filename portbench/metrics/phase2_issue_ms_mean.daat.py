"""The host's time a batch in DAAT's phase-2 loop outside its host reads:
the program's ``daat.phase2`` span less the host time of its reads (the
launches and their bookkeeping), mean over the window's batches, ms."""
from portbench.program_spans import phase2
from portbench.stats import mean


def read(run):
    found = phase2(run)
    return None if found is None else mean(found[0] - found[1])
