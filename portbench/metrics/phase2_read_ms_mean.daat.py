"""The host's time a batch blocked in DAAT's phase-2 host reads (the
``read`` tally of the program's ``daat.phase2`` span, each read a wait for
the card), summed a batch, mean over the window's batches, ms."""
from portbench.program_spans import phase2
from portbench.stats import mean


def read(run):
    found = phase2(run)
    return None if found is None else mean(found[1])
