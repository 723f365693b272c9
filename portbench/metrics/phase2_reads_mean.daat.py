"""Host reads a batch in DAAT's phase-2 loop (the ``read`` tally of the
program's ``daat.phase2`` span), mean over every batch of the window."""
from portbench.program_spans import phase2
from portbench.stats import mean


def read(run):
    found = phase2(run)
    return None if found is None else mean(found[2])
