"""Doc blocks a query's phase 2 scored (``WorkStats.blocks_scored``), as a
share of the index's blocks, mean over the window's queries, %: what
block-max skipping leaves to score."""
from portbench.stats import mean


def read(run):
    return mean(run.records.get("blocks_scored_pct", ()))
