"""Queries answered over the window's time, first dispatch to last answer."""


def read(run):
    return run.records.get("queries_per_s")
