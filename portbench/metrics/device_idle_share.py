"""Share of the traced window with no operation on the card, %."""


def read(run):
    s = run.trace_summary
    if s is None or s.busy_s <= 0 or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
