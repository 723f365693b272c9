"""The engine's work at the card's memory rate, its least time
(``roofline.py``), as a share of the busy time of every kernel in the
traced window, %. The cells the metric's entry lists choose the engine."""
from portbench.roofline import roofline_pct


def read(run):
    s = run.trace_summary
    if s is None or run.work_bytes is None:
        return None
    return roofline_pct(run.work_bytes, s.kernel_busy_s)
