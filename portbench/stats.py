"""Latency arithmetic: a copy of the port's ``metrics/latency.py``
``summarize_latencies`` percentiles (numpy's linear interpolation)."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    x = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(x, q)) if x.size else None


def mean(values) -> float | None:
    x = np.asarray(list(values), dtype=np.float64)
    return float(x.mean()) if x.size else None
