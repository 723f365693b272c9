"""Prometheus-style serving counters: scrape-time export, zero hot-path cost.

A copy of ``repro.serving.counters`` (no imports beyond ``typing``), so the
port imports nothing of the reference; the family names are the
reference's, so a scrape reads the same in both.

The serving stack keeps its own observability for free: ``FlushRecord`` /
``Completion`` already carry flush occupancy, violation and infeasibility
judgements, the served-rho distribution, and per-bucket queue state. This
module is the thin export layer: a tiny metric registry whose families are
*derived at scrape time* from those records
(``AdmissionQueue.export_counters``, ``AnytimeServer.export_counters``),
rendered either as the Prometheus text exposition format (``render()``, for
a scrape endpoint or the ``launch/serve.py --counters`` stderr dump) or as
a JSON-able dict (``as_dict()``).

Deliberately NOT a client library: no background threads, no process
collectors, no default registry, and nothing here runs on the serving hot
path; a counter increment is always a host-side bookkeeping read of state
the serving layer already kept.

Counter families:

  ``repro_queue_submitted_total`` / ``repro_queue_completed_total``
      admission volume per queue.
  ``repro_queue_flush_total{bucket, reason}``
      flushes by Lq bucket and trigger (``full`` | ``deadline`` | ``drain``).
  ``repro_queue_flush_occupancy{bucket}``
      histogram of real-rows / batch-shape per flush: how much of each
      batch shape the traffic actually filled.
  ``repro_queue_violations_total`` / ``repro_queue_infeasible_total``
      SLO accounting: late-flush policy violations vs dead-on-arrival
      deadlines (disjoint by construction; see ``FlushRecord``).
  ``repro_queue_served_rho_total{rho}``
      distribution of SAAT posting budgets actually served (the degrade
      knob's audit trail); DAAT flushes count under ``rho="none"``.
  ``repro_queue_degraded_total``
      flushes served below the full budget.
  ``repro_queue_depth{bucket}``
      gauge: requests pending per bucket lane at scrape time.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey, extra: Optional[Tuple[Tuple[str, str], ...]] = None) -> str:
    items = list(key) + list(extra or ())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Child:
    """One labeled sample of a counter/gauge family."""

    def __init__(self, family: "Family", key: _LabelKey):
        self._family = family
        self._key = key

    def inc(self, v: float = 1.0):
        if self._family.kind == "gauge":
            self._family._samples[self._key] = self._family._samples.get(self._key, 0.0) + v
            return
        if v < 0:
            raise ValueError(f"counter increments must be >= 0, got {v}")
        self._family._samples[self._key] = self._family._samples.get(self._key, 0.0) + v

    def set(self, v: float):
        if self._family.kind != "gauge":
            raise TypeError(f"set() is gauge-only; {self._family.name} is a {self._family.kind}")
        self._family._samples[self._key] = float(v)

    def observe(self, v: float):
        if self._family.kind != "histogram":
            raise TypeError(
                f"observe() is histogram-only; {self._family.name} is a {self._family.kind}"
            )
        counts, agg = self._family._hist.setdefault(
            self._key, ([0] * len(self._family.buckets), [0.0, 0])
        )
        for i, le in enumerate(self._family.buckets):
            if v <= le:
                counts[i] += 1
        agg[0] += float(v)
        agg[1] += 1


class Family:
    """One named metric family (counter | gauge | histogram)."""

    def __init__(self, name: str, help: str, kind: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.kind = kind
        self._samples: Dict[_LabelKey, float] = {}
        if kind == "histogram":
            bs = tuple(float(b) for b in (buckets or (0.25, 0.5, 0.75, 1.0)))
            if sorted(bs) != list(bs):
                raise ValueError(f"histogram buckets must be ascending, got {buckets!r}")
            self.buckets = bs + ((float("inf"),) if bs[-1] != float("inf") else ())
        else:
            if buckets is not None:
                raise ValueError(f"{kind} takes no buckets")
            self.buckets = ()
        self._hist: Dict[_LabelKey, tuple[list, list]] = {}

    def labels(self, **labels: str) -> _Child:
        return _Child(self, _labelkey(labels))

    # conveniences for label-less families
    def inc(self, v: float = 1.0):
        self.labels().inc(v)

    def set(self, v: float):
        self.labels().set(v)

    def observe(self, v: float):
        self.labels().observe(v)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        if self.kind == "histogram":
            for key in sorted(self._hist):
                counts, (total, n) = self._hist[key]
                for le, c in zip(self.buckets, counts):
                    le_s = "+Inf" if le == float("inf") else _fmt_value(le)
                    lines.append(
                        f"{self.name}_bucket{_fmt_labels(key, (('le', le_s),))} {c}"
                    )
                lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
                lines.append(f"{self.name}_count{_fmt_labels(key)} {n}")
            return "\n".join(lines)
        for key in sorted(self._samples):
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(self._samples[key])}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        out = {"type": self.kind, "help": self.help}
        if self.kind == "histogram":
            out["samples"] = [
                {
                    "labels": dict(key),
                    "buckets": {
                        ("+Inf" if le == float("inf") else _fmt_value(le)): c
                        for le, c in zip(self.buckets, counts)
                    },
                    "sum": total,
                    "count": n,
                }
                for key, (counts, (total, n)) in sorted(self._hist.items())
            ]
        else:
            out["samples"] = [
                {"labels": dict(key), "value": v}
                for key, v in sorted(self._samples.items())
            ]
        return out


class CounterRegistry:
    """A bag of metric families with one text and one JSON rendering.

    ``counter``/``gauge``/``histogram`` are get-or-create (re-registering
    the same name with the same kind returns the existing family, so several
    queues/servers can export into one registry), and registering a name as
    two different kinds is an error.
    """

    def __init__(self):
        self._families: Dict[str, Family] = {}

    def _get(self, name: str, help: str, kind: str, buckets=None) -> Family:
        fam = self._families.get(name)
        if fam is None:
            fam = Family(name, help, kind, buckets)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"{name} already registered as {fam.kind}, not {kind}")
        return fam

    def counter(self, name: str, help: str) -> Family:
        return self._get(name, help, "counter")

    def gauge(self, name: str, help: str) -> Family:
        return self._get(name, help, "gauge")

    def histogram(self, name: str, help: str, buckets: Optional[Sequence[float]] = None) -> Family:
        return self._get(name, help, "histogram", buckets)

    def families(self) -> dict[str, Family]:
        return dict(self._families)

    def render(self) -> str:
        """Prometheus text exposition format (one scrape page)."""
        return "\n".join(self._families[n].render() for n in sorted(self._families)) + "\n"

    def as_dict(self) -> dict:
        """JSON-able view, family name -> {type, help, samples} (jq-friendly)."""
        return {n: f.as_dict() for n, f in sorted(self._families.items())}
