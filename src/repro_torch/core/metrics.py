"""Sphere metrics plane: labeled counters, gauges and histograms.

:class:`MetricsRegistry` is the single write path the engine's
end-of-job aggregates flow through: a :class:`~repro.core.planner.
SphereReport` bound to a registry (``report.bind_metrics(registry,
**labels)``) mirrors every counter mutation into the registry *as it
happens* — the mirror lives inside ``SphereReport.__setattr__``, so the
report's fields and the registry's series are two reads of one write and
can never disagree (tested in ``tests/test_trace.py``).

The registry is deliberately small and dependency-free (no Prometheus
client): three instrument kinds, each identified by ``(name, labels)``:

* **counter**   — monotonically-growing total (``inc``);
* **gauge**     — last-set value (``set``);
* **histogram** — count / sum / min / max of observations (``observe``)
  — enough to answer "how many stages and how long" without binning
  policy.

Registering the same ``(name, labels)`` under two different kinds is an
error: a series' kind is part of its contract.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "?"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def stats(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max}


class MetricsRegistry:
    """Instrument factory + store.  ``counter``/``gauge``/``histogram``
    get-or-create the series for ``(name, labels)``; ``value`` reads a
    scalar series back (0.0 when the series was never written, so reads
    and an untouched report field agree)."""

    def __init__(self):
        self._series: Dict[Tuple[str, LabelKey], _Instrument] = {}
        self._binds = 0

    def _get(self, cls, name: str, labels: Dict[str, str]) -> _Instrument:
        key = (name, _label_key(labels))
        inst = self._series.get(key)
        if inst is None:
            inst = self._series[key] = cls(name, labels)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} {labels} already registered "
                            f"as a {inst.kind}, not a {cls.kind}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # ---------------------------------------------------------------- reads
    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge series (0.0 if unwritten)."""
        inst = self._series.get((name, _label_key(labels)))
        if inst is None:
            return 0.0
        if isinstance(inst, Histogram):
            raise TypeError(f"metric {name!r} is a histogram; use "
                            f"histogram(...).stats()")
        return inst.value

    def series(self, name: Optional[str] = None) -> List[_Instrument]:
        """Every registered instrument, optionally filtered by name."""
        return [inst for (n, _), inst in sorted(self._series.items())
                if name is None or n == name]

    def snapshot(self) -> List[dict]:
        """Plain-data dump (benchmark JSON, debugging)."""
        out = []
        for (name, _), inst in sorted(self._series.items()):
            row = {"name": name, "kind": inst.kind, "labels": inst.labels}
            if isinstance(inst, Histogram):
                row.update(inst.stats())
            else:
                row["value"] = inst.value
            out.append(row)
        return out

    def next_run_labels(self) -> Dict[str, str]:
        """A unique ``run`` label per report binding, so two reports
        mirrored into one registry never collide on a series (each
        report's fields equal ITS labeled series exactly)."""
        self._binds += 1
        return {"run": f"r{self._binds}"}
