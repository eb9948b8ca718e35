"""Minimal metrics registry for the serving engine: counters, gauges and
histograms with quantiles.

A small copy of the part of ``singa_tpu/observability/metrics.py`` the
serving engines use (request outcomes, queue depth, TTFT, per-tick
latency, the slot, token, KV block, prefix-cache and speculative
counters). Export formats, label cardinality guards and the build-info
document are not ported.
"""

from __future__ import annotations

import math
import threading
from collections import deque


class Counter:
    def __init__(self, name, help_text="", labels=()):
        self.name, self.help, self.labels = name, help_text, tuple(labels)
        self._values = {}
        self._lock = threading.Lock()

    def inc(self, n=1, **labels):
        key = tuple(labels.get(k) for k in self.labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels):
        key = tuple(labels.get(k) for k in self.labels)
        with self._lock:
            return self._values.get(key, 0)

    def total(self):
        """The sum over every label set."""
        with self._lock:
            return sum(self._values.values())


class Gauge:
    def __init__(self, name, help_text=""):
        self.name, self.help = name, help_text
        self._value = 0.0

    def set(self, v):
        self._value = float(v)

    def value(self):
        return self._value


class Histogram:
    """Keeps the newest ``window`` samples; quantiles by nearest rank."""

    def __init__(self, name, help_text="", window=100_000):
        self.name, self.help = name, help_text
        self._samples = deque(maxlen=int(window))
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v):
        with self._lock:
            self._samples.append(float(v))
            self._count += 1

    @property
    def count(self):
        return self._count

    def quantile(self, q):
        """The q-quantile (0..1) of the kept samples, None when empty."""
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return None
        return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]

    def summary(self):
        return {"count": self._count, "p50": self.quantile(0.50),
                "p99": self.quantile(0.99)}


class Registry:
    """Name -> metric; asking twice for one name returns the same
    metric."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a "
                                f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name, help_text="", labels=()):
        return self._get(Counter, name, help_text, labels)

    def gauge(self, name, help_text=""):
        return self._get(Gauge, name, help_text)

    def histogram(self, name, help_text=""):
        return self._get(Histogram, name, help_text)

    def get(self, name):
        """The metric registered under ``name``, or None."""
        with self._lock:
            return self._metrics.get(name)


_default = Registry()


def default_registry() -> Registry:
    return _default
