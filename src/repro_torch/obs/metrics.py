"""Process-wide metrics registry (counterpart of ``repro.obs.metrics``): labeled Counters, Gauges and
fixed-log-bucket Histograms with structured ``snapshot()`` export and
Prometheus-style text exposition.

Design constraints:

- **Zero allocation when disabled.** The default installed registry is
  disabled; every mutator (``inc``/``set``/``observe``) is a single
  attribute load + boolean check before returning. Instrument objects
  themselves are allocated once, at engine/router/server construction.
- **Deterministic.** All state is plain Python ints/floats updated from
  host-side values the serving stack already computes (sim-clock
  latencies, counter readbacks). Two runs of the same seeded trace with
  modeled latency produce byte-identical snapshots.
- **Fixed buckets.** Histograms use immutable log-spaced bucket bounds
  chosen at creation (default: 0, then 1e-6 .. 1e2 seconds at 32
  buckets per decade), so observation cost is one bisect + one int
  increment and snapshots from different runs/devices are mergeable.
  Percentile estimates interpolate geometrically inside a bucket and
  clamp to the observed min/max.

Registration is idempotent per (name, type): a second engine asking for
``pam_engine_steps_total`` gets the same instrument, and labeled
children (``counter.labels(device="hbm0")``) are cached per label
value.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
from typing import Iterator, Optional


def log_buckets(lo: float = 1e-6, hi: float = 1e2,
                per_decade: int = 32) -> tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds, prefixed with an exact
    0.0 bucket (sim-clock gaps clamp at zero across migration seams, so
    zero is a real observed value, not an error)."""
    if not lo > 0 or not hi > lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    bounds = [0.0]
    bounds += [lo * 10 ** (i / per_decade) for i in range(n + 1)]
    return tuple(bounds)


LATENCY_BUCKETS = log_buckets()                  # seconds: 0, 1e-6..1e2
BYTES_BUCKETS = log_buckets(1.0, 1e12, 4)        # bytes: 0, 1..1e12
TOKENS_BUCKETS = log_buckets(1.0, 1e6, 8)        # counts: 0, 1..1e6


class _Instrument:
    """Shared parent for the three metric types: holds the registry
    reference (for the enabled check), the name/help text and the
    labeled-children cache."""

    kind = "untyped"

    def __init__(self, reg: "MetricsRegistry", name: str, help_: str,
                 labelnames: tuple[str, ...]):
        self._reg = reg
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        self._children: dict[tuple, "_Instrument"] = {}

    def labels(self, **kv) -> "_Instrument":
        """The child instrument for one label assignment (cached); the
        child mutates independently and renders as
        ``name{k="v",...}``."""
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(f"{self.name} wants labels "
                             f"{self.labelnames}, got {tuple(kv)}")
        key = tuple(kv[k] for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def _make_child(self) -> "_Instrument":
        raise NotImplementedError

    def _series(self) -> Iterator[tuple[tuple, "_Instrument"]]:
        """(label values, leaf instrument) pairs — the unlabeled parent
        itself when it has no labelnames."""
        if self.labelnames:
            yield from sorted(self._children.items())
        else:
            yield (), self


class Counter(_Instrument):
    """Monotonically nondecreasing count."""

    kind = "counter"

    def __init__(self, reg, name, help_="", labelnames=()):
        super().__init__(reg, name, help_, labelnames)
        self.value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self._reg, self.name, self.help)

    def inc(self, v: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += v


class Gauge(_Instrument):
    """Point-in-time value (occupancy, queue depth, clock)."""

    kind = "gauge"

    def __init__(self, reg, name, help_="", labelnames=()):
        super().__init__(reg, name, help_, labelnames)
        self.value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(self._reg, self.name, self.help)

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        self.value += v


class Histogram(_Instrument):
    """Fixed-bucket log histogram with quantile estimation.

    ``observe`` is bisect + increment; ``percentile`` walks the
    cumulative counts and interpolates geometrically inside the hit
    bucket, clamped to the exact observed [min, max] so tight
    distributions don't get smeared to a whole bucket's width.

    Standalone use (no registry) is supported for offline scoring:
    ``Histogram.standalone()``."""

    kind = "histogram"

    def __init__(self, reg, name, help_="", labelnames=(),
                 buckets: tuple[float, ...] = LATENCY_BUCKETS):
        super().__init__(reg, name, help_, labelnames)
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"{name}: buckets must strictly increase")
        self.bounds = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.bounds) + 1)   # +inf overflow
        self.total = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @classmethod
    def standalone(cls, name: str = "h",
                   buckets: tuple[float, ...] = LATENCY_BUCKETS
                   ) -> "Histogram":
        return cls(_ALWAYS_ON, name, buckets=buckets)

    def _make_child(self) -> "Histogram":
        return Histogram(self._reg, self.name, self.help,
                         buckets=self.bounds)

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def count(self) -> int:
        return self.total

    def percentile(self, q: float) -> float:
        """Estimated ``q``-th percentile (0..100); 0.0 when empty."""
        if self.total == 0:
            return 0.0
        rank = q / 100.0 * self.total
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev, cum = cum, cum + c
            if cum >= rank:
                frac = min(max((rank - prev) / c, 0.0), 1.0)
                est = self._interp(i, frac)
                return float(min(max(est, self.vmin), self.vmax))
        return float(self.vmax)

    def _interp(self, i: int, frac: float) -> float:
        if i >= len(self.bounds):            # overflow bucket
            return self.vmax
        hi = self.bounds[i]
        if i == 0 or hi <= 0.0:
            return hi                        # the exact-zero bucket
        lo = self.bounds[i - 1]
        if lo <= 0.0:                        # first positive bucket
            lo = hi / 10.0
        return lo * (hi / lo) ** frac        # geometric interpolation

    def summary(self) -> dict:
        """{"p50", "p95", "p99", "n", ...}: the NaN-safe scorecard shape
        (``n == 0`` marks an empty histogram explicitly — zeros then
        mean "no samples", never "zero latency")."""
        if self.total == 0:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "n": 0,
                    "mean": 0.0, "max": 0.0}
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "n": self.total,
                "mean": self.sum / self.total, "max": self.vmax}


class MetricsRegistry:
    """Instrument namespace + enable switch. ``install()`` makes one
    the process default; engines/routers/servers bind their instruments
    against the default at construction."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._instruments: dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------- registration
    def _get(self, cls, name: str, help_: str, labelnames, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(self, name, help_, tuple(labelnames), **kw)
                self._instruments[name] = inst
            elif type(inst) is not cls:
                raise ValueError(f"{name} already registered as "
                                 f"{inst.kind}")
            return inst

    def counter(self, name: str, help_: str = "",
                labelnames=()) -> Counter:
        return self._get(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str = "", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str = "", labelnames=(),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help_, labelnames,
                         buckets=buckets)

    # ------------------------------------------------------------- export
    @staticmethod
    def _series_key(name: str, labelnames, values) -> str:
        if not labelnames:
            return name
        inner = ",".join(f'{k}="{v}"'
                         for k, v in zip(labelnames, values))
        return f"{name}{{{inner}}}"

    def snapshot(self) -> dict:
        """Structured, JSON-serializable view of every series:
        counters/gauges as ``{series: value}``, histograms as
        ``{series: {count, sum, p50, p95, p99, max}}``. Deterministic
        ordering (sorted by series key)."""
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        hists: dict[str, dict] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            for values, leaf in inst._series():
                key = self._series_key(name, inst.labelnames, values)
                if inst.kind == "counter":
                    counters[key] = leaf.value
                elif inst.kind == "gauge":
                    gauges[key] = leaf.value
                else:
                    s = leaf.summary()
                    hists[key] = {"count": leaf.total, "sum": leaf.sum,
                                  "p50": s["p50"], "p95": s["p95"],
                                  "p99": s["p99"], "max": s["max"]}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def render(self) -> str:
        """Prometheus text exposition (counters/gauges as-is,
        histograms as cumulative ``_bucket{le=...}`` + ``_sum`` +
        ``_count`` series)."""
        lines: list[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            for values, leaf in inst._series():
                pairs = list(zip(inst.labelnames, values))
                if inst.kind in ("counter", "gauge"):
                    lines.append(f"{self._series_key(name, inst.labelnames, values)}"
                                 f" {_fmt(leaf.value)}")
                    continue
                cum = 0
                for bound, c in zip(leaf.bounds, leaf.counts):
                    cum += c
                    lab = pairs + [("le", _fmt(bound))]
                    inner = ",".join(f'{k}="{v}"' for k, v in lab)
                    lines.append(f"{name}_bucket{{{inner}}} {cum}")
                inner = ",".join(f'{k}="{v}"'
                                 for k, v in pairs + [("le", "+Inf")])
                lines.append(f"{name}_bucket{{{inner}}} {leaf.total}")
                suffix = self._series_key("", inst.labelnames, values)
                lines.append(f"{name}_sum{suffix} {_fmt(leaf.sum)}")
                lines.append(f"{name}_count{suffix} {leaf.total}")
        return "\n".join(lines) + "\n"

    def get(self, series: str, default: float = 0.0) -> float:
        """Scalar lookup by snapshot series key (counters/gauges)."""
        snap = self.snapshot()
        if series in snap["counters"]:
            return snap["counters"][series]
        return snap["gauges"].get(series, default)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


# --------------------------------------------------- process-wide default
_ALWAYS_ON = MetricsRegistry(enabled=True)       # standalone histograms
_DEFAULT = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    """The currently installed process registry (disabled no-op
    registry by default)."""
    return _DEFAULT


def install(reg: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Install ``reg`` (default: a fresh enabled registry) as the
    process registry and return it. Instruments bind at construction
    time, so install BEFORE building engines/routers/servers."""
    global _DEFAULT
    _DEFAULT = reg if reg is not None else MetricsRegistry()
    return _DEFAULT


def uninstall() -> None:
    """Restore the disabled default (telemetry off)."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry(enabled=False)


@contextlib.contextmanager
def use(reg: Optional[MetricsRegistry] = None):
    """Scoped ``install`` — restores the previous registry on exit."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = reg if reg is not None else MetricsRegistry()
    try:
        yield _DEFAULT
    finally:
        _DEFAULT = prev
