"""Telemetry of the port (counterpart of ``repro.obs``): a metrics
registry and request tracing, both off by default and zero-allocation
when disabled, shared by the engine and the cluster.

- ``obs.metrics`` — a process-wide registry of labeled Counters /
  Gauges / Histograms, with ``snapshot()`` and Prometheus-style
  ``render()``;
- ``obs.trace`` — per-request lifecycle spans and engine-step /
  cluster-tick events on the (modeled or wall) clocks, exported as
  Chrome trace-event JSON loadable in Perfetto.

Install before building engines or routers: instruments bind at
construction::

    from repro_torch import obs
    reg = obs.metrics.install(obs.metrics.MetricsRegistry())
    coll = obs.trace.install(obs.trace.TraceCollector())
"""

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceCollector

__all__ = ["metrics", "trace", "MetricsRegistry", "TraceCollector"]
