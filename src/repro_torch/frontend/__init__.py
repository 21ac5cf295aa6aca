"""Serving front end of the port (counterpart of ``repro.frontend``).

- ``chunking``: chunked-prefill slice planning (an engine hook);
- ``server``: the async streaming server over ``ClusterRouter`` or a
  bare ``ServingEngine``, and its line-delimited JSON endpoint;
- ``admission``: SLO-aware admission control (shed / force-preempt);
- ``loadgen``: seeded arrival traces and TTFT / TPOT / SLO scoring.

Submodules are imported lazily: the engine imports ``chunking`` while
``server`` imports the cluster layer (which imports the engine), so
eager imports here would be a cycle.
"""

import importlib

_SUBMODULES = ("admission", "chunking", "loadgen", "server")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
