"""The serving event record (counterpart of ``repro.serving.events``).

``ServeEvent`` is the one token-stream record every serving path emits:
the cluster router's event loop and the single-engine ``serve()``
generator. A backend — ``ServingEngine`` or ``ClusterRouter`` — exposes
the same two methods:

  ``as_router()``  -> the ``ClusterRouter`` view of the backend (a
                      router returns itself; an engine wraps itself as
                      a one-device cluster), and
  ``serve(...)``   -> a generator of ``ServeEvent``s that drives the
                      backend to drain.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServeEvent:
    """One emitted token (or terminal marker) of one request's stream.

    ``done`` marks the request's last event; ``rejected`` marks a
    request shed by admission/SLO policy (its only event — ``token`` is
    meaningless there). ``time`` is the backend's (simulated or wall)
    clock at emission; ``index`` is the token's position in the
    request's output stream; ``device`` names the engine that produced
    it.
    """

    time: float
    request_id: int
    token: int
    index: int
    device: str
    done: bool
    rejected: bool = False
