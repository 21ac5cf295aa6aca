"""Async streaming server (counterpart of ``repro.frontend.server``).

Turns the batch-oriented ``ClusterRouter`` / ``ServingEngine`` into a
long-lived serving loop with a per-request streaming token API:

- ``AsyncServer.submit`` registers a request and returns a
  ``StreamHandle``, an async iterator over that request's
  ``ServeEvent``s, closed by its final (or rejection) event;
- the pump (``step`` / ``drain`` / the endpoint's background task)
  ticks the router, drains the shared event stream and fans each event
  out to its request's asyncio queue, recording a ``StreamRecord`` for
  scoring (``repro_torch.frontend.loadgen.score``);
- ``serve_endpoint`` exposes the same loop on a line-delimited JSON TCP
  socket on 127.0.0.1: one request object in, one JSON line per
  streamed token out.

A bare ``ServingEngine`` is wrapped as a one-device router, so arrival
gating, event diffing and the SLO-admission hooks (shed, force-preempt)
are the same on one device and on a fleet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Optional, Union

import numpy as np

from repro_torch.cluster.router import ClusterRouter, RouterConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.events import ServeEvent


@dataclasses.dataclass
class StreamRecord:
    """Everything scoring needs about one request's stream."""

    rid: int
    arrival: float
    prompt_len: int
    max_new: int
    tokens: list[int] = dataclasses.field(default_factory=list)
    times: list[float] = dataclasses.field(default_factory=list)
    indices: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False


class StreamHandle:
    """Async iterator over one request's ``ServeEvent``s. The pump pushes
    events; a ``None`` sentinel (sent with the final event) ends the
    iteration."""

    def __init__(self, record: StreamRecord):
        self.record = record
        self._q: asyncio.Queue = asyncio.Queue()

    def _push(self, ev: ServeEvent) -> None:
        self._q.put_nowait(ev)
        if ev.done:
            self._q.put_nowait(None)

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> ServeEvent:
        ev = await self._q.get()
        if ev is None:
            raise StopAsyncIteration
        return ev


def single_device_router(engine: ServingEngine, *,
                         name: Optional[str] = None,
                         rcfg: RouterConfig = RouterConfig(),
                         preemptible: bool = False) -> ClusterRouter:
    """The reference's alias for ``ClusterRouter.for_engine``."""
    return ClusterRouter.for_engine(engine, name=name, rcfg=rcfg,
                                    preemptible=preemptible)


class AsyncServer:
    """Continuous-batching front end over a router (or a bare engine).

    The router is single-threaded and runs on its engines' clocks, so
    the server pumps it cooperatively: ``step()`` runs admission
    control, one router tick and the event fan-out; ``drain()`` pumps
    until every submitted stream has closed, yielding to the event loop
    every ``ticks_per_yield`` ticks so concurrent consumers (stream
    iterators, socket writers) interleave."""

    def __init__(self, backend: Union[ClusterRouter, ServingEngine], *,
                 admission=None, ticks_per_yield: int = 8):
        if isinstance(backend, ServingEngine):
            backend = backend.as_router(
                preemptible=admission is not None)
        else:
            backend = backend.as_router()
        self.router = backend
        self.admission = admission
        self.ticks_per_yield = max(int(ticks_per_yield), 1)
        self.records: dict[int, StreamRecord] = {}
        self._handles: dict[int, StreamHandle] = {}
        self._next_rid = 0
        self._last_arrival = 0.0
        self._bind_obs()

    def _bind_obs(self) -> None:
        """Bind the front end's instruments against the installed
        registry (once, at construction)."""
        reg = obs_metrics.get_registry()
        self._mreg = reg
        self._m_submitted = reg.counter(
            "pam_frontend_requests_total",
            "requests accepted by the front end")
        self._m_finished = reg.counter(
            "pam_frontend_finished_total",
            "streams closed by a final (non-rejection) event")
        self._m_rejected = reg.counter(
            "pam_frontend_rejected_total",
            "streams closed by a rejection event")
        self._m_tokens = reg.counter(
            "pam_frontend_streamed_tokens_total",
            "token events fanned out to stream handles")
        self._m_queue = reg.gauge(
            "pam_frontend_queue_depth",
            "router shared-queue depth after the last pump tick")
        self._m_ttft = reg.histogram(
            "pam_frontend_ttft_seconds",
            "time to first streamed token (sim seconds)")
        self._m_itl = reg.histogram(
            "pam_frontend_itl_seconds",
            "inter-token gap, pooled across streams (sim seconds)")
        self._m_tpot = reg.histogram(
            "pam_frontend_tpot_seconds",
            "per-stream mean decode-token gap (sim seconds)")

    # ------------------------------------------------------------ intake
    def submit(self, prompt, max_new_tokens: int, *,
               rid: Optional[int] = None,
               arrival: Optional[float] = None) -> StreamHandle:
        """Register one request and return its stream. ``arrival``
        defaults to the cluster's frontier; explicit arrivals are
        clamped nondecreasing (the router's stream contract). A prompt
        id outside ``[0, vocab)`` raises ``ValueError`` and registers
        nothing."""
        prompt = np.asarray(prompt)
        self.router.check_prompt(prompt)      # before any narrowing cast
        prompt = prompt.astype(np.int32)
        if rid is None:
            rid = self._next_rid
        if rid in self.records:
            raise ValueError(f"duplicate request id {rid}")
        self._next_rid = max(self._next_rid, rid + 1)
        if arrival is None:
            arrival = self.router.now()
        arrival = max(float(arrival), self._last_arrival)
        self._last_arrival = arrival
        rec = StreamRecord(rid=rid, arrival=arrival,
                           prompt_len=int(prompt.shape[0]),
                           max_new=int(max_new_tokens))
        handle = StreamHandle(rec)
        self.records[rid] = rec
        self._handles[rid] = handle
        self._m_submitted.inc()
        self.router.submit(Request(id=rid, prompt=prompt,
                                   max_new_tokens=int(max_new_tokens),
                                   arrival=arrival))
        self._fanout()       # an unserviceable submit rejects at once
        return handle

    # -------------------------------------------------------------- pump
    def _fanout(self) -> None:
        for ev in self.router.drain_events():
            rec = self.records.get(ev.request_id)
            if rec is None:      # submitted around the server
                continue
            if ev.rejected:
                rec.rejected = True
                self._m_rejected.inc()
            else:
                if self._mreg.enabled:
                    self._m_tokens.inc()
                    if not rec.times:   # first token: TTFT vs arrival
                        self._m_ttft.observe(
                            max(ev.time - rec.arrival, 0.0))
                    else:               # later tokens: pooled ITL gap
                        self._m_itl.observe(
                            max(ev.time - rec.times[-1], 0.0))
                rec.tokens.append(ev.token)
                rec.times.append(ev.time)
                rec.indices.append(ev.index)
            if ev.done:
                rec.done = True
                if not ev.rejected:
                    self._m_finished.inc()
                    if self._mreg.enabled and len(rec.times) > 1:
                        gaps = np.maximum(np.diff(rec.times), 0.0)
                        self._m_tpot.observe(float(np.mean(gaps)))
            handle = self._handles.get(ev.request_id)
            if handle is not None:
                handle._push(ev)
                if ev.done:
                    del self._handles[ev.request_id]

    def step(self) -> bool:
        """One pump iteration; False once the backend is drained and
        every stream has closed."""
        if self.admission is not None:
            self.admission.control(self.router)
        live = self.router.tick()
        self._fanout()
        if self._mreg.enabled:
            self._m_queue.set(len(self.router.queue))
        return live or bool(self._handles)

    async def drain(self, max_ticks: Optional[int] = None) -> int:
        """Pump until all submitted streams finish; returns the ticks."""
        limit = (max_ticks if max_ticks is not None
                 else self.router.rcfg.max_ticks)
        n = 0
        while self.step():
            n += 1
            if n >= limit:
                raise RuntimeError(f"server did not drain in {limit} ticks")
            if n % self.ticks_per_yield == 0:
                await asyncio.sleep(0)
        return n

    async def serve_trace(self, requests: list[Request],
                          max_ticks: Optional[int] = None
                          ) -> dict[int, StreamRecord]:
        """Submit a whole time-ordered trace (the router's idle jump
        advances the clocks through arrival gaps), pump to completion,
        and return the per-request records."""
        for req in requests:
            self.submit(req.prompt, req.max_new_tokens, rid=req.id,
                        arrival=req.arrival)
        await self.drain(max_ticks)
        return self.records

    # ---------------------------------------------------------- endpoint
    async def serve_endpoint(self, host: str = "127.0.0.1",
                             port: int = 0):
        """Line-delimited JSON TCP endpoint. Each connection sends one
        request object, ``{"prompt": [int, ...], "max_new_tokens": n,
        "id": optional}``, and receives one JSON line per event
        (``{"rid", "token", "index", "time", "done", "rejected"}``). A
        ``{"op": "metrics"}`` line instead returns one line with the live
        registry snapshot. A refused request (a prompt id outside
        ``[0, vocab)``, a duplicate id) gets one ``{"rid", "error"}``
        line and its connection closes; the endpoint keeps serving.
        Returns ``(server, port, pump_task)``; the
        caller owns shutdown (cancel the task, close the server)."""
        server = await asyncio.start_server(self._handle_conn, host, port)
        bound = server.sockets[0].getsockname()[1]
        pump = asyncio.create_task(self._endpoint_pump())
        return server, bound, pump

    async def _endpoint_pump(self) -> None:
        while True:
            self.step()
            await asyncio.sleep(0)

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            msg = json.loads(line)
            if msg.get("op") == "metrics":
                reg = obs_metrics.get_registry()
                writer.write(json.dumps({
                    "op": "metrics", "enabled": reg.enabled,
                    "metrics": reg.snapshot(),
                }).encode() + b"\n")
                await writer.drain()
                return
            try:
                handle = self.submit(msg["prompt"],
                                     int(msg["max_new_tokens"]),
                                     rid=msg.get("id"))
            except ValueError as exc:       # refused; the server goes on
                writer.write(json.dumps({"rid": msg.get("id"),
                                         "error": str(exc)}).encode()
                             + b"\n")
                await writer.drain()
                return
            async for ev in handle:
                writer.write(json.dumps({
                    "rid": ev.request_id, "token": ev.token,
                    "index": ev.index, "time": ev.time,
                    "done": ev.done, "rejected": ev.rejected,
                }).encode() + b"\n")
                await writer.drain()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # ------------------------------------------------------------ metrics
    def summary(self) -> dict:
        """Front-end scorecard: ``finished`` / ``rejected`` count closed
        streams, ``streamed_tokens`` the fanned-out token events."""
        recs = self.records.values()
        out = {"requests": len(self.records),
               "finished": sum(r.done and not r.rejected for r in recs),
               "rejected": sum(r.rejected for r in recs),
               "streamed_tokens": sum(len(r.tokens) for r in recs),
               "backend": self.router.summary()}
        if self.admission is not None:
            out["admission"] = self.admission.summary()
        return out
