"""Request-lifecycle tracing on the sim-clock (counterpart of
``repro.obs.trace``), exported as Chrome
trace-event JSON (loadable at https://ui.perfetto.dev).

Event model
-----------
- **Request spans** are async events (``ph`` "b"/"e") keyed by request
  id: one track per request showing its lifecycle phases — ``queued``
  → ``prefill`` (chunked admissions; slice fills show on the device
  track) → ``decode`` → ``suspended`` → ``decode`` ... — with instant
  markers for ``migrate_out``/``migrate_in``, ``replay``, ``shed``,
  ``reject`` and ``finish``. Spans survive migration because the id,
  not the device, names the track.
- **Device events** are complete slices (``ph`` "X") on a per-device
  track: ``step`` (one per engine step, duration = the step's modeled
  or measured latency), ``admit``/``prefill_slice``/``import``, fault
  and watchdog markers.
- **Counter tracks** (``ph`` "C") carry occupancy timelines: pool
  occupancy and active slots per device, cluster queue depth per tick.

Timestamps are sim-clock seconds converted to integer microseconds.
The collector CLAMPS each track's timestamps monotone (device clocks
resync on migration; Perfetto rejects time travel inside a track), and
begin/end bookkeeping is idempotent per (id, phase) — a second ``b``
for an open span or an ``e`` with no open span is dropped — so every
exported span is balanced by construction. Both properties are pinned
by the schema-validation tests.

The ring is bounded (``capacity`` events, default 64k): old events
drop first and ``dropped`` counts them. When no collector is installed
every hook is a module-global load + ``None`` check — zero allocation
on the serving fast path.
"""

from __future__ import annotations

import collections
import contextlib
import json
from typing import Optional

REQUEST_CAT = "request"
_REQUEST_PID = 1
_DEVICE_PID0 = 10


class TraceCollector:
    """Bounded ring of Chrome trace events on the sim-clock."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = capacity
        self.events: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self.dropped = 0
        self._pids: dict[str, int] = {}          # device name -> pid
        self._last_ts: dict[tuple, int] = {}     # track key -> last us
        self._open: dict[tuple, str] = {}        # (cat, id) -> open phase

    # ---------------------------------------------------------- low level
    def _push(self, ev: dict) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def _ts(self, key: tuple, t: float) -> int:
        """Sim seconds -> integer us, clamped monotone per track."""
        us = int(round(t * 1e6))
        last = self._last_ts.get(key, 0)
        if us < last:
            us = last
        self._last_ts[key] = us
        return us

    def _pid(self, device: str) -> int:
        pid = self._pids.get(device)
        if pid is None:
            pid = _DEVICE_PID0 + len(self._pids)
            self._pids[device] = pid
        return pid

    # ------------------------------------------------------ request spans
    def begin(self, rid: int, phase: str, t: float, **args) -> None:
        """Open lifecycle phase ``phase`` for request ``rid`` (async
        span). Any phase already open for the request is closed first —
        lifecycle phases are sequential by definition, so this keeps
        every span balanced even across replay/suspension seams."""
        key = (REQUEST_CAT, rid)
        if key in self._open:
            if self._open[key] == phase:
                return                       # idempotent re-begin
            self.end(rid, self._open[key], t)
        ts = self._ts(key, t)
        self._open[key] = phase
        self._push({"ph": "b", "cat": REQUEST_CAT, "id": rid,
                    "name": phase, "pid": _REQUEST_PID, "tid": 0,
                    "ts": ts, "args": args or {}})

    def end(self, rid: int, phase: str, t: float, **args) -> None:
        key = (REQUEST_CAT, rid)
        if self._open.get(key) != phase:
            return                           # never emit unbalanced "e"
        ts = self._ts(key, t)
        del self._open[key]
        self._push({"ph": "e", "cat": REQUEST_CAT, "id": rid,
                    "name": phase, "pid": _REQUEST_PID, "tid": 0,
                    "ts": ts, "args": args or {}})

    def mark(self, rid: int, name: str, t: float, **args) -> None:
        """Instant lifecycle marker on the request's track."""
        key = (REQUEST_CAT, rid)
        self._push({"ph": "n", "cat": REQUEST_CAT, "id": rid,
                    "name": name, "pid": _REQUEST_PID, "tid": 0,
                    "ts": self._ts(key, t), "args": args or {}})

    def open_phase(self, rid: int) -> Optional[str]:
        return self._open.get((REQUEST_CAT, rid))

    # ------------------------------------------------------ device events
    def slice(self, device: str, name: str, t0: float, dur: float,
              **args) -> None:
        """Complete slice (``ph`` "X") on the device track."""
        pid = self._pid(device)
        key = ("dev", device)
        ts = self._ts(key, t0)
        # keep the track monotone through the slice's end too
        self._last_ts[key] = max(self._last_ts[key],
                                 ts + int(round(max(dur, 0.0) * 1e6)))
        self._push({"ph": "X", "cat": "device", "name": name,
                    "pid": pid, "tid": 0, "ts": ts,
                    "dur": int(round(max(dur, 0.0) * 1e6)),
                    "args": args or {}})

    def instant(self, device: str, name: str, t: float, **args) -> None:
        self._push({"ph": "i", "cat": "device", "name": name, "s": "t",
                    "pid": self._pid(device), "tid": 0,
                    "ts": self._ts(("dev", device), t),
                    "args": args or {}})

    def counter(self, device: str, name: str, t: float, **values
                ) -> None:
        """Counter sample (``ph`` "C") — occupancy/queue timelines."""
        self._push({"ph": "C", "cat": "device", "name": name,
                    "pid": self._pid(device), "tid": 0,
                    "ts": self._ts(("ctr", device, name), t),
                    "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------- export
    def last_time(self) -> float:
        """Latest timestamp seen on any track, in sim seconds."""
        return max(self._last_ts.values(), default=0) / 1e6

    def close_open(self, t: Optional[float] = None) -> None:
        """Close every still-open request span at time ``t`` (default:
        the latest timestamp on any track — end of a run that left work
        in flight) so the export stays balanced."""
        if t is None:
            t = self.last_time()
        for (_, rid), phase in list(self._open.items()):
            self.end(rid, phase, t)

    def export(self) -> dict:
        """Chrome trace-event JSON object (``traceEvents`` +
        process-name metadata). Does NOT implicitly close open spans —
        call ``close_open`` first if the run was abandoned mid-flight.
        """
        meta = [{"ph": "M", "name": "process_name", "pid": _REQUEST_PID,
                 "tid": 0, "args": {"name": "requests"}}]
        for device, pid in sorted(self._pids.items(),
                                  key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": device}})
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "clock": "sim_seconds_as_us"}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


# --------------------------------------------------- process-wide default
COLLECTOR: Optional[TraceCollector] = None


def active() -> Optional[TraceCollector]:
    """The installed collector, or None (tracing off). Hooks read the
    module global directly on hot paths; this accessor is for tests
    and export code."""
    return COLLECTOR


def install(coll: Optional[TraceCollector] = None) -> TraceCollector:
    """Install ``coll`` (default: a fresh collector) process-wide and
    return it. Unlike metrics, trace hooks look the collector up per
    event, so installing mid-run starts recording immediately."""
    global COLLECTOR
    COLLECTOR = coll if coll is not None else TraceCollector()
    return COLLECTOR


def uninstall() -> None:
    global COLLECTOR
    COLLECTOR = None


@contextlib.contextmanager
def use(coll: Optional[TraceCollector] = None):
    """Scoped ``install`` — restores the previous collector on exit."""
    global COLLECTOR
    prev = COLLECTOR
    COLLECTOR = coll if coll is not None else TraceCollector()
    try:
        yield COLLECTOR
    finally:
        COLLECTOR = prev


# ------------------------------------------------------ schema validation
def validate(trace: dict) -> dict:
    """Validate an exported trace against the schema contract:
    every async request span balanced ("b" and "e" match pairwise per
    request id, phases properly sequenced), timestamps monotone per
    track, durations nonnegative, all events JSON-plain. Returns
    summary stats; raises ``ValueError`` on violation. Used by the
    trace-export tests and ``scripts/trace_smoke.py``."""
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    open_spans: dict = {}
    last_ts: dict = {}
    counts = {"spans": 0, "slices": 0, "instants": 0, "counters": 0}
    per_request: dict = collections.defaultdict(set)
    devices = set()
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, int) or ts < 0:
            raise ValueError(f"non-integer/negative ts: {ev}")
        if ph in ("b", "e", "n"):
            key = ("req", ev["id"])
            if ts < last_ts.get(key, 0):
                raise ValueError(f"time travel on request track: {ev}")
            last_ts[key] = ts
            if ph == "b":
                if key in open_spans:
                    raise ValueError(f"nested request phase: {ev}")
                open_spans[key] = ev["name"]
            elif ph == "e":
                if open_spans.get(key) != ev["name"]:
                    raise ValueError(f"unbalanced span end: {ev}")
                del open_spans[key]
                counts["spans"] += 1
                per_request[ev["id"]].add(ev["name"])
            else:
                counts["instants"] += 1
                per_request[ev["id"]].add(ev["name"])
        elif ph == "X":
            key = ("pid", ev["pid"])
            if ts < last_ts.get(key, 0):
                raise ValueError(f"time travel on device track: {ev}")
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                raise ValueError(f"bad slice duration: {ev}")
            last_ts[key] = ts + ev["dur"]
            counts["slices"] += 1
            devices.add(ev["pid"])
        elif ph == "i":
            counts["instants"] += 1
            devices.add(ev["pid"])
        elif ph == "C":
            counts["counters"] += 1
        else:
            raise ValueError(f"unknown event phase {ph!r}: {ev}")
    if open_spans:
        raise ValueError(f"unclosed request spans: {open_spans}")
    json.dumps(events)       # must be JSON-plain end to end
    counts["requests"] = len(per_request)
    counts["devices"] = len(devices)
    counts["phases_per_request"] = {
        str(rid): sorted(names) for rid, names in per_request.items()}
    return counts
