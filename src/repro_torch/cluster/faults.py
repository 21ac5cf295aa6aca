"""Deterministic, seeded fault injection for the serving cluster
(counterpart of ``repro.cluster.faults``).

A chaos run is a list of ``FaultEvent``s pinned to router ticks: the
same spec and seed always give the same failure trace. The router polls
``FaultInjector.due(tick)`` at the top of every tick and applies device
faults itself; transfer faults (drop / corrupt) arm a verdict queue that
the recovery manager consumes on each snapshot transfer.

Fault kinds
-----------
- ``kill``      the device stops mid-decode: no more steps, no
                heartbeats. Its in-flight KV is lost; recovery replays.
- ``stall``     straggler: the device keeps serving but every modeled
                step costs ``factor`` x.
- ``unstall``   clears a stall.
- ``drop``      the next ``count`` snapshot transfers vanish in flight
                (timeout at the receiver, then a retry).
- ``corrupt``   the next ``count`` snapshot transfers arrive with
                flipped KV bytes (checksum mismatch, then a retry).
- ``exhaust``   hog every free pool block on the device (admission
                starvation, which drives preemption-by-demotion).
- ``release``   frees a previous ``exhaust`` hog.

Spec grammar (``--chaos``): comma-separated events ``kind[:device]@tick``
with the optional suffixes ``xFACTOR`` (stall) and ``*COUNT``
(drop / corrupt), e.g.::

    kill:hbm0@120, stall:cxl0@50x8, corrupt@30*2, exhaust:cxl1@25
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

DEVICE_KINDS = ("kill", "stall", "unstall", "exhaust", "release")
TRANSFER_KINDS = ("drop", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    tick: int                 # router tick at which the fault fires
    kind: str                 # see the module docstring
    device: str = ""          # target name; "" for transfer faults
    factor: float = 4.0       # stall slowdown multiplier
    count: int = 1            # transfers affected (drop / corrupt)

    def __post_init__(self):
        if self.kind not in DEVICE_KINDS + TRANSFER_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in DEVICE_KINDS and not self.device:
            raise ValueError(f"{self.kind} fault needs a device name")


def parse_chaos(spec: str) -> list[FaultEvent]:
    """Parse the ``--chaos`` grammar (module docstring) into events."""
    events: list[FaultEvent] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        head, _, tickpart = item.partition("@")
        if not tickpart:
            raise ValueError(f"fault {item!r}: missing '@tick'")
        kind, _, device = head.partition(":")
        factor, count = 4.0, 1
        if "x" in tickpart:
            tickpart, _, f = tickpart.partition("x")
            factor = float(f)
        if "*" in tickpart:
            tickpart, _, c = tickpart.partition("*")
            count = int(c)
        events.append(FaultEvent(tick=int(tickpart), kind=kind,
                                 device=device, factor=factor,
                                 count=count))
    return events


class FaultInjector:
    """Replays a fault trace against the router (module docstring).
    ``seed`` drives only the corrupted byte positions; the trace itself
    is the event list."""

    def __init__(self, events: list[FaultEvent], seed: int = 0):
        self._pending = sorted(events, key=lambda e: e.tick)
        self._rng = np.random.default_rng(seed)
        self._verdicts: collections.deque[str] = collections.deque()
        self.fired: list[FaultEvent] = []

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        return cls(parse_chaos(spec), seed=seed)

    # ------------------------------------------------------------ schedule
    def due(self, tick: int) -> list[FaultEvent]:
        """Pop every event scheduled at or before ``tick``. Transfer
        faults are armed here and returned for logging only."""
        out: list[FaultEvent] = []
        while self._pending and self._pending[0].tick <= tick:
            ev = self._pending.pop(0)
            if ev.kind in TRANSFER_KINDS:
                self._verdicts.extend([ev.kind] * ev.count)
            out.append(ev)
            self.fired.append(ev)
        return out

    @property
    def exhausted(self) -> bool:
        return not self._pending and not self._verdicts

    # ------------------------------------------------------------ transfers
    def transfer_verdict(self) -> str:
        """Fate of the next snapshot transfer: 'ok', 'drop' or 'corrupt'
        (armed verdicts are consumed in order)."""
        return self._verdicts.popleft() if self._verdicts else "ok"

    def corrupt(self, snap) -> None:
        """Flip eight KV bytes of a wire-copy ``KVSnapshot`` in place (the
        seal stays as it was at export, so ``verify`` catches it). A bf16
        snapshot's K is a ``uint16`` view of the bits, so its bytes, and
        the positions the seed draws, are the reference's."""
        flat = snap.k.reshape(-1).view(np.uint8)
        idx = self._rng.integers(0, flat.size, size=8)
        flat[idx] ^= 0xFF
