"""Device-loss recovery and graceful degradation for the serving cluster:
the fault-tolerance layer ``ClusterRouter`` drives (counterpart of
``repro.cluster.recovery``).

Detection runs on the engines' modeled clocks:

- ``HeartbeatLedger`` in clock seconds: every alive device beats each
  router tick; a killed device goes silent and is declared dead once the
  fleet frontier moves ``heartbeat_timeout_s`` past its last beat. When
  the hung device held the only in-flight work, the router charges the
  timeout as explicit wait time.
- ``StragglerMonitor`` sees step times normalized by pricing each step's
  own stats through the device's unstalled latency model: a slower
  device class or a loaded device reads about 1.0, a stalled device its
  slowdown factor.

Recovery has two paths, both ending in the token stream of a
failure-free twin (sampling keys are per request):

- graceful drain (device alive but degraded): running requests export
  as checksummed ``KVSnapshot``s and transfer to survivors with bounded
  retry and backoff (``transfer``): a dropped transfer times out, a
  corrupted one fails the checksum, and both re-send from the sender's
  pristine copy. Terminal failure rolls back to the source.
- replay (device dead, KV lost): the router re-submits the request from
  its prompt on a survivor and suppresses the regenerated prefix of the
  stream, checking it token by token.

Degradation: overload never raises. A starving queue head suspends the
lowest-importance running request into a host-held snapshot
(preemption-by-demotion, resumed after a cooldown when capacity frees),
and unserviceable submissions end with rejection events.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.cluster.faults import FaultInjector
from repro_torch.cluster.migration import KVSnapshot
from repro_torch.distributed.elastic import HeartbeatLedger, StragglerMonitor
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.paged_kv import OutOfBlocks


class _MirroredStats(dict):
    """The recovery ``stats`` dict, every increment mirrored into the
    ``pam_cluster_recovery_events_total{event=...}`` counter of the
    registry installed at construction (the router increments too, so
    the dict write is the one place that sees them all)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._counter = obs_metrics.get_registry().counter(
            "pam_cluster_recovery_events_total",
            "recovery-path events (detections, drains, replays, "
            "retries, suspensions), by kind", ("event",))

    def __setitem__(self, key: str, value: float) -> None:
        delta = value - self.get(key, 0)
        if delta > 0:
            self._counter.labels(event=key).inc(delta)
        super().__setitem__(key, value)


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    heartbeat_timeout_s: float = 0.25    # silence before presumed dead
    straggler_threshold: float = 1.75    # x peer-median slowdown
    straggler_patience: int = 3          # consecutive flagged observations
    transfer_retries: int = 3            # re-sends after a bad transfer
    transfer_backoff_s: float = 1e-3     # first retry wait; doubles
    link_bw: float = 64e9                # snapshot transfer bytes/s
    preempt_after_ticks: int = 48        # queue-head starvation fuse
    min_preempt_remaining: int = 2       # don't suspend nearly-done work
    resume_cooldown_ticks: int = 8       # suspended -> resume attempt


class RecoveryManager:
    """Watchdog state and the transfer / suspension machinery.

    The router calls ``observe_step`` after stepping a device,
    ``heartbeat`` / ``advance`` every tick, and asks ``dead_indices`` /
    ``straggler_indices`` for verdicts; the recovery actions (drain,
    replay, preempt) live in the router, which owns placement.
    """

    def __init__(self, cfg: RecoveryConfig = RecoveryConfig(),
                 injector: Optional[FaultInjector] = None):
        self.cfg = cfg
        self.injector = injector
        self.monitor = StragglerMonitor(
            threshold=cfg.straggler_threshold,
            patience=cfg.straggler_patience)
        self.ledger = HeartbeatLedger(dead_after=cfg.heartbeat_timeout_s)
        # host-held suspended snapshots: (KVSnapshot, suspend tick)
        self.suspended: list[tuple[KVSnapshot, int]] = []
        self.stats: dict[str, float] = _MirroredStats({
            "kills_detected": 0, "drains": 0, "replays": 0,
            "preemptions": 0, "resumes": 0, "transfer_retries": 0,
            "transfers_dropped": 0, "corruptions_detected": 0,
            "transfer_failures": 0, "abandoned": 0,
        })
        self.recovery_latencies: list[float] = []

    # ------------------------------------------------------------ detection
    def observe_step(self, idx: int, dev, step_time: float) -> None:
        """Record one device step for straggler detection, normalized so
        a healthy device reads about 1.0 whatever its class or load: the
        step's own stats priced through the device's unstalled latency
        model, else (no decode stats yet) the class prior."""
        if step_time <= 0.0:
            return
        base = getattr(dev, "base_latency", None)
        stats = getattr(dev.engine, "last_step_stats", None)
        if base is not None and stats is not None:
            expected = float(base(stats))
            if expected <= 0.0:
                return
            rel = step_time / expected
        else:
            prior = getattr(dev, "step_prior", 0.0)
            if prior <= 0.0:
                return              # wall-clock runs: no prior, no watch
            rel = step_time / prior
        self.monitor.record(idx, rel)
        self.monitor.observe_step()

    def heartbeat(self, idx: int, clock: float) -> None:
        self.ledger.beat(idx, clock)

    def advance(self, clock: float) -> None:
        self.ledger.advance(clock)

    def dead_indices(self) -> list[int]:
        return self.ledger.dead_hosts()

    def straggler_indices(self) -> list[int]:
        return self.monitor.stragglers()

    def note_recovery(self, latency_s: float) -> None:
        self.recovery_latencies.append(max(latency_s, 0.0))

    # ------------------------------------------------------------ transfers
    def transfer(self, snap: KVSnapshot, dst_engine,
                 charge: Callable[[float], None]) -> bool:
        """Deliver ``snap`` to ``dst_engine`` over the faulty link.

        Each attempt puts a fresh wire copy of the sender's pristine
        snapshot on the link; the injector may drop it (the receiver
        times out) or corrupt it (the crc32 no longer matches). A failed
        attempt charges exponential backoff to the receiver's clock
        through ``charge`` and re-sends, up to ``transfer_retries``
        times. Returns True once committed, False on terminal failure
        (the caller rolls back or suspends; ``snap`` is untouched).
        Capacity errors (no slot, ``OutOfBlocks``) are not retried: the
        link is fine, the destination is full.
        """
        charge(snap.kv_bytes / self.cfg.link_bw)
        delay = self.cfg.transfer_backoff_s
        for attempt in range(self.cfg.transfer_retries + 1):
            if attempt:
                self.stats["transfer_retries"] += 1
                charge(delay + snap.kv_bytes / self.cfg.link_bw)
                delay *= 2
            verdict = (self.injector.transfer_verdict()
                       if self.injector is not None else "ok")
            if verdict == "drop":
                self.stats["transfers_dropped"] += 1
                continue
            wire = snap.clone()
            if verdict == "corrupt":
                self.injector.corrupt(wire)
            if not wire.verify():
                self.stats["corruptions_detected"] += 1
                continue
            try:
                wire.commit(dst_engine)
                return True
            except (OutOfBlocks, ValueError):
                break
        self.stats["transfer_failures"] += 1
        return False

    # ----------------------------------------------------------- suspension
    def suspend(self, engine, rid: int, tick: int) -> KVSnapshot:
        """Preemption-by-demotion: detach ``rid`` into a host-held sealed
        snapshot and queue it for a resume after the cooldown."""
        snap = KVSnapshot.export(engine, rid)
        self.suspended.append((snap, tick))
        self.stats["preemptions"] += 1
        return snap

    def resumable(self, tick: int) -> list[KVSnapshot]:
        """Suspended snapshots whose cooldown has passed, in suspend
        order (the router drops the ones it resumes)."""
        return [s for s, t in self.suspended
                if tick - t >= self.cfg.resume_cooldown_ticks]

    def drop_suspended(self, snap: KVSnapshot) -> None:
        self.suspended = [(s, t) for s, t in self.suspended
                          if s is not snap]
