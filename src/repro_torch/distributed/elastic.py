"""Fault-detection bookkeeping (counterpart of the first half of
``repro.distributed.elastic``; numpy only).

1. ``StragglerMonitor`` — per-host step times; a host whose latest step
   exceeds ``threshold x`` the leave-one-out median of its peers for
   ``patience`` consecutive observations is flagged.
2. ``HeartbeatLedger`` — liveness: hosts silent for ``dead_after``
   (in whatever units ``beat`` is driven with) are presumed dead.

3. ``plan_recovery`` — the surviving sites after host failures, cut to
   whole model replicas; ``rescale_batch`` — the elastic batch policy.

The serving cluster's watchdog (``repro_torch.cluster.recovery``) feeds
the monitor step times normalized to slowdown factors by each device's
own latency model, and the ledger with modeled clock seconds; the train
CLI records each step's wall time. A re-meshed run restores its
checkpoint onto the new grid (``checkpoint.restore_pytree(shardings=)``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x median
    patience: int = 3
    window: int = 32

    def __post_init__(self):
        self._times: dict[int, deque] = {}
        self._strikes: dict[int, int] = {}

    def record(self, host: int, step_time: float) -> None:
        dq = self._times.setdefault(host, deque(maxlen=self.window))
        dq.append(step_time)

    def observe_step(self) -> None:
        """Close one observation step: compare every host's latest step
        time against the median of its peers' and update the strike
        counters (the only mutating evaluation: call once per step).
        Leaving the host out of its own reference matters on small
        fleets: with two hosts a shared median sits halfway up the
        straggler's slowdown."""
        latest = {h: dq[-1] for h, dq in self._times.items() if dq}
        if len(latest) < 2:
            return
        for h, t in latest.items():
            peers = [v for g, v in latest.items() if g != h]
            med = float(np.median(peers))
            if t > self.threshold * max(med, 1e-9):
                self._strikes[h] = self._strikes.get(h, 0) + 1
            else:
                self._strikes[h] = 0

    def stragglers(self) -> list[int]:
        """Hosts flagged now (a pure query): ``patience`` consecutive
        ``observe_step`` evaluations above ``threshold x`` the peers'
        median."""
        return [h for h, s in self._strikes.items() if s >= self.patience]


@dataclasses.dataclass
class HeartbeatLedger:
    """Liveness ledger. ``dead_after`` is in the units ``beat`` is driven
    with (modeled clock seconds in the serving watchdog). A presumed-dead
    host that reports again leaves ``dead_hosts()`` on its next beat."""
    dead_after: float = 5

    def __post_init__(self):
        self._last_seen: dict[int, float] = {}
        self._step = 0.0

    def beat(self, host: int, step: float) -> None:
        self._last_seen[host] = step
        self._step = max(self._step, step)

    def advance(self, step: float) -> None:
        """Advance the ledger clock without any host reporting (the
        watchdog's wait on a hung device)."""
        self._step = max(self._step, step)

    def dead_hosts(self) -> list[int]:
        return [h for h, s in self._last_seen.items()
                if self._step - s >= self.dead_after]


def plan_recovery(all_devices: Sequence, failed_hosts: set[int],
                  model_parallel: int, devices_per_host: int = 8
                  ) -> tuple[list, dict]:
    """Surviving-site plan after failures.

    Drops every device (or site index) on a failed host, truncates to a
    whole number of data replicas (each replica = ``model_parallel``
    sites), and reports what was sacrificed. Returns (devices_for_new_grid,
    info)."""
    survivors = [d for i, d in enumerate(all_devices)
                 if (i // devices_per_host) not in failed_hosts]
    replicas = len(survivors) // model_parallel
    if replicas == 0:
        raise RuntimeError("not enough devices for one model replica")
    kept = survivors[: replicas * model_parallel]
    info = {
        "lost_devices": len(all_devices) - len(survivors),
        "idle_devices": len(survivors) - len(kept),
        "new_dp": replicas,
        "model_parallel": model_parallel,
    }
    return kept, info


def rescale_batch(global_batch: int, old_dp: int, new_dp: int,
                  keep_global: bool = True) -> tuple[int, int]:
    """Elastic batch policy: keep the global batch (more grad-accum per
    replica) or keep per-replica batch (smaller global). Returns
    (per_replica_batch, accum_steps)."""
    per = global_batch // old_dp
    if keep_global:
        total_per_replica = global_batch // new_dp
        accum = max(1, -(-total_per_replica // per))
        return per, accum
    return per, 1
