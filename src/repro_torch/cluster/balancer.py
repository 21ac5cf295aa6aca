"""Online inter-device KV scheduling (paper §4.3): keep a heterogeneous
fleet balanced by migrating running requests off overloaded devices.

Every ``rebalance_interval`` router ticks the balancer scores each
device with the *modeled load* signal

    load = (running + queued) * modeled_step_latency

(the step latency comes from the device's perfmodel latency model —
its last charged step, or the device-class prior before first dispatch)
and, when the slowest device's load exceeds the fastest candidate's by
the ``hysteresis`` factor, migrates the slowest device's
LOWEST-importance-mass request (the cheapest accuracy stake, mirroring
Alg. 2's move-the-least-important-first rule at inter-device scope) to
the fastest device with blocks and a slot free. Hysteresis plus a
per-request ``cooldown`` window keep requests from ping-ponging between
devices under oscillating load. Counterpart of ``repro.cluster.balancer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.cluster import migration


@dataclasses.dataclass(frozen=True)
class BalancerConfig:
    rebalance_interval: int = 8    # router ticks between balancer runs
    hysteresis: float = 1.5        # min slow/fast load ratio to act
    cooldown_ticks: int = 24       # per-request immunity after a move
    max_moves_per_round: int = 1
    min_remaining: int = 4         # don't move nearly-finished requests
    link_bw: float = 64e9          # migration interconnect bytes/s


class KVBalancer:
    """Stateful balancer driven by the router (see ``ClusterRouter``)."""

    def __init__(self, cfg: BalancerConfig = BalancerConfig()):
        self.cfg = cfg
        self.migrations = 0
        self.moved_bytes = 0
        self.token_bytes = 0.0     # modeled KV bytes per engine token;
        # 0 -> charge the snapshot's raw array bytes (wall-clock runs);
        # ClusterSpec.build sets the model's kv_bytes_per_token here.
        self.log: list[dict[str, Any]] = []
        self._last_moved: dict[int, int] = {}    # rid -> router tick

    # ------------------------------------------------------------ signals
    def device_load(self, dev) -> float:
        """Modeled load of one ``ClusterDevice``: occupancy-weighted
        step latency. Idle devices score 0 (always a migration target,
        never a source)."""
        eng = dev.engine
        n = sum(s is not None for s in eng.slots) + len(eng.waiting)
        if n == 0:
            return 0.0
        step = eng.last_step_time or dev.step_prior
        return n * step

    # ---------------------------------------------------------- rebalance
    def rebalance(self, devices: list, tick: int) -> list[dict[str, Any]]:
        """One balancing round over the router's devices. Returns the
        migration records performed (possibly empty)."""
        if len(devices) < 2:
            return []
        moves: list[dict[str, Any]] = []
        for _ in range(self.cfg.max_moves_per_round):
            rec = self._one_move(devices, tick)
            if rec is None:
                break
            moves.append(rec)
        return moves

    def _one_move(self, devices: list, tick: int
                  ) -> Optional[dict[str, Any]]:
        ranked = sorted(devices, key=self.device_load)
        slow = ranked[-1]
        slow_load = self.device_load(slow)
        if slow_load <= 0.0:
            return None
        victim_mass = slow.engine.slot_importance_mass()

        def eligible(rid: int) -> bool:
            if (tick - self._last_moved.get(rid, -10**9)
                    < self.cfg.cooldown_ticks):
                return False
            rs = slow.engine.requests[rid]
            remaining = rs.request.max_new_tokens - len(rs.outputs)
            return remaining >= self.cfg.min_remaining

        # lowest importance mass first (cheapest accuracy stake)
        victims = sorted(filter(eligible, victim_mass),
                         key=lambda rid: victim_mass[rid])
        for dst in ranked[:-1]:
            dst_load = self.device_load(dst)
            # hysteresis: act only on a decisive imbalance; compare
            # against the destination as if it took one more request
            step = dst.engine.last_step_time or dst.step_prior
            if slow_load < self.cfg.hysteresis * (dst_load + step):
                continue
            for rid in victims:
                if not migration.can_migrate(slow.engine, dst.engine, rid):
                    continue
                # idleness must be sampled BEFORE the commit occupies a
                # destination slot
                dst_idle = not any(s is not None
                                   for s in dst.engine.slots)
                rec = migration.migrate(slow.engine, dst.engine, rid)
                if self.token_bytes:
                    rec["bytes"] = int(rec["tokens"] * self.token_bytes)
                rec["transfer_s"] = rec["bytes"] / self.cfg.link_bw
                # an IDLE target skips ahead to the export time (the
                # request cannot resume before it was exported); a busy
                # target keeps its own timeline — it catches up on its
                # next steps — and always pays the transfer
                if dst_idle:
                    dst.engine.clock = max(dst.engine.clock,
                                           slow.engine.clock)
                dst.engine.clock += rec["transfer_s"]
                self._last_moved[rid] = tick
                self.migrations += 1
                self.moved_bytes += rec["bytes"]
                rec["tick"] = tick
                self.log.append(rec)
                return rec
        return None
