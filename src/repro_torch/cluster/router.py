"""Multi-device cluster router (paper §4.3): one request stream served
across N heterogeneous ``ServingEngine`` instances. Counterpart of
``repro.cluster.router``.

The router owns a shared arrival queue and binds requests to devices as
late as possible: a queued request is dispatched only when some device
can admit it right now, to the device with the lowest admission cost

    cost = waves * (prompt * prefill_cost_per_token + gen * step_latency)
           + occupancy_weight * pool_occupancy

— modeled service time times the admission waves ahead of it, plus pool
pressure. Each device keeps its own clock (its latency model charges
every step); the router advances the fleet event by event, always
stepping the busy device whose clock is furthest behind, so fast devices
take more steps per modeled second. Tokens stream out through
``drain_events`` as they are emitted, and an attached ``KVBalancer``
migrates running requests off overloaded devices every
``rebalance_interval`` ticks (``repro_torch.cluster.migration``).

With the perf model's latency models (``ClusterSpec(wallclock=False)``)
the run is deterministic: the same seeded stream gives the same events,
bindings and migrations as the reference's router. The devices are
modeled classes; on one GPU all engines run on the one card, in turn.

Not ported yet (ROADMAP Queue 1 item 8): fault tolerance — the
watchdog, replay after device loss, drain, suspend/resume scheduling,
``shed`` and ``force_preempt``. ``recovery=``, ``faults=`` and
``preemptible=True`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable, Iterator, Optional

import numpy as np

from repro_torch.cluster.balancer import KVBalancer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.perfmodel.devices import DeviceClass
from repro_torch.serving.engine import DONE, Request, ServingEngine
from repro_torch.serving.events import ServeEvent

FAULT_TOLERANCE_TODO = ("fault tolerance (watchdog, replay, drain, "
                        "preemption) is not ported yet: ROADMAP Queue 1 "
                        "item 8")


@dataclasses.dataclass
class ClusterDevice:
    """One engine + its device class inside the router."""
    name: str
    cls: DeviceClass
    engine: ServingEngine
    step_prior: float = 0.0      # a-priori step latency (cost signal seed)
    prefill_tok_prior: float = 0.0   # modeled seconds per prefill token
    tokens_emitted: int = 0
    steps: int = 0

    def has_work(self) -> bool:
        eng = self.engine
        return bool(eng.waiting) or any(s is not None for s in eng.slots)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    occupancy_weight: float = 1e-3   # pool-pressure term in the cost
    max_ticks: int = 200_000


class ClusterRouter:
    """Route one request stream over heterogeneous serving engines."""

    def __init__(self, devices: list[ClusterDevice],
                 balancer: Optional[KVBalancer] = None,
                 rcfg: RouterConfig = RouterConfig(),
                 recovery=None, faults=None):
        if recovery is not None or faults is not None:
            raise NotImplementedError(FAULT_TOLERANCE_TODO)
        if not devices:
            raise ValueError("cluster needs at least one device")
        names = [d.name for d in devices]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device names: {names}")
        self.devices = devices
        self.balancer = balancer
        self.rcfg = rcfg
        self.arrivals: collections.deque[Request] = collections.deque()
        self.queue: collections.deque[Request] = collections.deque()
        self.ticks = 0
        self.finished: dict[int, Any] = {}       # rid -> RequestState
        self.rejected = 0
        self._events: list[ServeEvent] = []
        self._seen_tokens: dict[int, int] = {}   # rid -> emitted count
        self._shape: dict[int, tuple[int, int]] = {}  # rid -> (prompt, gen)
        self._bind_obs()

    def _bind_obs(self) -> None:
        """Bind the router's instruments against the installed registry
        (see ``ServingEngine._bind_obs``). Balancer work is metered by
        diffing its cumulative counters once per rebalance tick."""
        reg = obs_metrics.get_registry()
        self._mreg = reg
        self._m_ticks = reg.counter(
            "pam_cluster_ticks_total", "router scheduling iterations")
        self._m_queue = reg.gauge(
            "pam_cluster_queue_depth",
            "requests in the shared (unbound) queue")
        self._m_rejected = reg.counter(
            "pam_cluster_rejected_total",
            "streams ended with a rejection event")
        self._m_bal_migrations = reg.counter(
            "pam_cluster_balancer_migrations_total",
            "requests moved by the online balancer")
        self._m_bal_bytes = reg.counter(
            "pam_cluster_balancer_migrated_bytes_total",
            "KV bytes moved by the online balancer")
        self._m_mig_bytes_h = reg.histogram(
            "pam_cluster_migration_bytes",
            "bytes per balancer rebalance burst",
            buckets=obs_metrics.BYTES_BUCKETS)
        self._bal_seen = (0, 0)          # (migrations, bytes) last diffed

    def _observe_balancer(self) -> None:
        """Fold the balancer's cumulative counters into the registry
        (right after each rebalance)."""
        if self.balancer is None or not self._mreg.enabled:
            return
        m, b = self.balancer.migrations, self.balancer.moved_bytes
        dm, db = m - self._bal_seen[0], b - self._bal_seen[1]
        self._bal_seen = (m, b)
        if dm:
            self._m_bal_migrations.inc(dm)
        if db:
            self._m_bal_bytes.inc(db)
            self._m_mig_bytes_h.observe(db)

    # -------------------------------------------------------- device views
    def _steppable(self) -> list[ClusterDevice]:
        """Devices holding work the router can advance."""
        return [d for d in self.devices if d.has_work()]

    # ------------------------------------------------------------- intake
    def _reject(self, req: Request) -> None:
        """End the request's stream with a rejection event (done=True,
        no token) instead of raising: one unservable request never stops
        the stream."""
        self.rejected += 1
        self._m_rejected.inc()
        t = max(self.now(), req.arrival)
        self._events.append(ServeEvent(
            time=t, request_id=req.id,
            token=-1, index=self._seen_tokens.get(req.id, 0), device="",
            done=True, rejected=True))
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.mark(req.id, "reject", t)
            phase = tr.open_phase(req.id)
            if phase is not None:
                tr.end(req.id, phase, t)

    def submit(self, req: Request) -> None:
        """Add a request to the shared stream (``req.arrival`` is its
        arrival on the modeled clock; submissions must be time-ordered).
        A request no device can ever serve is rejected (an event)."""
        if self.arrivals and req.arrival < self.arrivals[-1].arrival:
            raise ValueError("submit arrivals in nondecreasing time order")
        window = len(req.prompt) + req.max_new_tokens
        self._shape[req.id] = (len(req.prompt), req.max_new_tokens)
        if not any(d.engine.serviceable(window) for d in self.devices):
            self._reject(req)
            return
        self.arrivals.append(req)
        tr = obs_trace.COLLECTOR
        if tr is not None:
            # the span opens at arrival; the engine's submit re-begins
            # the same phase idempotently when the request is bound
            tr.begin(req.id, "queued", req.arrival,
                     prompt=len(req.prompt))

    def submit_to(self, req: Request, device_name: str) -> None:
        """Pin a request to one device, bypassing cost-based dispatch
        (to pre-load a device; real traffic goes through ``submit``). An
        unserviceable window rejects (an event) instead of raising."""
        dev = self._by_name(device_name)
        window = len(req.prompt) + req.max_new_tokens
        self._shape[req.id] = (len(req.prompt), req.max_new_tokens)
        if not dev.engine.serviceable(window):
            self._reject(req)
            return
        dev.engine.submit(req)

    # ------------------------------------------------------------ signals
    def now(self) -> float:
        """Cluster frontier: the slowest steppable device's clock (none
        in flight: the largest clock)."""
        busy = [d.engine.clock for d in self._steppable()]
        if busy:
            return min(busy)
        return max(d.engine.clock for d in self.devices)

    def admission_cost(self, dev: ClusterDevice, prompt_len: int,
                       gen_len: int, pending: int = 0) -> float:
        """Expected completion cost of placing one request on ``dev``:
        its whole service there (modeled prefill of the prompt +
        ``gen_len`` modeled decode steps) times the admission waves
        ahead of it (device queue, ``pending`` requests deferred toward
        it this round, half the running batch), plus pool pressure.
        Pricing the whole service, prefill included, keeps bursts off a
        slow device whose free slots look open."""
        sig = dev.engine.load_signal()
        step = sig["step_time_s"] or dev.step_prior
        service = prompt_len * dev.prefill_tok_prior + gen_len * step
        ahead = (sig["queue_depth"] + pending + 0.5 * sig["running"])
        waves = -(-int(ahead + 1) // max(dev.engine.scfg.max_batch, 1))
        return (waves * service
                + self.rcfg.occupancy_weight * sig["pool_occupancy"])

    # ----------------------------------------------------------- dispatch
    def _release_arrivals(self) -> None:
        horizon = self.now()
        while self.arrivals and self.arrivals[0].arrival <= horizon:
            self.queue.append(self.arrivals.popleft())

    def _dispatch(self) -> None:
        """Cost-based late binding. Each queued request is priced on
        every device that can serve it, busy ones included, and bound to
        the cheapest; if that one cannot admit it now, it stays in the
        shared queue (deferred) with a virtual-depth mark so the rest of
        the round prices that device one deeper."""
        still: collections.deque[Request] = collections.deque()
        virtual = {d.name: 0 for d in self.devices}
        while self.queue:
            req = self.queue.popleft()
            prompt_len, gen_len = self._shape[req.id]
            window = prompt_len + gen_len
            cands = [d for d in self.devices
                     if d.engine.serviceable(window)]
            if not cands:
                self._reject(req)
                continue
            best = min(cands, key=lambda d: self.admission_cost(
                d, prompt_len, gen_len, pending=virtual[d.name]))
            # can_accept nets out the device's own waiting queue, so one
            # round cannot over-assign a device
            if best.engine.can_accept(window):
                # an idle device may have an old clock; it cannot serve
                # a request before the request exists
                best.engine.clock = max(best.engine.clock, req.arrival)
                best.engine.submit(req)
            else:
                virtual[best.name] += 1
                still.append(req)
        self.queue = still

    # ------------------------------------------------------------ stepping
    def _collect(self, dev: ClusterDevice) -> None:
        """Diff the device's request states into stream events and pick
        up completions."""
        eng = dev.engine
        done_rids = []
        for rid, rs in eng.requests.items():
            seen = self._seen_tokens.get(rid, 0)
            for i in range(seen, len(rs.outputs)):
                t = (rs.token_times[i] if i < len(rs.token_times)
                     else eng.clock)
                self._events.append(ServeEvent(
                    time=t, request_id=rid, token=rs.outputs[i], index=i,
                    device=dev.name,
                    done=(rs.status == DONE and i == len(rs.outputs) - 1)))
                dev.tokens_emitted += 1
            self._seen_tokens[rid] = max(seen, len(rs.outputs))
            if rs.status == DONE:
                done_rids.append(rid)
        for rid in done_rids:
            self.finished[rid] = eng.requests.pop(rid)

    def tick(self) -> bool:
        """One router iteration. Returns False when the stream is fully
        served (no arrivals, no queue, no running work)."""
        # idle fleet + future arrivals: jump the fleet to the next event
        if self.arrivals and not self.queue and not self._steppable():
            t = self.arrivals[0].arrival
            for d in self.devices:
                d.engine.clock = max(d.engine.clock, t)
        self._release_arrivals()
        self._dispatch()
        steppable = self._steppable()
        if steppable:
            # event-driven: advance the furthest-behind steppable device
            dev = min(steppable, key=lambda d: d.engine.clock)
            dev.engine.step()
            dev.steps += 1
            self._collect(dev)
        self.ticks += 1
        if self._mreg.enabled:
            self._m_ticks.inc()
            self._m_queue.set(len(self.queue))
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.counter("router", "shared_queue", self.now(),
                       depth=len(self.queue))
        if (self.balancer is not None
                and self.ticks % self.balancer.cfg.rebalance_interval == 0):
            # migrated requests carry their outputs with them; pending
            # tokens surface at the destination's next _collect
            self.balancer.rebalance(self.devices, self.ticks)
            self._observe_balancer()
        return bool(self.arrivals or self.queue or self._steppable())

    def run(self, max_ticks: Optional[int] = None) -> dict[str, Any]:
        limit = max_ticks if max_ticks is not None else self.rcfg.max_ticks
        for _ in range(limit):
            if not self.tick():
                break
        else:
            raise RuntimeError(f"cluster did not drain in {limit} ticks")
        return self.summary()

    def _by_name(self, name: str) -> ClusterDevice:
        return next(d for d in self.devices if d.name == name)

    # ----------------------------------------------------------- streaming
    def drain_events(self) -> list[ServeEvent]:
        """Token events emitted since the last drain, in emission order."""
        out, self._events = self._events, []
        return out

    def as_router(self) -> "ClusterRouter":
        """A router is already a router (``ServingEngine.as_router``
        wraps a bare engine the same way)."""
        return self

    def serve(self, requests: Optional[Iterable[Request]] = None, *,
              max_ticks: Optional[int] = None) -> Iterator[ServeEvent]:
        """Submit ``requests`` (if given), then tick until the stream
        drains, yielding each ``ServeEvent`` in emission order."""
        if requests is not None:
            for req in requests:
                self.submit(req)
        yield from self.drain_events()
        limit = max_ticks if max_ticks is not None else self.rcfg.max_ticks
        for _ in range(limit):
            live = self.tick()
            yield from self.drain_events()
            if not live:
                return
        raise RuntimeError(f"cluster did not drain in {limit} ticks")

    @classmethod
    def for_engine(cls, engine: ServingEngine, *,
                   name: Optional[str] = None,
                   rcfg: RouterConfig = RouterConfig(),
                   preemptible: bool = False) -> "ClusterRouter":
        """Wrap one engine as a one-device cluster, so every front end
        speaks one backend dialect."""
        if preemptible:
            raise NotImplementedError(FAULT_TOLERANCE_TODO)
        dc = DeviceClass(name="local", max_batch=engine.scfg.max_batch)
        dev = ClusterDevice(name=name or engine.name or "local0", cls=dc,
                            engine=engine)
        if engine.latency_model is not None:
            dev.prefill_tok_prior = float(
                engine.latency_model({"prefill_tokens": 1, "active": 0}))
        return cls([dev], rcfg=rcfg)

    # ------------------------------------------------------------- metrics
    def summary(self) -> dict[str, Any]:
        makespan = max(d.engine.clock for d in self.devices)
        total_tokens = sum(len(rs.outputs) for rs in self.finished.values())
        per_device = {}
        for d in self.devices:
            per_device[d.name] = {
                "class": d.cls.name,
                "state": "up",       # no fault tolerance: never down
                "steps": d.steps,
                "tokens_emitted": d.tokens_emitted,
                "busy_time_s": d.engine.busy_time,
                "utilization": (d.engine.busy_time / makespan
                                if makespan > 0 else 0.0),
                "decode_dispatches": d.engine.decode_dispatches,
                "decode_device_steps": d.engine.decode_device_steps,
                "migrations_in": d.engine.migrations_in,
                "migrations_out": d.engine.migrations_out,
            }
        return {
            "finished": len(self.finished),
            "rejected": self.rejected,
            "total_tokens": total_tokens,
            "makespan_s": makespan,
            "throughput_tok_s": (total_tokens / makespan
                                 if makespan > 0 else 0.0),
            # balancer_* is the balancer's own work; migrations_in/out
            # are the fleet-wide engine-level sums
            "balancer_migrations": (self.balancer.migrations
                                    if self.balancer is not None else 0),
            "migrated_bytes": (self.balancer.moved_bytes
                               if self.balancer is not None else 0),
            "migrations_in": sum(d.engine.migrations_in
                                 for d in self.devices),
            "migrations_out": sum(d.engine.migrations_out
                                  for d in self.devices),
            "ticks": self.ticks,
            "devices": per_device,
        }

    def slo_attainment(self, slo_s: float) -> float:
        """Fraction of decode-token gaps within the SLO, fleet-wide
        (migration seams clamp at 0: clocks resync on transfer)."""
        gaps: list[float] = []
        for rs in self.finished.values():
            if len(rs.token_times) > 1:
                gaps.extend(np.maximum(np.diff(rs.token_times), 0.0)
                            .tolist())
        if not gaps:
            return 1.0
        return float(np.mean(np.asarray(gaps) <= slo_s))
