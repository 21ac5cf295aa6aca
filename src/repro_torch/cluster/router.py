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

Fault tolerance (``repro_torch.cluster.{faults,recovery}``): with a
``RecoveryManager`` attached the router runs a watchdog every tick.
Alive devices heartbeat the clock frontier into a ``HeartbeatLedger``; a
killed device goes silent and is declared dead after
``heartbeat_timeout_s``, and the requests it held replay from their
prompts on survivors (exact: per-request sampling keys, and the router
suppresses the regenerated prefix it already streamed). A
``StragglerMonitor`` over prior-normalized step times flags a stalled
device, which is drained: its running requests move to survivors as
checksummed ``KVSnapshot`` transfers with bounded retry. Overload
degrades instead of failing: unserviceable submissions end with
rejection events, and a starving queue head preempts the fleet's
lowest-importance running request into a host-held snapshot (resumed
after a cooldown).

The recovery decisions use only what a control plane has: its own
submit-time registry (``_requests``), its streamed-token history
(``_history``) and the watchdog's verdicts. A dead engine's internals
are read only to list the requests the router placed there.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from repro_torch.cluster.balancer import BalancerConfig, KVBalancer
from repro_torch.cluster.faults import (TRANSFER_KINDS, FaultEvent,
                                        FaultInjector)
from repro_torch.cluster.migration import KVSnapshot
from repro_torch.cluster.recovery import RecoveryConfig, RecoveryManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.perfmodel.devices import DeviceClass
from repro_torch.serving.engine import (DONE, RUNNING, Request,
                                        ServingConfig, ServingEngine,
                                        check_prompt_ids)
from repro_torch.serving.events import ServeEvent


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
    # fault-tolerance state. ``state`` is the router's belief ("up",
    # "dead", "drained"); ``killed`` is the injector's ground truth,
    # which the router never reads for decisions: it only makes a killed
    # engine unsteppable and silent, for the watchdog to detect.
    state: str = "up"
    killed: bool = False
    stall_factor: float = 1.0
    base_latency: Optional[Callable[[dict], float]] = None
    hog_rid: Optional[int] = None    # the exhaust fault's pool hog

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
                 recovery: Optional[RecoveryManager] = None,
                 faults: Optional[FaultInjector] = None):
        if not devices:
            raise ValueError("cluster needs at least one device")
        names = [d.name for d in devices]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device names: {names}")
        self.devices = devices
        self.balancer = balancer
        self.rcfg = rcfg
        self.recovery = recovery
        self.faults = faults
        self.arrivals: collections.deque[Request] = collections.deque()
        self.queue: collections.deque[Request] = collections.deque()
        self.ticks = 0
        self.finished: dict[int, Any] = {}       # rid -> RequestState
        self.rejected = 0
        self._events: list[ServeEvent] = []
        self._seen_tokens: dict[int, int] = {}   # rid -> emitted count
        self._shape: dict[int, tuple[int, int]] = {}  # rid -> (prompt, gen)
        self._requests: dict[int, Request] = {}  # submit-time registry
        self._history: dict[int, list[int]] = {}  # rid -> streamed tokens
        self._replaying: set[int] = set()        # rids re-serving a prefix
        self._kill_clock: dict[str, float] = {}  # device -> kill time
        self._head_since: Optional[tuple[int, int]] = None  # (rid, tick)
        # the control plane's own watchdog clock: it advances even when
        # every device is silent (else a whole-fleet kill would freeze
        # the frontier and silence could never time out)
        self._wait_clock = 0.0
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
        self._m_sheds = reg.counter(
            "pam_cluster_sheds_total",
            "queued requests shed by admission control")
        self._m_force_preempts = reg.counter(
            "pam_cluster_force_preempts_total",
            "SLO-driven immediate preemptions")
        self._m_faults = reg.counter(
            "pam_cluster_faults_total", "chaos faults applied, by kind",
            ("kind",))
        self._m_verdicts = reg.counter(
            "pam_cluster_watchdog_verdicts_total",
            "watchdog verdicts, by outcome", ("verdict",))
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
        """Devices the router can advance: alive (a killed engine never
        answers a step) and holding work. A drained device still
        finishes its residual batch; it only gets no new dispatches."""
        return [d for d in self.devices
                if not d.killed and d.state != "dead" and d.has_work()]

    def _alive(self) -> list[ClusterDevice]:
        return [d for d in self.devices
                if not d.killed and d.state != "dead"]

    def _up(self) -> list[ClusterDevice]:
        """Dispatch targets: the devices the router believes healthy."""
        return [d for d in self.devices if d.state == "up"]

    def _failed_pending(self) -> list[ClusterDevice]:
        """Killed but undetected devices still holding work: the
        watchdog must wait out the timeout to discover them."""
        return [d for d in self.devices
                if d.killed and d.state == "up" and d.has_work()]

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

    def check_prompt(self, prompt) -> None:
        """``ValueError`` unless every prompt id lies in ``[0, vocab)``
        of the fleet's model."""
        check_prompt_ids(prompt, min(d.engine.cfg.vocab
                                     for d in self.devices))

    def submit(self, req: Request) -> None:
        """Add a request to the shared stream (``req.arrival`` is its
        arrival on the modeled clock; submissions must be time-ordered).
        A request no healthy device can ever serve is rejected (an
        event). A prompt id outside ``[0, vocab)`` raises ``ValueError``
        (``check_prompt``) and registers nothing."""
        self.check_prompt(req.prompt)
        if self.arrivals and req.arrival < self.arrivals[-1].arrival:
            raise ValueError("submit arrivals in nondecreasing time order")
        window = len(req.prompt) + req.max_new_tokens
        self._requests[req.id] = req
        self._shape[req.id] = (len(req.prompt), req.max_new_tokens)
        if not any(d.engine.serviceable(window) for d in self._up()):
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
        unserviceable window rejects (an event) instead of raising; a
        prompt id outside ``[0, vocab)`` raises ``ValueError``."""
        self.check_prompt(req.prompt)
        dev = self._by_name(device_name)
        window = len(req.prompt) + req.max_new_tokens
        self._requests[req.id] = req
        self._shape[req.id] = (len(req.prompt), req.max_new_tokens)
        if dev.state != "up" or not dev.engine.serviceable(window):
            self._reject(req)
            return
        dev.engine.submit(req)

    # ------------------------------------------------------------ signals
    def now(self) -> float:
        """Cluster frontier: the slowest steppable device's clock (none
        in flight: the largest healthy clock)."""
        busy = [d.engine.clock for d in self._steppable()]
        if busy:
            return min(busy)
        pool = [d.engine.clock for d in self._up()
                if not d.killed] or [d.engine.clock for d in self.devices]
        return max(pool)

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
        every healthy device that can serve it, busy ones included, and
        bound to the cheapest; if that one cannot admit it now, it stays
        in the shared queue (deferred) with a virtual-depth mark so the
        rest of the round prices that device one deeper. A request no
        healthy device can serve any more (device loss) is rejected."""
        still: collections.deque[Request] = collections.deque()
        virtual = {d.name: 0 for d in self.devices}
        while self.queue:
            req = self.queue.popleft()
            prompt_len, gen_len = self._shape[req.id]
            window = prompt_len + gen_len
            cands = [d for d in self._up()
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
        up completions. A replayed request first regenerates its
        already-streamed prefix: those tokens are checked against the
        router's history and never re-emitted, so the client's stream
        stays gapless and free of duplicates across a device loss."""
        eng = dev.engine
        done_rids = []
        for rid, rs in eng.requests.items():
            seen = self._seen_tokens.get(rid, 0)
            if rid in self._replaying:
                hist = self._history.get(rid, [])
                n = min(seen, len(rs.outputs))
                if rs.outputs[:n] != hist[:n]:
                    raise RuntimeError(
                        f"replay diverged for request {rid}: regenerated "
                        f"prefix does not match the streamed history")
                if len(rs.outputs) >= seen:
                    self._replaying.discard(rid)
            for i in range(seen, len(rs.outputs)):
                t = (rs.token_times[i] if i < len(rs.token_times)
                     else eng.clock)
                self._events.append(ServeEvent(
                    time=t, request_id=rid, token=rs.outputs[i], index=i,
                    device=dev.name,
                    done=(rs.status == DONE and i == len(rs.outputs) - 1)))
                self._history.setdefault(rid, []).append(rs.outputs[i])
                dev.tokens_emitted += 1
            self._seen_tokens[rid] = max(seen, len(rs.outputs))
            if rs.status == DONE:
                done_rids.append(rid)
        for rid in done_rids:
            self.finished[rid] = eng.requests.pop(rid)

    # ---------------------------------------------------------- fault path
    def _apply_fault(self, ev: FaultEvent) -> None:
        """Apply one injected fault (the ``FaultInjector``'s ground
        truth)."""
        self._m_faults.labels(kind=ev.kind).inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.instant(ev.device, f"fault:{ev.kind}", self.now())
        if ev.kind in TRANSFER_KINDS:
            return                       # armed inside the injector
        dev = self._by_name(ev.device)
        eng = dev.engine
        if ev.kind == "kill":
            dev.killed = True
            # the injection moment is the fleet's time, not the victim's
            # own clock (an idle victim's clock lags the frontier, which
            # would overstate the recovery latency)
            self._kill_clock[dev.name] = max(
                (d.engine.clock for d in self.devices), default=eng.clock)
        elif ev.kind == "stall":
            dev.stall_factor = ev.factor
            if dev.base_latency is None:
                dev.base_latency = eng.latency_model
            if dev.base_latency is not None:
                # the engine reads ``latency_model`` at every step
                base, f = dev.base_latency, ev.factor
                eng.latency_model = lambda s: f * float(base(s))
        elif ev.kind == "unstall":
            dev.stall_factor = 1.0
            if dev.base_latency is not None:
                eng.latency_model = dev.base_latency
        elif ev.kind == "exhaust":
            alloc = eng.allocator
            if (alloc is not None and dev.hog_rid is None
                    and alloc.free_blocks > 0):
                # a host-side allocator key only: no tensor holds it
                dev.hog_rid = (1 << 40) + self.devices.index(dev)
                alloc.allocate(dev.hog_rid,
                               alloc.free_blocks * alloc.block_size)
        elif ev.kind == "release":
            if eng.allocator is not None and dev.hog_rid is not None:
                eng.allocator.free(dev.hog_rid)
                dev.hog_rid = None

    def _charge(self, dev: ClusterDevice, seconds: float) -> None:
        dev.engine.clock += seconds

    def _rescue_target(self, snap: KVSnapshot,
                       exclude: str) -> Optional[ClusterDevice]:
        window = (len(snap.request.prompt)
                  + snap.request.max_new_tokens)
        cands = [d for d in self._up()
                 if d.name != exclude and d.engine.serviceable(window)
                 and d.engine.can_accept(window, reserve_queued=False)]
        if not cands:
            return None
        plen, glen = self._shape.get(snap.request.id,
                                     (len(snap.request.prompt),
                                      snap.request.max_new_tokens))
        remaining = glen - len(snap.outputs)
        return min(cands, key=lambda d: self.admission_cost(
            d, 0, max(remaining, 1)))

    def _declare_dead(self, dev: ClusterDevice) -> None:
        """Watchdog verdict: the device is gone and its KV with it.
        Every request the router placed there goes back to the shared
        queue to replay on a survivor (exact: recomputation is
        deterministic per seed, request and position, and ``_collect``
        suppresses the regenerated prefix)."""
        rec = self.recovery
        dev.state = "dead"
        rec.stats["kills_detected"] += 1
        self._m_verdicts.labels(verdict="dead").inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.instant(dev.name, "watchdog:dead", self.now())
        t_kill = self._kill_clock.get(dev.name, dev.engine.clock)
        alive = self._alive()
        t_now = (max(d.engine.clock for d in alive) if alive
                 else dev.engine.clock)
        rec.note_recovery(max(t_now - t_kill, 0.0))
        eng = dev.engine
        for rid in list(eng.requests):
            rs = eng.requests.pop(rid)
            if rs.status == DONE:        # already collected upstream
                self.finished.setdefault(rid, rs)
                continue
            req = self._requests.get(rid, rs.request)
            if self._seen_tokens.get(rid, 0):
                self._replaying.add(rid)
            if rs.status == RUNNING:
                rec.stats["replays"] += 1
                if tr is not None:
                    tr.mark(rid, "replay", self.now(), lost=dev.name)
                    tr.begin(rid, "queued", self.now(), replay=True)
            self.queue.append(req)
        # the dead engine's host bookkeeping is gone with it; its pool
        # and rows stay allocated, as the reference's do, and its decode
        # graphs are released
        eng.waiting.clear()
        eng.slots = [None] * len(eng.slots)
        eng.release_graphs()

    def _drain(self, dev: ClusterDevice) -> None:
        """Graceful drain of a flagged (alive but degraded) device: its
        queued work returns to the shared queue; its running requests
        export as checksummed snapshots and transfer to survivors
        (bounded retry on drop or corruption, rollback here on terminal
        failure: the device is slow, not dead). A drained device gets no
        new work but finishes what could not move."""
        rec = self.recovery
        dev.state = "drained"
        self._m_verdicts.labels(verdict="drained").inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.instant(dev.name, "watchdog:drain", self.now())
        eng = dev.engine
        for rid in list(eng.waiting):
            eng.requests.pop(rid, None)
            self.queue.append(self._requests[rid])
        eng.waiting.clear()
        # only RUNNING requests have exportable KV; a request mid-chunked
        # prefill (PREFILLING) finishes filling and decodes here
        running = [rid for rid in eng.slots
                   if rid is not None
                   and eng.requests[rid].status == RUNNING]
        for rid in running:
            snap = KVSnapshot.export(eng, rid)
            dst = self._rescue_target(snap, exclude=dev.name)
            if dst is None:
                # no capacity anywhere now: hold it host-side and resume
                # through the suspension path when capacity frees
                rec.suspended.append((snap, self.ticks))
                continue
            if not any(s is not None for s in dst.engine.slots):
                dst.engine.clock = max(dst.engine.clock, eng.clock)
            if rec.transfer(snap, dst.engine,
                            lambda s, d=dst: self._charge(d, s)):
                rec.stats["drains"] += 1
            else:
                snap.commit(eng)         # pristine copy back home
        self._head_since = None

    def _watchdog(self) -> None:
        """Heartbeats and verdicts, once per tick. Alive devices beat
        the fleet frontier (a live host answers its control plane however
        stale its own work clock is); a killed device's beat freezes, and
        once the frontier moves ``heartbeat_timeout_s`` past it the
        device is declared dead."""
        rec = self.recovery
        alive = self._alive()
        pool = alive or self.devices
        t = max(max(d.engine.clock for d in pool), self._wait_clock)
        for i, d in enumerate(self.devices):
            if not d.killed and d.state != "dead":
                rec.heartbeat(i, t)
        rec.advance(t)
        for i in rec.dead_indices():
            d = self.devices[i]
            if d.killed and d.state == "up":
                self._declare_dead(d)
        for i in rec.straggler_indices():
            d = self.devices[i]
            if d.state == "up" and not d.killed:
                self._drain(d)

    # ------------------------------------------------- degradation policies
    def shed(self, rid: int) -> bool:
        """Admission-control hook: drop a queued request and end its
        stream with a rejection event (load shedding for a request whose
        deadline is provably unmeetable, ``frontend.admission``). Only
        the shared queue is sheddable: a request placed on a device is
        past admission. True if the request was found and shed."""
        for req in self.queue:
            if req.id == rid:
                self.queue.remove(req)
                self._m_sheds.inc()
                tr = obs_trace.COLLECTOR
                if tr is not None:
                    tr.mark(rid, "shed", self.now())
                self._reject(req)
                return True
        return False

    def _preempt_victim(self, window: int,
                        exclude_rid: Optional[int] = None) -> bool:
        """Suspend the fleet's lowest-importance running request (the
        cheapest accuracy stake, Alg. 2's rule at cluster scope) into a
        host-held snapshot, freeing its slot and blocks for a
        ``window``-token admission. True if a victim was suspended."""
        rec = self.recovery
        best = None
        for d in self._up():
            if d.killed or not d.engine.serviceable(window):
                continue
            for rid, mass in d.engine.slot_importance_mass().items():
                if rid == exclude_rid:
                    continue
                rs = d.engine.requests[rid]
                left = rs.request.max_new_tokens - len(rs.outputs)
                if left < rec.cfg.min_preempt_remaining:
                    continue
                if best is None or mass < best[0]:
                    best = (mass, d, rid)
        if best is None:
            return False
        _, dev, rid = best
        rec.suspend(dev.engine, rid, self.ticks)
        return True

    def force_preempt(self, rid: int) -> bool:
        """SLO-admission hook: preempt on behalf of queued request
        ``rid`` now, bypassing the tick-based starvation fuse. Needs an
        attached ``RecoveryManager`` (the suspension machinery). True if
        a victim was suspended."""
        if self.recovery is None:
            return False
        shape = self._shape.get(rid)
        if shape is None:
            return False
        if self._preempt_victim(shape[0] + shape[1]):
            self._head_since = (rid, self.ticks)   # re-arm the fuse
            self._m_force_preempts.inc()
            return True
        return False

    def _maybe_preempt(self) -> None:
        """Preemption-by-demotion: when the shared queue's head has
        starved for ``preempt_after_ticks`` (pool exhaustion, capacity
        loss), suspend the fleet's lowest-importance running request."""
        rec = self.recovery
        if not self.queue:
            self._head_since = None
            return
        head = self.queue[0]
        if self._head_since is None or self._head_since[0] != head.id:
            self._head_since = (head.id, self.ticks)
            return
        if (self.ticks - self._head_since[1]
                < rec.cfg.preempt_after_ticks):
            return
        plen, glen = self._shape[head.id]
        if self._preempt_victim(plen + glen):
            self._head_since = (head.id, self.ticks)   # re-arm the fuse

    def _maybe_resume(self) -> None:
        """Resume cooled-down suspended snapshots wherever capacity has
        freed (checksummed transfer, retried on faults). A snapshot no
        healthy device can host again is rejected, so the stream ends
        instead of hanging the cluster."""
        rec = self.recovery
        for snap in rec.resumable(self.ticks):
            req = snap.request
            window = len(req.prompt) + req.max_new_tokens
            dst = self._rescue_target(snap, exclude="")
            if dst is not None:
                if not any(s is not None for s in dst.engine.slots):
                    dst.engine.clock = max(dst.engine.clock, self.now())
                if rec.transfer(snap, dst.engine,
                                lambda s, d=dst: self._charge(d, s)):
                    rec.drop_suspended(snap)
                    rec.stats["resumes"] += 1
                continue                 # transfer failed: retry later
            if any(d.engine.serviceable(window) for d in self._up()):
                continue                 # capacity will free; wait
            rec.drop_suspended(snap)
            if self._seen_tokens.get(req.id, 0):
                self._replaying.add(req.id)
            rec.stats["abandoned"] += 1
            self._reject(req)

    # ---------------------------------------------------------------- tick
    def tick(self) -> bool:
        """One router iteration. Returns False when the stream is fully
        served (no arrivals, no queue, no running or suspended work)."""
        if self.faults is not None:
            for ev in self.faults.due(self.ticks):
                self._apply_fault(ev)
        # idle fleet + future arrivals: jump the fleet to the next event
        if (self.arrivals and not self.queue and not self._steppable()
                and not self._failed_pending()
                and not (self.recovery and self.recovery.suspended)):
            t = self.arrivals[0].arrival
            for d in self._alive():
                d.engine.clock = max(d.engine.clock, t)
        self._release_arrivals()
        self._dispatch()
        if self.recovery is not None:
            self._maybe_resume()
            self._maybe_preempt()
        steppable = self._steppable()
        if steppable:
            # event-driven: advance the furthest-behind steppable device
            dev = min(steppable, key=lambda d: d.engine.clock)
            dev.engine.step()
            dev.steps += 1
            if self.recovery is not None:
                self.recovery.observe_step(self.devices.index(dev), dev,
                                           dev.engine.last_step_time)
            self._collect(dev)
        elif self._failed_pending() and self.recovery is not None:
            # nothing steppable but a silent device still holds work:
            # the watchdog waits, and detection costs modeled time
            alive = self._alive()
            pool = alive or self.devices
            t = (max(max(d.engine.clock for d in pool), self._wait_clock)
                 + self.recovery.cfg.heartbeat_timeout_s)
            self._wait_clock = t
            for d in alive:
                d.engine.clock = max(d.engine.clock, t)
        self.ticks += 1
        if self._mreg.enabled:
            self._m_ticks.inc()
            self._m_queue.set(len(self.queue))
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.counter("router", "shared_queue", self.now(),
                       depth=len(self.queue))
        if self.recovery is not None:
            self._watchdog()
        if (self.balancer is not None
                and self.ticks % self.balancer.cfg.rebalance_interval == 0):
            # migrated requests carry their outputs with them; pending
            # tokens surface at the destination's next _collect
            self.balancer.rebalance(
                [d for d in self._up() if not d.killed], self.ticks)
            self._observe_balancer()
        return bool(self.arrivals or self.queue or self._steppable()
                    or self._failed_pending()
                    or (self.recovery and self.recovery.suspended))

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
        speaks one backend dialect. ``preemptible`` attaches a default
        ``RecoveryManager`` (the suspension machinery SLO admission's
        force-preempt needs); with one honest device the watchdog is
        inert."""
        dc = DeviceClass(name="local", max_batch=engine.scfg.max_batch)
        dev = ClusterDevice(name=name or engine.name or "local0", cls=dc,
                            engine=engine)
        if engine.latency_model is not None:
            dev.prefill_tok_prior = float(
                engine.latency_model({"prefill_tokens": 1, "active": 0}))
            dev.base_latency = engine.latency_model
        recovery = (RecoveryManager(RecoveryConfig()) if preemptible
                    else None)
        return cls([dev], rcfg=rcfg, recovery=recovery)

    # ------------------------------------------------------------- metrics
    def summary(self) -> dict[str, Any]:
        makespan = max(d.engine.clock for d in self.devices)
        total_tokens = sum(len(rs.outputs) for rs in self.finished.values())
        per_device = {}
        for d in self.devices:
            per_device[d.name] = {
                "class": d.cls.name,
                "state": d.state,
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
        out = {
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
        if self.recovery is not None:
            lat = self.recovery.recovery_latencies
            out["fault_tolerance"] = dict(
                self.recovery.stats,
                suspended_now=len(self.recovery.suspended),
                recovery_latency_mean_s=(float(np.mean(lat)) if lat
                                         else 0.0),
                recovery_latency_max_s=(float(np.max(lat)) if lat
                                        else 0.0))
        return out

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


# ------------------------------------------------------------ construction
def build_cluster(cfg, params, device_classes: Iterable[DeviceClass], *,
                  scfg: ServingConfig, model_desc=None,
                  balancer: Optional[KVBalancer] = None,
                  bcfg: Optional[BalancerConfig] = None,
                  rcfg: RouterConfig = RouterConfig(),
                  faults: Optional[FaultInjector] = None,
                  recovery=None, wallclock: bool = False,
                  device=None) -> ClusterRouter:
    """Build a heterogeneous cluster serving one model (deprecated, as
    in the reference: build a ``ClusterSpec`` and call ``.build``; this
    forwards and warns).

    ``scfg`` is the per-engine template each device class specializes;
    ``faults`` attaches a chaos trace; ``recovery`` is a
    ``RecoveryManager`` or a ``RecoveryConfig`` (a bare injector implies
    a default manager: injected faults without a watchdog would hang the
    stream)."""
    warnings.warn(
        "build_cluster(...) is deprecated; use ClusterSpec.of(cfg, "
        "device_classes, serving=scfg, ...).build(params, ...) from "
        "repro_torch.cluster.spec", DeprecationWarning, stacklevel=2)
    from repro_torch.cluster.spec import ClusterSpec
    spec = ClusterSpec.of(
        cfg, device_classes, serving=scfg, model_desc=model_desc,
        balancer=bcfg, router=rcfg,
        recovery=recovery if isinstance(recovery, RecoveryConfig)
        else None, wallclock=wallclock)
    return spec.build(
        params, balancer=balancer, device=device, faults=faults,
        recovery=None if isinstance(recovery, RecoveryConfig)
        else recovery)
