"""SLO-aware admission control (counterpart of
``repro.frontend.admission``).

The router's default policy serves every queued request eventually;
under sustained overload that drives every TTFT up without bound. This
controller enforces per-request deadlines with the two levers the router
exposes:

- load shedding (``ClusterRouter.shed``): a queued request whose TTFT
  deadline is provably unmeetable (time waited plus a lower bound on its
  cheapest prefill anywhere in the fleet exceeds the budget) is rejected
  now. The bound uses the fleet's best modeled per-token prefill time;
  in wall-clock mode there is no model, the bound is vacuous, and
  shedding disarms rather than guess.
- starvation preemption (``ClusterRouter.force_preempt``): when the
  queue head has used more than ``starvation_frac`` of its TTFT budget
  waiting, the fleet's lowest-importance running request is suspended
  now (preemption-by-demotion, bypassing the tick-based fuse). A tick
  cooldown stops thrashing.

``control(router)`` runs once per server pump iteration, before the
router tick.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request latency contract and the controller's tuning."""

    ttft_s: float = 0.5               # time-to-first-token budget
    tpot_s: float = 0.1               # per-output-token budget (scoring)
    starvation_frac: float = 0.5      # head preempts past this TTFT share
    preempt_cooldown_ticks: int = 50  # min ticks between forced preempts

    def __post_init__(self):
        if self.ttft_s <= 0 or self.tpot_s <= 0:
            raise ValueError("SLO budgets must be positive")
        if not 0 < self.starvation_frac < 1:
            raise ValueError("starvation_frac must be in (0, 1)")


class SLOAdmission:
    """Deadline-driven shed / preempt controller over a ``ClusterRouter``."""

    def __init__(self, slo: SLOSpec = SLOSpec()):
        self.slo = slo
        self.shed = 0
        self.forced_preemptions = 0
        self._last_force = None
        reg = obs_metrics.get_registry()
        self._m_shed = reg.counter(
            "pam_frontend_shed_total",
            "queued requests shed by SLO admission (deadline "
            "provably unmeetable)")
        self._m_force = reg.counter(
            "pam_frontend_force_preempt_total",
            "forced preemptions triggered by queue-head starvation")

    # ------------------------------------------------------------ signals
    def _prefill_floor(self, router) -> float:
        """The cheapest modeled seconds per prefill token on any healthy
        device: a lower bound on a queued request's remaining TTFT. 0.0
        (wall-clock mode, no priors) disarms shedding."""
        priors = [d.prefill_tok_prior for d in router._up()
                  if d.prefill_tok_prior > 0]
        return min(priors) if priors else 0.0

    def ttft_lower_bound(self, router, rid: int, now: float) -> float:
        """The least TTFT if the request were admitted on the fleet's
        fastest device now (waited so far + cheapest prefill): above the
        budget, shedding is sound."""
        req = router._requests[rid]
        plen, _ = router._shape[rid]
        return (now - req.arrival) + plen * self._prefill_floor(router)

    # ------------------------------------------------------------ control
    def control(self, router) -> None:
        if not router.queue:
            return
        now = router.now()
        if self._prefill_floor(router) > 0:
            for req in list(router.queue):
                if (self.ttft_lower_bound(router, req.id, now)
                        > self.slo.ttft_s):
                    if router.shed(req.id):
                        self.shed += 1
                        self._m_shed.inc()
        if not router.queue:
            return
        head = router.queue[0]
        waited = now - head.arrival
        if waited <= self.slo.starvation_frac * self.slo.ttft_s:
            return
        if (self._last_force is not None
                and router.ticks - self._last_force
                < self.slo.preempt_cooldown_ticks):
            return
        if router.force_preempt(head.id):
            self.forced_preemptions += 1
            self._m_force.inc()
            self._last_force = router.ticks

    def summary(self) -> dict:
        return {"shed": self.shed,
                "forced_preemptions": self.forced_preemptions,
                "ttft_slo_s": self.slo.ttft_s,
                "tpot_slo_s": self.slo.tpot_s}
