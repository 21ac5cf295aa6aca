"""Trace-driven load generation and serving-latency scoring
(counterpart of ``repro.frontend.loadgen``).

Online serving is judged on TTFT / TPOT tails and SLO attainment under
stochastic arrivals, not on throughput alone. This module generates
seeded arrival traces of three shapes:

- ``poisson``: memoryless arrivals at ``rate_rps``;
- ``gamma``: a Gamma renewal process of the same mean rate whose
  inter-arrival CV^2 is ``burstiness`` (> 1: clumps and lulls);
- ``onoff``: ON windows arriving at ``rate_rps / duty_cycle``, then
  silent OFF windows, the same average rate (bursts that stress
  admission);

and scores the resulting streams: TTFT / TPOT / pooled inter-token
percentiles and SLO attainment, plus a check for lost and duplicated
streamed tokens. Host-side numpy on an explicit ``seed``, with the
reference's draws in the reference's order, so a config gives the
reference's trace: the same arrivals and the same prompts.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.obs.metrics import LATENCY_BUCKETS, Histogram
from repro_torch.serving.engine import Request

TRACE_KINDS = ("poisson", "gamma", "onoff")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """One seeded arrival trace. Lengths are inclusive integer ranges
    drawn uniformly per request."""

    kind: str = "poisson"
    n_requests: int = 64
    rate_rps: float = 50.0             # mean arrival rate (req/s)
    prompt_len: tuple[int, int] = (8, 48)
    max_new: tuple[int, int] = (4, 24)
    vocab: int = 32_000
    seed: int = 0
    first_id: int = 0
    # gamma: inter-arrival CV^2 (1.0 is poisson);
    # onoff: the ON-window arrival rate is rate_rps / duty_cycle
    burstiness: float = 4.0
    duty_cycle: float = 0.25           # onoff: fraction of a period ON
    period_s: float = 1.0              # onoff: ON + OFF cycle length


def _arrival_times(tcfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    n, rate = tcfg.n_requests, tcfg.rate_rps
    if rate <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate}")
    if tcfg.kind == "poisson":
        gaps = rng.exponential(1.0 / rate, n)
        return np.cumsum(gaps)
    if tcfg.kind == "gamma":
        if tcfg.burstiness <= 0:
            raise ValueError("burstiness must be positive")
        shape = 1.0 / tcfg.burstiness
        scale = tcfg.burstiness / rate     # mean = shape * scale = 1/rate
        gaps = rng.gamma(shape, scale, n)
        return np.cumsum(gaps)
    if tcfg.kind == "onoff":
        if not 0 < tcfg.duty_cycle <= 1:
            raise ValueError("duty_cycle must be in (0, 1]")
        on_s = tcfg.duty_cycle * tcfg.period_s
        out, t = [], 0.0
        while len(out) < n:
            t += float(rng.exponential(tcfg.duty_cycle / rate))
            # past this period's ON window: jump to the next period
            while t - (t // tcfg.period_s) * tcfg.period_s >= on_s:
                t = (t // tcfg.period_s + 1.0) * tcfg.period_s
            out.append(t)
        return np.asarray(out)
    raise ValueError(f"unknown trace kind {tcfg.kind!r}; "
                     f"expected one of {TRACE_KINDS}")


def make_trace(tcfg: TraceConfig) -> list[Request]:
    """The trace as time-ordered ``Request``s with seeded random
    prompts, ready for ``ClusterRouter.submit`` / ``AsyncServer.submit``."""
    rng = np.random.default_rng(tcfg.seed)
    arrivals = _arrival_times(tcfg, rng)
    plo, phi = tcfg.prompt_len
    glo, ghi = tcfg.max_new
    if not (1 <= plo <= phi and 1 <= glo <= ghi):
        raise ValueError("prompt_len / max_new ranges must be 1 <= lo <= hi")
    reqs = []
    for i in range(tcfg.n_requests):
        plen = int(rng.integers(plo, phi + 1))
        gen = int(rng.integers(glo, ghi + 1))
        prompt = rng.integers(0, tcfg.vocab, plen).astype(np.int32)
        reqs.append(Request(id=tcfg.first_id + i, prompt=prompt,
                            max_new_tokens=gen,
                            arrival=float(arrivals[i])))
    return reqs


# ----------------------------------------------------------------- scoring
def _pcts(xs: list[float]) -> dict[str, float]:
    """Percentiles through the registry's log-bucket histogram, so an
    offline score and the exported ``pam_frontend_ttft_seconds`` agree
    bucket for bucket. An empty sample gives zeros with ``n=0``: zeros
    then mean "no samples", never "zero latency"."""
    h = Histogram.standalone("score", LATENCY_BUCKETS)
    for x in xs:
        h.observe(float(x))
    s = h.summary()
    return {"p50": s["p50"], "p95": s["p95"], "p99": s["p99"],
            "n": s["n"]}


def stream_integrity(records: Iterable) -> tuple[int, int]:
    """(lost, duplicated) streamed-token counts over finished streams:
    every non-rejected done stream must have emitted exactly the indices
    0..n-1, each once."""
    lost = dup = 0
    for rec in records:
        if rec.rejected:
            continue
        idx = list(rec.indices)
        dup += len(idx) - len(set(idx))
        if rec.done and idx:
            lost += len(set(range(max(idx) + 1)) - set(idx))
    return lost, dup


def score(records: Iterable, *, ttft_slo_s: float,
          tpot_slo_s: float) -> dict:
    """Serving-latency scorecard over the ``AsyncServer``'s per-request
    ``StreamRecord``s.

    TTFT is the first token's time minus arrival; TPOT the mean decode
    gap of a stream (a one-token stream scores 0); ``itl_s`` pools every
    gap of every stream, so one long stall shows in its tail. A request
    attains its SLO iff it finished (not rejected, not truncated) with
    TTFT <= ``ttft_slo_s`` and TPOT <= ``tpot_slo_s``: rejections and
    unfinished streams count against attainment."""
    records = list(records)
    ttfts, tpots, attained = [], [], 0
    all_gaps: list[float] = []
    finished = rejected = tokens = 0
    for rec in records:
        if rec.rejected:
            rejected += 1
            continue
        if not rec.done or not rec.times:
            continue
        finished += 1
        tokens += len(rec.tokens)
        ttft = rec.times[0] - rec.arrival
        # migration seams can resync clocks; clamp as the router does
        gaps = np.maximum(np.diff(rec.times), 0.0)
        all_gaps.extend(gaps.tolist())
        tpot = float(np.mean(gaps)) if len(rec.times) > 1 else 0.0
        ttfts.append(float(ttft))
        tpots.append(tpot)
        if ttft <= ttft_slo_s and tpot <= tpot_slo_s:
            attained += 1
    lost, dup = stream_integrity(records)
    return {
        "n": len(records),
        "finished": finished,
        "rejected": rejected,
        "tokens": tokens,
        "ttft_s": _pcts(ttfts),
        "tpot_s": _pcts(tpots),
        "itl_s": _pcts(all_gaps),
        "slo_attainment": attained / len(records) if records else 1.0,
        "lost_tokens": lost,
        "dup_tokens": dup,
    }
