"""Serving CLI of the port: the PAM engine under a synthetic request
stream, printing the engine's JSON summary.

    PYTHONPATH=src python -m repro_torch.launch.serve --block-size 16 \
        --hot-window 256

runs full-width ``qwen3-0.6b`` (random weights from seed 0) on the GPU;
``--arch mamba2-780m`` serves the Mamba-2 model (dense cache only, as in
the reference), ``--arch qwen3-moe-235b-a22b`` the GQA mixture-of-experts
model (128 experts, top-8; its 94 layers need several cards at full
depth, and ``--layers`` cuts the depth); the wider dense models are
``--arch qwen3-14b`` (GQA group 5; its 40 layers fit one card),
``--arch minicpm-2b`` (MHA, head dim 64) and ``--arch deepseek-67b``
(group 8; 95 layers, about 135 GB in bf16, so one card takes it with
``--layers 20``); ``--arch deepseek-v2-lite-16b`` serves the MLA
mixture-of-experts model (latent KV cache, 64 experts top-6 + 2 shared;
27 layers, 32.4 GB in bf16, one card at full depth) on the dense layout
only, as the reference does: ``--block-size`` / ``--hot-window`` raise
its ``ValueError``; ``--arch zamba2-7b`` serves the hybrid model (68
Mamba-2 layers around one shared attention block at 13 sites, 11.47 GB
in bf16, one card at full depth; ``--layers`` does not apply) on the
dense layout likewise; ``--arch internvl2-1b`` serves the vision-language
model text-only (its patch prefix is not an engine input, as in the
reference; GQA group 7 at head dim 64, 0.99 GB in bf16) wherever the
dense family serves; ``--arch hubert-xlarge`` is an encoder with no
decode step, gets no PAM config and fails at the engine's construction,
as the reference's CLI does; ``--reduced --device cpu`` runs
the smoke-size model on the CPU; ``--temperature``/``--top-k`` sample, ``--prefill-chunk``
admits long prompts in slices. The flags mirror ``repro.launch.serve``'s batch mode; the defaults are sized
for the GPU (8 requests of 512 prompt tokens, 64 new tokens each,
``max_len`` 2048) rather than for the reference's CPU smoke runs. Times
are the host's wall clock, each step ending in a device readback.

Cluster mode (paper §4.3) routes the stream over modeled device classes
with online KV balancing, and prints the router's summary:

    PYTHONPATH=src python -m repro_torch.launch.serve --devices hbm:1,cxl:2 \
        --block-size 16 --hot-window 256

Requests then arrive with Poisson gaps (``--arrival-gap-ms``) on the
modeled clock; ``--system pam`` (default) runs each engine's clock on
its class's latency model, ``wallclock`` on the host's clock. Every
engine runs on the one device given (``--device``), sharing one copy of
the weights. ``--shard g`` shards each engine over ``g`` sites (the
dense family on ``--block-size`` with a ring and a pool that split over
``g``): one engine alone, or with ``--devices`` replica groups of ``g``
same-class devices (``--devices hbm:1,cxl:2 --shard 2``: a lone hbm
engine and one 2-way cxl group). The sites share the one device.

Chaos mode injects a deterministic fault trace (kills, stalls, transfer
drops and corruption, pool exhaustion) into a cluster run and serves
through it with the recovery watchdog attached:

    PYTHONPATH=src python -m repro_torch.launch.serve --devices hbm:1,cxl:2 \
        --block-size 16 --hot-window 256 --chaos 'kill:cxl1@40,corrupt@30'

Front-end mode streams a seeded arrival trace (``--trace``, ``--rate``,
``--trace-seed``) through the async server with SLO admission
(``--slo-ttft-ms``, ``--slo-tpot-ms``) and prints its TTFT / TPOT
scorecard; a single engine runs on the ``pam`` latency model unless
``--system wallclock``. ``--port N`` drives the trace through the NDJSON
socket endpoint on 127.0.0.1:N (0 picks a free port) instead of the
in-process API:

    PYTHONPATH=src python -m repro_torch.launch.serve --serve --requests 32 \
        --trace onoff --rate 40 --block-size 16 --hot-window 256 \
        --prefill-chunk 256

Telemetry, any mode: ``--trace-out trace.json`` writes the request
lifecycle and device event trace (Chrome trace JSON, loadable in
Perfetto) and ``--metrics-interval N`` prints a live metrics snapshot
line every N ticks or steps; both print the final snapshot at exit.
Without ``--device cpu`` every mode runs on the GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.cluster import (BalancerConfig, ClusterSpec, FaultInjector,
                                 KVBalancer, RecoveryConfig)
from repro_torch.models import transformer as tfm
from repro_torch.models.config import get_config, reduced
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.perfmodel import PAM_LLAMA_7B, make_latency_model, make_system
from repro_torch.serving import (EngineSpec, PAMManagerConfig, Request,
                                 ServingConfig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to this many layers "
                         "(full-width qwen3-moe-235b-a22b fits one 80 GB "
                         "card at a few of its 94)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--no-sparsity", action="store_true")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged warm/cold KV block tokens (0 = dense)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="physical pool blocks (default: no overcommit)")
    ap.add_argument("--hot-window", type=int, default=0,
                    help="hot-tier ring slots (0 = full window; requires "
                         "--block-size)")
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="on-device sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill slice budget in tokens (pow-2; "
                         "0 = monolithic prefill; requires --block-size)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--devices", default=None, metavar="SPEC",
                    help="cluster mode: modeled device classes, e.g. "
                         "'hbm:1,cxl:2' (repro_torch.perfmodel.devices)")
    ap.add_argument("--arrival-gap-ms", type=float, default=2.0,
                    help="cluster mode: mean Poisson arrival gap on the "
                         "modeled clock")
    ap.add_argument("--system", default="pam", choices=["pam", "wallclock"],
                    help="cluster mode: engine clocks on the device "
                         "classes' latency models, or the host's clock")
    ap.add_argument("--shard", type=int, default=1,
                    help="sites an engine is sharded over (tensor-parallel "
                         "weights, ring and pool split); with --devices, "
                         "devices per replica group")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="cluster mode: fault trace, e.g. "
                         "'kill:hbm0@120,stall:cxl0@50x8,corrupt@30*2' "
                         "(repro_torch.cluster.faults)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the injected corruption bytes")
    ap.add_argument("--serve", action="store_true",
                    help="front-end mode: stream a seeded arrival trace "
                         "through the async server (repro_torch.frontend)")
    ap.add_argument("--trace", default="poisson",
                    choices=["poisson", "gamma", "onoff"],
                    help="--serve: arrival trace shape")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="--serve: mean arrival rate (req/s)")
    ap.add_argument("--slo-ttft-ms", type=float, default=250.0,
                    help="--serve: time-to-first-token SLO")
    ap.add_argument("--slo-tpot-ms", type=float, default=50.0,
                    help="--serve: per-output-token SLO")
    ap.add_argument("--port", type=int, default=None,
                    help="--serve: drive the trace through the NDJSON "
                         "socket endpoint on this port (0 = ephemeral)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-lifecycle and device-event "
                         "trace here at exit, as Chrome trace JSON "
                         "(enables the metrics registry)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="print a live metrics snapshot line every N "
                         "ticks or steps (0 = only the final snapshot; "
                         "any value enables the metrics registry)")
    args = ap.parse_args(argv)
    if args.chaos and not args.devices:
        ap.error("--chaos needs --devices (faults target cluster devices)")
    if args.metrics_interval and args.micro_steps > 1 and not (
            args.devices or args.serve):
        ap.error("--metrics-interval steps the engine one decode at a "
                 "time; drop --micro-steps")

    # telemetry binds at construction: install before building engines
    telemetry = bool(args.trace_out) or args.metrics_interval > 0
    if telemetry:
        obs_metrics.install()
    if args.trace_out:
        obs_trace.install()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        if cfg.family == "hybrid":
            ap.error("--layers cuts a stacked layer axis; the hybrid "
                     "family's depth is its groups")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = tfm.init_params(cfg, 0, device=args.device)
    pam_cfg = None
    if cfg.has_decode:       # an encoder (audio) gets no PAM config
        pam_cfg = PAMManagerConfig(
            max_tokens=args.max_len,
            hot_capacity=max(args.max_len // 8, 8),
            warm_capacity=max(args.max_len // 4, 16),
            compression=4, recency_window=8, schedule_interval=2,
            use_sparsity=not args.no_sparsity)
    if args.prefill_chunk and not args.block_size:
        ap.error("--prefill-chunk requires --block-size (paged KV)")
    scfg = ServingConfig(max_batch=args.max_batch, max_len=args.max_len,
                         pam=pam_cfg, block_size=args.block_size,
                         pool_blocks=args.pool_blocks,
                         hot_window=args.hot_window,
                         micro_steps=args.micro_steps,
                         temperature=args.temperature, top_k=args.top_k,
                         prefill_chunk=args.prefill_chunk)
    try:
        if args.serve:
            return _serve_mode(args, cfg, params, scfg)
        if args.devices:
            return _cluster_mode(args, cfg, params, scfg)
        return _engine_mode(args, cfg, params, scfg)
    finally:
        if telemetry:
            _finish_telemetry(args)


def _metrics_emit(tick: int) -> None:
    """One live metrics line (scalar series; histograms land in the
    final snapshot)."""
    snap = obs_metrics.get_registry().snapshot()
    print(json.dumps({"op": "metrics", "tick": tick,
                      "counters": snap["counters"],
                      "gauges": snap["gauges"]}))


def _finish_telemetry(args) -> None:
    """At exit: the final registry snapshot and, with ``--trace-out``,
    the balanced Chrome trace JSON."""
    reg = obs_metrics.get_registry()
    if reg.enabled:
        print(json.dumps({"op": "metrics", "final": True,
                          "metrics": reg.snapshot()}))
    tr = obs_trace.COLLECTOR
    if tr is not None and args.trace_out:
        tr.close_open()          # balanced even with work in flight
        tr.write(args.trace_out)
        print(f"trace: {len(tr.events)} events "
              f"({tr.dropped} dropped) -> {args.trace_out}")


def _engine_mode(args, cfg, params, scfg) -> dict:
    """One engine on the host's clock; returns the engine's summary."""
    eng = EngineSpec(model=cfg, serving=scfg, shard=args.shard).build(
        params, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(id=i,
                           prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                           max_new_tokens=args.gen_len))
    if args.metrics_interval > 0:
        n = 0
        while eng.waiting or any(s is not None for s in eng.slots):
            eng.step()
            n += 1
            if n % args.metrics_interval == 0:
                _metrics_emit(n)
    summary = eng.run()
    print(json.dumps(summary, indent=1))
    return summary


def _cluster(args, cfg, params, scfg, recovery_default: bool = False):
    """A ``ClusterSpec`` fleet with the default balancer; the recovery
    watchdog with ``--chaos`` (or ``recovery_default``)."""
    faults = rec_cfg = None
    if args.chaos:
        faults = FaultInjector.from_spec(args.chaos, seed=args.chaos_seed)
    if args.chaos or recovery_default:
        rec_cfg = RecoveryConfig()
    spec = ClusterSpec.from_cli(args.devices, model=cfg, serving=scfg,
                                shard=args.shard, recovery=rec_cfg,
                                wallclock=args.system == "wallclock")
    return spec.build(params, balancer=KVBalancer(BalancerConfig()),
                      device=args.device, faults=faults)


def _cluster_mode(args, cfg, params, scfg) -> dict:
    """The stream over the fleet; returns the router's summary with SLO
    attainment at 100-200 ms."""
    router = _cluster(args, cfg, params, scfg)
    rng = np.random.default_rng(0)
    t, reqs = 0.0, []
    for i in range(args.requests):
        t += float(rng.exponential(args.arrival_gap_ms / 1e3))
        reqs.append(Request(id=i,
                            prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                            max_new_tokens=args.gen_len, arrival=t))
    if args.metrics_interval > 0:
        for req in reqs:
            router.submit(req)
        limit, n = router.rcfg.max_ticks, 0
        while router.tick():
            n += 1
            if n >= limit:
                raise RuntimeError(f"no drain in {limit} ticks")
            if n % args.metrics_interval == 0:
                _metrics_emit(n)
    else:
        for _ in router.serve(reqs):
            pass
    summary = router.summary()
    summary["slo_attainment"] = {f"{ms}ms": router.slo_attainment(ms / 1e3)
                                 for ms in (100, 150, 200)}
    print(json.dumps(summary, indent=1))
    return summary


async def _pump_with_metrics(srv, trace, interval: int) -> None:
    """``serve_trace`` with a live metrics line every ``interval`` pump
    iterations."""
    import asyncio
    for req in trace:
        srv.submit(req.prompt, req.max_new_tokens, rid=req.id,
                   arrival=req.arrival)
    limit, n = srv.router.rcfg.max_ticks, 0
    while srv.step():
        n += 1
        if n >= limit:
            raise RuntimeError(f"server did not drain in {limit} ticks")
        if n % interval == 0:
            _metrics_emit(n)
        if n % srv.ticks_per_yield == 0:
            await asyncio.sleep(0)


async def _drive_socket(srv, trace, port: int) -> int:
    """Replay the trace over the NDJSON endpoint: one loopback client a
    request, every token line read; returns the bound port."""
    import asyncio
    server, bound, pump = await srv.serve_endpoint(port=port)

    async def one(req):
        reader, writer = await asyncio.open_connection("127.0.0.1", bound)
        writer.write((json.dumps(
            {"id": req.id, "prompt": req.prompt.tolist(),
             "max_new_tokens": req.max_new_tokens}) + "\n").encode())
        await writer.drain()
        while True:
            line = await reader.readline()
            if not line or json.loads(line)["done"]:
                break
        writer.close()

    try:
        await asyncio.gather(*(one(r) for r in trace))
    finally:
        pump.cancel()
        server.close()
        await server.wait_closed()
    return bound


def _serve_mode(args, cfg, params, scfg) -> dict:
    """A seeded trace through ``AsyncServer`` with ``SLOAdmission``;
    returns the scorecard payload (modeled seconds unless
    ``--system wallclock``)."""
    import asyncio

    from repro_torch.frontend.admission import SLOAdmission, SLOSpec
    from repro_torch.frontend.loadgen import TraceConfig, make_trace, score
    from repro_torch.frontend.server import AsyncServer

    if args.devices:
        backend = _cluster(args, cfg, params, scfg, recovery_default=True)
    else:
        latency = (None if args.system == "wallclock" else
                   make_latency_model(make_system(args.system),
                                      PAM_LLAMA_7B))
        backend = EngineSpec(model=cfg, serving=scfg,
                             shard=args.shard).build(
            params, latency_model=latency, device=args.device)
    slo = SLOSpec(ttft_s=args.slo_ttft_ms / 1e3,
                  tpot_s=args.slo_tpot_ms / 1e3)
    trace = make_trace(TraceConfig(
        kind=args.trace, n_requests=args.requests, rate_rps=args.rate,
        prompt_len=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new=(max(args.gen_len // 2, 1), args.gen_len),
        vocab=cfg.vocab, seed=args.trace_seed))
    srv = AsyncServer(backend, admission=SLOAdmission(slo))
    port = None
    if args.port is None:
        if args.metrics_interval > 0:
            asyncio.run(_pump_with_metrics(srv, trace,
                                           args.metrics_interval))
        else:
            asyncio.run(srv.serve_trace(trace))
    else:
        port = asyncio.run(_drive_socket(srv, trace, args.port))
    sc = score(srv.records.values(), ttft_slo_s=slo.ttft_s,
               tpot_slo_s=slo.tpot_s)
    back = srv.router.summary()
    payload = {
        "mode": "serve",
        "trace": args.trace,
        "rate_rps": args.rate,
        "prefill_chunk": args.prefill_chunk,
        "port": port,
        "score": sc,
        "admission": srv.admission.summary(),
        "backend": {k: back[k] for k in
                    ("finished", "rejected", "total_tokens",
                     "makespan_s", "throughput_tok_s", "ticks")},
    }
    print(json.dumps(payload, indent=1))
    return payload


if __name__ == "__main__":
    main()
