"""Serving CLI of the port: the PAM engine under a synthetic request
stream, printing the engine's JSON summary.

    PYTHONPATH=src python -m repro_torch.launch.serve --block-size 16 \
        --hot-window 256

runs full-width ``qwen3-0.6b`` (random weights from seed 0) on the GPU;
``--arch mamba2-780m`` serves the Mamba-2 model (dense cache only, as in
the reference); ``--reduced --device cpu`` runs the smoke-size model on
the CPU; ``--temperature``/``--top-k`` sample, ``--prefill-chunk``
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
the weights. ``--shard`` above 1 (ROADMAP Queue 1 item 9) and
``--chaos`` (item 8) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.cluster import BalancerConfig, ClusterSpec, KVBalancer
from repro_torch.models import transformer as tfm
from repro_torch.models.config import get_config, reduced
from repro_torch.serving import (PAMManagerConfig, Request, ServingConfig,
                                 ServingEngine)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
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
                    help="devices per replica group (not ported yet above "
                         "1: ROADMAP Queue 1 item 9)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="cluster mode: fault trace (not ported yet: "
                         "ROADMAP Queue 1 item 8)")
    args = ap.parse_args(argv)
    if args.shard > 1:
        raise NotImplementedError("--shard > 1 (one engine over several "
                                  "devices) is not ported yet: ROADMAP "
                                  "Queue 1 item 9")
    if args.chaos:
        raise NotImplementedError("--chaos (fault injection and recovery) "
                                  "is not ported yet: ROADMAP Queue 1 "
                                  "item 8")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = tfm.init_params(cfg, 0, device=args.device)
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
    if args.devices:
        return _cluster_mode(args, cfg, params, scfg)
    eng = ServingEngine(cfg, params, scfg, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(id=i,
                           prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                           max_new_tokens=args.gen_len))
    summary = eng.run()
    print(json.dumps(summary, indent=1))
    return summary


def _cluster_mode(args, cfg, params, scfg) -> dict:
    """The stream over a ``ClusterSpec`` fleet with the default balancer;
    returns the router's summary with SLO attainment at 100-200 ms."""
    spec = ClusterSpec.from_cli(args.devices, model=cfg, serving=scfg,
                                wallclock=args.system == "wallclock")
    router = spec.build(params, balancer=KVBalancer(BalancerConfig()),
                        device=args.device)
    rng = np.random.default_rng(0)
    t, reqs = 0.0, []
    for i in range(args.requests):
        t += float(rng.exponential(args.arrival_gap_ms / 1e3))
        reqs.append(Request(id=i,
                            prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                            max_new_tokens=args.gen_len, arrival=t))
    for _ in router.serve(reqs):
        pass
    summary = router.summary()
    summary["slo_attainment"] = {f"{ms}ms": router.slo_attainment(ms / 1e3)
                                 for ms in (100, 150, 200)}
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
