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
"""

from __future__ import annotations

import argparse
import json

import numpy as np

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
    args = ap.parse_args(argv)

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
    eng = ServingEngine(cfg, params, scfg, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(id=i,
                           prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                           max_new_tokens=args.gen_len))
    summary = eng.run()
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
