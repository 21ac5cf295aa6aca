"""Engine-step latency models: map real ServingEngine step stats onto the
paper's hardware timing model (the simulator glue). Counterpart of
``repro.perfmodel.latency``."""

from __future__ import annotations

import numpy as np


def make_latency_model(system, model_desc, context_scale: int = 1):
    """engine step stats -> simulated seconds.

    ``context_scale``: each engine token stands for this many hardware
    tokens (lets a CPU-sized engine run exercise the paper-scale memory
    hierarchy: tier reads, contexts and prefill tokens are scaled)."""
    def latency(stats) -> float:
        b = max(int(stats["active"]), 0)
        t = 0.0
        if stats["prefill_tokens"]:
            # prefill on NPU: compute-bound
            t += (2.0 * model_desc.params * stats["prefill_tokens"]
                  * context_scale / system.hw.npu_flops)
        if b == 0:
            return t
        tok_bytes = model_desc.kv_bytes_per_token()
        reads = stats.get("tier_reads")
        if reads is not None and np.sum(reads) > 0:
            # REAL per-tier token reads from the PAM manager
            hw = system.hw
            tiers = (hw.hbm, hw.ddr, hw.ssd)
            t_attn = max(float(r) * context_scale * tok_bytes
                         / tier.effective_bw
                         for r, tier in zip(reads, tiers))
            t_attn *= (1 + system.reduction_overhead)
            t += t_attn
            t += (stats.get("moved_tokens", 0) * context_scale * tok_bytes
                  / hw.hbm.link_bw)
        else:
            ctx = (int(np.mean(stats["batch_lengths"])) or 1) * context_scale
            t += system.attention_time(model_desc, b, ctx)
        t += system.fc_time(model_desc, b)
        return t
    return latency
