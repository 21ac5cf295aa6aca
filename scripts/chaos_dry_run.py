"""CPU dry run of ``chip_smoke.py``'s ``engine_chaos`` and
``serve_frontend`` schedules on the reduced qwen3-0.6b (fp32, random
weights from seed 0), printing the recovery and admission counts the card
runs are held to (``CHAOS_DRY_RUN``, ``SERVE_DRY_RUN``) and the modeled
figures behind them.

    PYTHONPATH=src python scripts/chaos_dry_run.py

The streams keep the full model's draws (prompt lengths, arrivals), their
tokens folded into the reduced vocabulary.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.config import get_config, reduced  # noqa: E402


def main() -> None:
    import torch
    torch.set_num_threads(4)
    cfg = reduced(get_config("qwen3-0.6b"))
    params = tf.init_params(cfg, 0, device="cpu")
    run = cs.chaos_fleet_run(cfg, params, device="cpu")
    s = run["router"].summary()
    ft = s["fault_tolerance"]
    print(json.dumps({
        "engine_chaos": {k: ft[k] for k in cs.CHAOS_COUNTS},
        "replayed": {str(k): v for k, v in run["replayed"].items()},
        "recovery_latency_s": [ft["recovery_latency_mean_s"],
                               ft["recovery_latency_max_s"]],
        "states": {n: d["state"] for n, d in s["devices"].items()},
        "steps": {n: d["steps"] for n, d in s["devices"].items()},
        "balancer_migrations": s["balancer_migrations"],
        "modeled_makespan_s": s["makespan_s"], "ticks": s["ticks"]}))
    srv = cs.serve_frontend_run(cfg, params, device="cpu")
    from repro_torch.frontend.loadgen import score
    sc = score(srv["records"].values(), ttft_slo_s=cs.SERVE_SLO["ttft_s"],
               tpot_slo_s=cs.SERVE_SLO["tpot_s"])
    print(json.dumps({"serve_frontend": cs._serve_counts(srv),
                      "score": sc}))


if __name__ == "__main__":
    main()
