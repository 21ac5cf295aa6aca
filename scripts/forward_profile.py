"""Where a full-width forward's time goes on one GPU: internvl2-1b's
patch-prefixed forward and hubert-xlarge's encoder.

    python3 scripts/forward_profile.py

For each model, built as ``chip_smoke.py`` builds it (full width and
depth, bf16, random weights from seed 0), at ``chip_smoke.py``'s shape
(``vlm_forward``: B 4, 256 patches + 1792 tokens; ``encoder_hubert_xlarge``:
B 8 x 1500 frames): one warm-up ``forward(use_kernel=True)`` under
``no_grad``, 3 timed by CUDA events (their median), then
``torch.profiler`` over 3 more: the wall ms a profiled forward (host
clock ending in a synchronise), the device's busy ms a forward (the
summed device time of its kernels, copies and memsets) and idle share,
kernel launches a forward, device ms by class (the port's attention
kernel, ``chip_smoke.KERNEL_CLASSES``, the rest) and the 8 heaviest
device events. One JSON line a model with the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORWARDS = 3


def _batch(cs, cfg):
    import torch
    from repro_torch.models import transformer as tf
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = tf.torch_dtype(cfg)
    if cfg.family == "audio":
        B, S = cs.ENCODER["B"], cs.ENCODER["frames"]
        return dict(frames=torch.randn((B, S, cfg.frontend_dim), generator=g,
                                       device="cuda").to(dt))
    B, T = cs.VLM_FORWARD["B"], cs.VLM_FORWARD["text"]
    return dict(tokens=torch.randint(0, cfg.vocab, (B, T), generator=g,
                                     device="cuda"),
                patches=torch.randn((B, cfg.num_patches, cfg.frontend_dim),
                                    generator=g, device="cuda").to(dt))


def profile_forward(cs, arch: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf
    cfg, params = cs._model("bfloat16", arch)
    batch = _batch(cs, cfg)

    def fwd():
        tf.forward(cfg, params, batch, use_kernel=True)

    with torch.no_grad():
        fwd()
        ms = statistics.median(cs._event_ms(fwd, FORWARDS))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(FORWARDS):
                fwd()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / FORWARDS
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA")), reverse=True)
    busy = sum(r[0] for r in rows) / FORWARDS / 1e3
    classes = {"attention": ("pam::",), **cs.KERNEL_CLASSES}
    by_class, seen = {}, set()
    for cls, keys in classes.items():
        sel = [r for r in rows if r[1] not in seen
               and any(k in r[1] for k in keys)]
        seen.update(r[1] for r in sel)
        by_class[cls] = sum(r[0] for r in sel) / FORWARDS / 1e3
    by_class["other"] = busy - sum(by_class.values())
    del params
    return dict(card=cs._card(), arch=arch, n_layers=cfg.n_layers,
                forward_ms_median=ms, profiled_wall_ms=wall * 1e3,
                device_busy_ms=busy,
                device_idle_share=(1 - busy / (wall * 1e3)
                                   if rows else "not measured"),
                launches_per_forward=sum(r[2] for r in rows) / FORWARDS,
                device_ms_by_class=by_class,
                top=[dict(name=k[:90], device_ms=us / FORWARDS / 1e3,
                          count=n / FORWARDS) for us, k, n in rows[:8]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("forward_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in (cs.VLM_ARCH, cs.AUDIO_ARCH):
        print(json.dumps(profile_forward(cs, arch)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
