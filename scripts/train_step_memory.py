"""Where a train step's device memory goes on one GPU, and how the loss of
the family train phases moves with the peak lr.

    python3 scripts/train_step_memory.py
    python3 scripts/train_step_memory.py zamba2-7b 4 5

With no arguments:

1. qwen3-14b at 8 layers and deepseek-67b at 4 (``chip_smoke.py``'s
   ``TRAIN_FAMILIES``: full width, bf16, random weights from seed 0, B 1
   x 2048 SyntheticLM tokens): two steps of ``build_train_step`` with the
   state donated (as ``launch.train.run`` builds it) and two with the
   functional update, each step's allocated and peak GiB at the entry and
   exit of its gradient and of its AdamW update
   (``torch.cuda.memory_allocated`` / ``max_memory_allocated``, the peak
   reset at each entry). A step that runs out of memory reports the
   allocator's message.
2. 6 steps at the train CLI's peak lr 1e-2 (``chip_smoke.py``'s phases
   run ``FAMILY_LR``): hubert-xlarge at B 2 x 1500 frames with the
   ``flash_attention`` kernels and with the plain attention
   (``use_kernel=False``), and qwen3-14b and deepseek-67b as in 1: the
   losses.

With an arch and depths: part 1 alone for that arch at each depth (a
hybrid's depth is its group count, ``chip_smoke._cut``), the state
donated, at its ``TRAIN_FAMILIES`` batch and length.

One JSON line each, with the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2
LR_STEPS = 6
GIB = 2 ** 30


def _marks(torch, log: list):
    """Wrappers of ``build_grad_fn``'s function and ``adamw_update`` that
    append (stage, allocated GiB, peak GiB since the stage's entry)."""
    def mark(tag):
        torch.cuda.synchronize()
        log.append((tag, torch.cuda.memory_allocated() / GIB,
                    torch.cuda.max_memory_allocated() / GIB))

    def around(fn, name):
        def wrapped(*a, **k):
            mark(name + "_entry")
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **k)
            mark(name + "_exit")
            return out
        return wrapped
    return around


def step_memory(cs, arch: str, donate: bool, depth=None) -> dict:
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.training import optim, train_step as tts
    n_layers, B, S = cs.TRAIN_FAMILIES[arch]
    n_layers = n_layers if depth is None else depth
    cfg = cs._family_cfg(arch, n_layers)
    tcfg = train_cli.train_config(steps=STEPS, lr=cs.FAMILY_LR)
    log: list = []
    around = _marks(torch, log)
    real_update, real_grad = optim.adamw_update, tts.build_grad_fn
    optim.adamw_update = around(real_update, "update")
    tts.build_grad_fn = lambda *a: around(real_grad(*a), "grad")
    out = dict(card=cs._card(), arch=arch, depth=n_layers,
               n_layers=cfg.n_layers, batch=B,
               seq=S, donate=donate, params=cfg.param_count())
    try:
        state = tts.init_train_state(cfg, tcfg, 0, device="cuda")
        step = tts.build_train_step(cfg, tcfg, donate=donate)
        data = cs._FamilyData(cfg, B, S)
        for s in range(STEPS):
            state, m = step(state, data.batch(s))
            float(m["loss"])
        del state, step, data, m
    except torch.OutOfMemoryError as exc:
        out["error"] = str(exc).split(". If reserved")[0]
    finally:
        optim.adamw_update, tts.build_grad_fn = real_update, real_grad
    out["stages"] = [dict(at=t, allocated_gib=a, peak_gib=p)
                     for t, a, p in log]
    return out


def lr_losses(cs, arch: str, use_kernel: bool, batch: int | None) -> dict:
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.training import train_step as tts
    n_layers, B, S = cs.TRAIN_FAMILIES[arch]
    B = batch or B
    cfg = cs._family_cfg(arch, n_layers)
    tcfg = dataclasses.replace(train_cli.train_config(steps=LR_STEPS,
                                                      lr=1e-2),
                               use_kernel=use_kernel)
    state = tts.init_train_state(cfg, tcfg, 0, device="cuda")
    step = tts.build_train_step(cfg, tcfg, donate=True)
    data = cs._FamilyData(cfg, B, S)
    losses = []
    for s in range(LR_STEPS):
        state, m = step(state, data.batch(s))
        losses.append(float(m["loss"]))
    del state, step, data
    return dict(card=cs._card(), arch=arch, n_layers=cfg.n_layers, batch=B,
                seq=S, peak_lr=1e-2, use_kernel=use_kernel, losses=losses)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_step_memory: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) > 1:
        runs = [(step_memory, (sys.argv[1], True, int(d)))
                for d in sys.argv[2:]]
    else:
        runs = [(step_memory, (arch, donate)) for arch in ("qwen3-14b",
                                                           "deepseek-67b")
                for donate in (True, False)]
        runs += [(lr_losses, (cs.AUDIO_ARCH, kernel, 2))
                 for kernel in (True, False)]
        runs += [(lr_losses, (arch, True, None)) for arch in ("qwen3-14b",
                                                              "deepseek-67b")]
    for fn, args in runs:
        print(json.dumps(fn(cs, *args)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
