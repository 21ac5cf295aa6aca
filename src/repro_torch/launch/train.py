"""Training CLI of the port: SyntheticLM batches through the train step
with AdamW, periodic checkpoints and auto-resume, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --steps 40 --batch 8 --seq 64 --device cpu

trains the smoke-size model on the CPU (the kernels' plain versions);
without ``--device cpu`` it runs on the GPU, where attention runs the
``flash_attention`` forward and backward kernels, or, with ``--arch
mamba2-780m``, the SSD scan the ``ssd_scan`` kernels. Counterpart of
``repro.launch.train`` with the same flags; multi-device sharding and the
straggler monitor are not ported (ROADMAP Queue 1 item 10). Prints one
line per 10 steps and a JSON summary; step times are the host's wall
clock, each step ending in a device readback of its loss.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, get_config, reduced
from repro_torch.training import optim
from repro_torch.training.train_step import (TrainConfig, build_train_step,
                                             init_train_state)


def train_config(*, steps: int, lr: float = 1e-2, microbatches: int = 1,
                 wsd: bool = False, compress_grads: bool = False
                 ) -> TrainConfig:
    """The CLI's train config: the reference's schedules, and attention
    through the kernels (``use_kernel=True``)."""
    sched = (optim.wsd_schedule(lr, warmup=10, stable=steps // 2,
                                decay=steps // 3) if wsd
             else optim.cosine_schedule(lr, warmup=10, total=steps))
    return TrainConfig(adamw=optim.AdamWConfig(lr=sched),
                       microbatches=microbatches, use_kernel=True,
                       compress_grads=compress_grads)


def device_batch(ds: SyntheticLM, step: int, microbatches: int,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """Batch ``step`` on ``device``, split (M, B/M, ...) for M > 1."""
    out = {}
    for k, v in ds.batch_at(step).items():
        t = torch.from_numpy(v).to(device)
        if microbatches > 1:
            t = t.reshape((microbatches, t.shape[0] // microbatches)
                          + tuple(t.shape[1:]))
        out[k] = t
    return out


def run(cfg: ModelConfig, tcfg: TrainConfig, *, steps: int, batch: int,
        seq: int, device: str | torch.device | None = None, seed: int = 0,
        ckpt_dir: str = "", ckpt_every: int = 50, log=print) -> dict:
    """Train ``steps`` steps (resuming from the newest checkpoint in
    ``ckpt_dir``, if any). Returns the per-step losses, grad norms and
    wall seconds of the steps run, the first step run and tokens/s."""
    dev = resolve_device(device)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch)
    state = init_train_state(cfg, tcfg, seed, device=dev)
    step_fn = build_train_step(cfg, tcfg)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        latest, restored = mgr.restore_latest(state)
        if latest is not None:
            log(f"[resume] from step {latest}")
            state, start = restored, latest
    losses, gnorms, secs = [], [], []
    t_all = time.perf_counter()
    for s in range(start, steps):
        b = device_batch(ds, s, tcfg.microbatches, dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        if s % 10 == 0 or s == steps - 1:
            log(f"step {s:5d} loss {losses[-1]:.4f} gnorm {gnorms[-1]:.3f} "
                f"{secs[-1] * 1e3:.0f}ms")
        if mgr is not None and (s + 1) % ckpt_every == 0:
            mgr.save(s + 1, state)
            log(f"[ckpt] step {s + 1}")
    wall = time.perf_counter() - t_all
    return dict(start_step=start, losses=losses, grad_norms=gnorms,
                step_s=secs, tokens_per_s=(steps - start) * batch * seq
                / max(wall, 1e-9))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--wsd", action="store_true",
                    help="MiniCPM WSD schedule instead of cosine")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = train_config(steps=args.steps, lr=args.lr,
                        microbatches=args.microbatches, wsd=args.wsd,
                        compress_grads=args.compress_grads)
    out = run(cfg, tcfg, steps=args.steps, batch=args.batch, seq=args.seq,
              device=args.device, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every)
    print(json.dumps(dict(out, final_loss=(out["losses"] or [None])[-1],
                          device=str(resolve_device(args.device)))))
    return out


if __name__ == "__main__":
    main()
