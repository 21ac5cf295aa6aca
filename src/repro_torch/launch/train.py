"""Training CLI of the port: SyntheticLM batches through the train step
with AdamW, periodic checkpoints and auto-resume, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --steps 40 --batch 8 --seq 64 --device cpu

trains the smoke-size model on the CPU (the kernels' plain versions);
without ``--device cpu`` it runs on the GPU, where attention runs the
``flash_attention`` forward and backward kernels, or, with ``--arch
mamba2-780m``, the SSD scan the ``ssd_scan`` kernels; ``--arch
zamba2-7b`` (the hybrid) runs both: ``ssd_scan`` at (d_state, head dim)
(64, 64) in its Mamba-2 layers and ``flash_attention`` at (head dim,
group) (112, 1) in its shared block, bf16 on the wgmma kernels. At full
depth (5.7 B parameters) a donated step needs about 115 GiB of state:
one H100 trains it only cut, as ``chip_smoke.py``'s ``train_zamba2_7b``
does (there is no depth flag, as in the reference). The mixture-of-experts
families route their FFN through ``models/moe.py`` (``torch.bmm`` expert
products, as the reference leaves its ``einsum``s to XLA) and add the
layers' Switch aux loss to the loss: ``--arch qwen3-moe-235b-a22b`` runs
``flash_attention`` at (128, 16), 64 query heads over 4 KV heads, and
``--arch deepseek-v2-lite-16b`` runs MLA through the plain chunked
attention of ``mla.mla_train`` (the reference has no MLA kernel), so no
counted kernel. Neither fits one H100 at full depth: a donated step holds
12 bytes a parameter, 2.8 TB for qwen3-moe-235b-a22b's 235 B and 195 GB
for deepseek-v2-lite-16b's 16.2 B, so the card trains them cut, as
``chip_smoke.py``'s ``train_qwen3_moe_235b_a22b`` and
``train_deepseek_v2_lite_16b`` do. Counterpart of
``repro.launch.train`` with the same flags, and ``--shard g`` in place of
the reference's device count: the dense family trains on the reference's
``(1, g)`` grid over ``("data", "model")``, every site on the one device
(``launch.mesh.SiteGrid``), the weights split by ``param_specs`` and the
moments by ``opt_state_specs`` (``training.train_step``; ``run`` also
takes any grid and ``fsdp``); a resumed run restores its checkpoint onto
the grid. ``--shard 1`` is the one-site run. The perf flags come from
``REPRO_PERF`` (``models.perf_flags.from_env``), and a
``StragglerMonitor`` records every step's time. Prints one line per 10
steps and a JSON summary; step times are the host's wall clock, each
step ending in a device readback of its loss.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.elastic import StragglerMonitor
from repro_torch.launch.mesh import make_grid
from repro_torch.models import perf_flags
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


def state_shardings(cfg: ModelConfig, grid, *, fsdp: bool = False
                    ) -> dict:
    """Each train-state leaf's layout on ``grid`` by dotted path: the
    params by ``param_specs``, the moments by ``opt_state_specs``, the
    rest replicated."""
    out = {}
    for kind, specs in (("params", shd.param_specs(cfg, grid, fsdp=fsdp)),
                        ("opt.mu", shd.opt_state_specs(cfg, grid,
                                                       fsdp=fsdp)),
                        ("opt.nu", shd.opt_state_specs(cfg, grid,
                                                       fsdp=fsdp))):
        out.update({f"{kind}.{p}": shd.GridSharding(grid, s)
                    for p, s in specs.items()})
    return out


def run(cfg: ModelConfig, tcfg: TrainConfig, *, steps: int, batch: int,
        seq: int, device: str | torch.device | None = None, seed: int = 0,
        ckpt_dir: str = "", ckpt_every: int = 50, grid=None,
        fsdp: bool = False, log=print) -> dict:
    """Train ``steps`` steps (resuming from the newest checkpoint in
    ``ckpt_dir``, if any), on ``grid`` (a ``SiteGrid`` on ``device``;
    None: one site) with FSDP weights if ``fsdp``. Returns the per-step
    losses, grad norms and wall seconds of the steps run, the first step
    run and tokens/s."""
    dev = resolve_device(device)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch)
    state = init_train_state(cfg, tcfg, seed, device=dev)
    # the state is donated to the step, as the reference's CLI jits it
    # with donate_argnums=(0,): one copy of it on the device
    step_fn = build_train_step(cfg, tcfg, donate=True, grid=grid, fsdp=fsdp)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        shardings = (None if grid is None
                     else state_shardings(cfg, grid, fsdp=fsdp))
        latest, restored = mgr.restore_latest(state, shardings)
        if latest is not None:
            log(f"[resume] from step {latest}")
            state, start = restored, latest
    mon = StragglerMonitor()
    losses, gnorms, secs = [], [], []
    t_all = time.perf_counter()
    for s in range(start, steps):
        b = device_batch(ds, s, tcfg.microbatches, dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        mon.record(0, secs[-1])
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
    ap.add_argument("--shard", type=int, default=1,
                    help="model sites of the (1, shard) (data, model) "
                         "grid, all on the one device (dense family)")
    args = ap.parse_args(argv)
    perf_flags.from_env()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = train_config(steps=args.steps, lr=args.lr,
                        microbatches=args.microbatches, wsd=args.wsd,
                        compress_grads=args.compress_grads)
    grid = (make_grid((1, args.shard), device=args.device)
            if args.shard > 1 else None)
    out = run(cfg, tcfg, steps=args.steps, batch=args.batch, seq=args.seq,
              device=args.device, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, grid=grid)
    print(json.dumps(dict(out, final_loss=(out["losses"] or [None])[-1],
                          device=str(resolve_device(args.device)),
                          shard=args.shard, perf_flags=perf_flags.active())))
    return out


if __name__ == "__main__":
    main()
