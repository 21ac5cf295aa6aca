"""AdamW and LR schedules on parameter dicts (counterpart of
``repro.training.optim``).

AdamW keeps fp32 moments beside parameters of any dtype, clips by the
global gradient norm and computes each update in fp32 before casting to
the parameter's dtype. The step counter is a 0-d int32 tensor on the
parameters' device, so schedules and bias corrections run there without
a host sync. Updates are functional: new tensors, the inputs untouched,
as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import Tree, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Tree             # fp32
    nu: Tree             # fp32


def adamw_init(params: Tree) -> AdamWState:
    dev = leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def global_norm(tree: Tree) -> torch.Tensor:
    """fp32 L2 norm over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> tuple[Tree, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the norm is taken
    before clipping."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=torch.float32, device=step.device))
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*x) for x in zip(leaves(grads), leaves(state.mu),
                                 leaves(state.nu), leaves(params))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return (unflatten(params, new_p),
            AdamWState(step, unflatten(params, new_m),
                       unflatten(params, new_v)), gnorm)


# --------------------------------------------------------------- schedules
def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay: linear warmup -> constant plateau ->
    linear-in-log decay to floor*peak."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak * torch.exp(math.log(max(floor, 1e-8)) * t)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable,
                                       torch.full_like(s, peak), dec))
    return lr
