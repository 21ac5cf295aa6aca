"""AdamW and LR schedules on parameter dicts (counterpart of
``repro.training.optim``).

AdamW keeps fp32 moments beside parameters of any dtype, clips by the
global gradient norm and computes each update in fp32 before casting to
the parameter's dtype. The step counter is a 0-d int32 tensor on the
parameters' device, so schedules and bias corrections run there without
a host sync. Updates are functional (new tensors, the inputs untouched,
as in the reference) unless the caller donates the state, as the
reference's train CLI does (``donate_argnums``): then the moments and
parameters are written in place, op for op the same values.
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


def global_norm(tree: Tree, blocks=None) -> torch.Tensor:
    """fp32 L2 norm over every leaf; with ``blocks`` (each leaf's
    ``tensor_parallel.site_blocks``) the squares are summed block by
    block, leaves in order and blocks in site order."""
    if blocks is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves(tree)))
    return torch.sqrt(sum(torch.sum(torch.square(g[b].float()))
                          for g, bl in zip(leaves(tree), blocks)
                          for b in bl))


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree, *, donate: bool = False, blocks=None
                 ) -> tuple[Tree, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the norm is taken
    before clipping. With ``donate`` the moments of ``state`` and the
    leaves of ``params`` are updated in place and returned (the caller
    gives them up), so no second copy of them is made: the counterpart
    of the reference CLI's ``jit(..., donate_argnums=(0,))``.

    ``blocks`` (one list of index tuples a leaf, in leaf order:
    ``tensor_parallel.site_blocks`` of the moments' specs) is ZeRO-1 on
    a grid: each site updates its block of the moments and of the
    parameter, and the grad norm sums the blocks' squares in site order.
    AdamW is elementwise, so the blocks' updates are the whole leaf's."""
    step = state.step + 1
    gnorm = global_norm(grads, blocks)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=torch.float32, device=step.device))
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())

    def upd(g, m, v, p, inplace):
        g = g.float() * scale
        if inplace:
            m = m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v = v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        else:
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
        del g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        new = (p.float() - lr * delta).to(p.dtype)
        return (p.copy_(new) if inplace else new), m, v

    def upd_blocks(g, m, v, p, bl):
        """The sites' blocks of one leaf, each updated on its own."""
        if not donate:
            m, v, p = m.clone(), v.clone(), p.clone()
        for b in bl:
            upd(g[b], m[b], v[b], p[b], True)
        return p, m, v

    flat = zip(leaves(grads), leaves(state.mu), leaves(state.nu),
               leaves(params))
    out = ([upd(*x, donate) for x in flat] if blocks is None
           else [upd_blocks(*x, bl) for x, bl in zip(flat, blocks)])
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
