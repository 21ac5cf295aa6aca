"""Train-step builder: loss + grad + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression with error feedback
(counterpart of ``repro.training.train_step``).

Parameters are a dict of tensors (the stacked ``(L, ...)`` layout of
``repro_torch.models.transformer``). The step asks autograd for the
gradients of the loss with respect to every leaf, so the parameters
themselves never carry ``requires_grad`` between steps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training import optim
from repro_torch.tree import Tree, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: optim.AdamWConfig = optim.AdamWConfig()
    microbatches: int = 1       # grad-accumulation steps per update
    remat: bool = False
    use_kernel: bool = False
    compress_grads: bool = False  # int8 + error feedback


class TrainState(NamedTuple):
    params: Tree
    opt: optim.AdamWState
    error_feedback: Optional[Tree]   # compression residuals (or None)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, *,
                     device: str | torch.device | None = None) -> TrainState:
    params = tf.init_params(cfg, seed, device=device)
    ef = (tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
          if tcfg.compress_grads else None)
    return TrainState(params=params, opt=optim.adamw_init(params),
                      error_feedback=ef)


# ------------------------------------------------- int8 grad compression
def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads: Tree, ef: Tree) -> tuple[Tree, Tree]:
    """Quantize (g + residual) to int8 and carry the quantization error
    to the next step (1-bit-Adam-style error feedback)."""
    def one(g, e):
        target = g.float() + e
        deq = decompress_int8(*compress_int8(target))
        return deq.to(g.dtype), target - deq
    out = [one(g, e) for g, e in zip(leaves(grads), leaves(ef))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


# ------------------------------------------------------------ train step
def build_grad_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns grad_fn(params, batch) -> (loss, grads): one backward pass,
    or, with ``tcfg.microbatches`` M > 1 and batch leaves shaped (M, B/M,
    ...), the mean loss and the fp32 sum of each microbatch's grads / M."""
    def one(params, mb):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss = tf.loss_fn(cfg, params, mb, use_kernel=tcfg.use_kernel,
                              remat=tcfg.remat)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in flat:
                p.requires_grad_(False)
        return loss.detach(), unflatten(params, grads)

    def grad_fn(params, batch):
        M = tcfg.microbatches
        if M <= 1:
            return one(params, batch)
        acc, losses = None, []
        for i in range(M):
            loss, g = one(params, {k: v[i] for k, v in batch.items()})
            g = tree_map(lambda x: (x / M).float(), g)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            losses.append(loss)
        return torch.mean(torch.stack(losses)), acc

    return grad_fn


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                     donate: bool = False):
    """Returns train_step(state, batch) -> (state, metrics), metrics being
    0-d tensors ``loss``, ``grad_norm`` and ``step``. ``batch`` tensors
    carry a leading microbatch axis when ``tcfg.microbatches > 1``:
    (M, B/M, ...). With ``donate`` the step consumes ``state``: AdamW
    updates its parameters and moments in place and returns them (the
    reference's train CLI jits the step with ``donate_argnums=(0,)``), so
    the device holds one copy of the train state, not two."""
    grad_fn = build_grad_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        loss, grads = grad_fn(state.params, batch)
        ef = state.error_feedback
        with torch.no_grad():
            if tcfg.compress_grads:
                grads, ef = compress_with_feedback(grads, ef)
            new_params, new_opt, gnorm = optim.adamw_update(
                tcfg.adamw, grads, state.opt, state.params, donate=donate)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
        return TrainState(new_params, new_opt, ef), metrics

    return train_step
