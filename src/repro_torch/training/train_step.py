"""Train-step builder: loss + grad + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression with error feedback
(counterpart of ``repro.training.train_step``).

Parameters are a dict of tensors (the stacked ``(L, ...)`` layout of
``repro_torch.models.transformer``). The step asks autograd for the
gradients of the loss with respect to every leaf, so the parameters
themselves never carry ``requires_grad`` between steps.

On a (data, model) site grid (``launch.mesh.SiteGrid``, the reference's
``("data", "model")`` mesh; one controller, every site on the grid's
device) the dense family trains sharded, as the reference's step does
under its mesh:

  * the batch splits over the data replicas (``sharding.batch_specs``);
    each replica computes the loss of its slice, normalised by the whole
    batch's label count, on its model sites: the weights split by
    ``sharding.param_specs`` (``tensor_parallel.grid_params``: views
    built from the leaves inside the step, so the gradients reach the
    whole leaves; with ``fsdp`` the >= 2-D weights also split over data
    and are joined once a layer);
  * the replicas' gradients are summed in site order in fp32 and cast
    once (``pam_shard.site_all_reduce``); the loss is the replicas'
    sum;
  * AdamW updates each ZeRO-1 block of the moments
    (``sharding.opt_state_specs``), the grad norm summing the blocks in
    site order;
  * microbatches and int8 compression work as on one site, the
    compression after the cross-replica sum, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.pam_shard import site_all_reduce
from repro_torch.models import perf_flags
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
    activation_spec: Any = None   # the residual's spec between layers


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
def build_grad_fn(cfg: ModelConfig, tcfg: TrainConfig, *, grid=None,
                  fsdp: bool = False):
    """Returns grad_fn(params, batch) -> (loss, grads): one backward pass,
    or, with ``tcfg.microbatches`` M > 1 and batch leaves shaped (M, B/M,
    ...), the mean loss and the fp32 sum of each microbatch's grads / M.
    On ``grid`` each microbatch's loss and grads are its data replicas'
    sums (the module docstring); ``grid=None`` is one site."""
    if grid is not None and grid.size > 1:
        if not set(grid.axis_names) <= {"pod", "data", "model"}:
            raise ValueError(f"a train grid names pod, data and model "
                             f"axes, got {grid.axis_names}")
        tf.require_grid_training(cfg, "a train grid of more than one site")
    specs = (None if grid is None
             else shd.param_specs(cfg, grid, fsdp=fsdp))

    def loss_of(params, mb, count=None):
        return tf.loss_fn(cfg, params, mb, use_kernel=tcfg.use_kernel,
                          remat=tcfg.remat,
                          activation_spec=tcfg.activation_spec, count=count)

    def one(params, mb):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            if grid is None:
                loss = loss_of(params, mb)
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
                return loss.detach(), unflatten(params, grads)
            return replicas(params, flat, mb)
        finally:
            for p in flat:
                p.requires_grad_(False)

    def replicas(params, flat, mb):
        """Each data replica's loss and grads on its batch slice, summed
        over the replicas in site order."""
        B = next(iter(mb.values())).shape[0]
        dp = shd.batch_dp_spec(B, grid)
        n = 1 if dp is None else math.prod(grid.shape[a] for a in dp)
        count = torch.clamp(torch.sum(mb["labels"] >= 0).float(), min=1.0)
        losses, per_replica = [], []
        for r in range(n):
            part = {k: v[r * B // n:(r + 1) * B // n] for k, v in mb.items()}
            with perf_flags.use_grid(grid):
                loss = loss_of(tp.grid_params(params, specs, grid), part,
                               count)
                g = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
            losses.append(loss.detach())
            per_replica.append(g)
        if n == 1:
            return losses[0], unflatten(params, per_replica[0])
        grads = [site_all_reduce([g[i].float() for g in per_replica])
                 .to(flat[i].dtype) for i in range(len(flat))]
        return site_all_reduce(losses), unflatten(params, grads)

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
                     donate: bool = False, grid=None, fsdp: bool = False):
    """Returns train_step(state, batch) -> (state, metrics), metrics being
    0-d tensors ``loss``, ``grad_norm`` and ``step``. ``batch`` tensors
    carry a leading microbatch axis when ``tcfg.microbatches > 1``:
    (M, B/M, ...). With ``donate`` the step consumes ``state``: AdamW
    updates its parameters and moments in place and returns them (the
    reference's train CLI jits the step with ``donate_argnums=(0,)``), so
    the device holds one copy of the train state, not two. ``grid`` (a
    ``launch.mesh.SiteGrid``) trains the dense family on a (data, model)
    grid of sites with ZeRO-1 moments and, with ``fsdp``, FSDP weights
    (the module docstring); ``grid=None`` is the one-site step."""
    grad_fn = build_grad_fn(cfg, tcfg, grid=grid, fsdp=fsdp)
    blocks = None
    if grid is not None:
        shapes = shd.param_shapes(cfg)
        blocks = [tp.site_blocks(shapes[p], spec, grid) for p, spec in
                  shd.opt_state_specs(cfg, grid, fsdp=fsdp).items()]

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        loss, grads = grad_fn(state.params, batch)
        ef = state.error_feedback
        with torch.no_grad():
            if tcfg.compress_grads:
                grads, ef = compress_with_feedback(grads, ef)
            new_params, new_opt, gnorm = optim.adamw_update(
                tcfg.adamw, grads, state.opt, state.params, donate=donate,
                blocks=blocks)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
        return TrainState(new_params, new_opt, ef), metrics

    return train_step
