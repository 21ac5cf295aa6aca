"""Carry the JAX reference's state into the port as plain copies.

The port keeps the reference's stacked ``(L, ...)`` parameter layout and
``x @ W`` orientation, so every leaf crosses unchanged. Inputs are the
reference's pytrees with numpy leaves (``jax.tree.map(np.asarray, t)``)
or anything ``np.asarray`` accepts; this module imports neither ``jax``
nor the reference package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DecodeCache, _require_ported
from repro_torch.serving.pam_manager import PAMState
from repro_torch.training.optim import AdamWState
from repro_torch.training.train_step import TrainState


def to_tensor(x: Any, device: torch.device) -> torch.Tensor:
    """One array leaf as a tensor; bfloat16 crosses through float32
    (exact), since numpy has no native bfloat16."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return to_tensor(x, device)


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: str | torch.device | None = None) -> dict:
    """The reference's ``tf.init_params(cfg, key)`` pytree as the port's
    parameter dict (same keys, same shapes and dtypes: the SSM family's
    fp32 ``dt_bias``, ``a_log`` and ``d_skip`` and the MoE family's fp32
    ``router`` stay fp32 in a bf16 model; the MoE's zero-size shared
    leaves cross as they are; an MLA model's ``layers/mla`` holds the
    stacked ``MLAParams`` fields; the vlm and audio families' patch or
    frame projection is ``frontend``)."""
    _require_ported(cfg)
    return _tree(tree, resolve_device(device))


def cache_from_jax(cache: Any,
                   device: str | torch.device | None = None) -> DecodeCache:
    """A reference ``DecodeCache`` (the dense family's ``k``/``v`` and
    pools, the MLA family's latent ``ckv``/``krope``, the SSM family's
    ``conv``/``state``) as the port's, field by field by name."""
    dev = resolve_device(device)
    return DecodeCache(*(to_tensor(getattr(cache, f), dev)
                         for f in DecodeCache._fields))


def pam_state_from_jax(state: Any,
                       device: str | torch.device | None = None) -> PAMState:
    """A reference ``PAMState`` as the port's (its step counter becomes
    the host integer the port keeps)."""
    dev = resolve_device(device)
    return PAMState(importance=to_tensor(state.importance, dev),
                    tier=to_tensor(state.tier, dev),
                    step=int(np.asarray(state.step)),
                    moved_tokens=to_tensor(state.moved_tokens, dev),
                    last_hot=to_tensor(state.last_hot, dev),
                    block_table=to_tensor(state.block_table, dev))


def train_state_from_jax(cfg: ModelConfig, state: Any,
                         device: str | torch.device | None = None
                         ) -> TrainState:
    """A reference ``TrainState`` as the port's: params, the AdamW step
    counter (0-d int32) and fp32 moments, and the error-feedback tree
    (or None), so both packages train from identical state."""
    dev = resolve_device(device)
    ef = state.error_feedback
    return TrainState(
        params=params_from_jax(cfg, state.params, dev),
        opt=AdamWState(step=to_tensor(state.opt.step, dev).to(torch.int32),
                       mu=_tree(state.opt.mu, dev),
                       nu=_tree(state.opt.nu, dev)),
        error_feedback=None if ef is None else _tree(ef, dev))
