"""Model assembly for the dense and SSM families: init, the training
forward and loss, prefill, decode.

Counterpart of ``repro.models.transformer`` (dense GQA family and the
Mamba-2 ``ssm`` family). Layer parameters are stacked on a leading axis
exactly as in the JAX pytree — ``params["layers"]["attn"]["wq"]`` is (L,
d, H*dh) in the ``x @ W`` orientation, ``params["layers"]["ssm"]`` the
stacked ``SSMParams`` fields — so ``repro_torch.bridge`` moves weights
as plain copies; the layer loop is a Python loop over per-layer views
of that axis, each leaf unbound once (``_layers``; ``remat`` checkpoints
each layer with ``torch.utils.checkpoint``).
Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (init_embedding, init_linear,
                                       rms_norm, swiglu)

Params = dict[str, Any]
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _require_ported(cfg: ModelConfig) -> None:
    """The dense family (GQA, no MoE / MLA) and the pure SSM family are
    ported; the others raise."""
    dense = (cfg.family == "dense" and cfg.moe is None and cfg.mla is None)
    if not (dense or (cfg.family == "ssm" and cfg.ssm is not None)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP Queue 1 item 7: moe, mla, hybrid, vlm, audio)")


# ============================================================ init
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> Params:
    """Random weights at the reference's init scales, drawn from an
    explicit ``torch.Generator`` seeded with ``seed`` on ``device``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    d, L, dh = cfg.d_model, cfg.n_layers, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads

    def lin(d_in, d_out):
        return torch.stack([init_linear(gen, d_in, d_out, dtype, dev)
                            for _ in range(L)])

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params: Params = {
        "embed": init_embedding(gen, cfg.vocab, d, dtype, dev),
        "final_norm": ones(d),
    }
    if cfg.family == "ssm":
        layers = [ssm_mod.init_ssm(gen, d, cfg.ssm, dtype, dev)
                  for _ in range(L)]
        params["layers"] = {
            "ln": ones(L, d),
            "ssm": {f: torch.stack([getattr(p, f) for p in layers])
                    for f in ssm_mod.SSMParams._fields}}
    else:
        nd = dh if cfg.qk_norm else 0
        params["layers"] = {
            "ln1": ones(L, d), "ln2": ones(L, d),
            "attn": {"wq": lin(d, H * dh), "wk": lin(d, Hkv * dh),
                     "wv": lin(d, Hkv * dh), "wo": lin(H * dh, d),
                     "q_norm": ones(L, nd), "k_norm": ones(L, nd)},
            "mlp": {"gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                    "down": lin(cfg.d_ff, d)},
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, cfg.vocab, dtype, dev)
    return params


def _layers(params: Params) -> list[Params]:
    """Per-layer views of the stacked layer leaves, one dict per layer:
    each leaf is unbound once (``torch.unbind(leaf, 0)``), so the
    backward writes each layer's gradient slice once. Indexing a leaf
    per layer instead would give every layer a zero gradient as large as
    the whole stacked leaf, and autograd would add L of them."""
    lyr = params["layers"]
    split = [torch.unbind(leaf, 0) for leaf in tree.leaves(lyr)]
    return [tree.unflatten(lyr, [s[i] for s in split])
            for i in range(len(split[0]))]


def _attn_params(lp: Params) -> attn_mod.AttnParams:
    a = lp["attn"]
    qn, kn = a["q_norm"], a["k_norm"]
    return attn_mod.AttnParams(a["wq"], a["wk"], a["wv"], a["wo"],
                               qn if qn.numel() else None,
                               kn if kn.numel() else None)


def _mlp(lp: Params, h: torch.Tensor) -> torch.Tensor:
    m = lp["mlp"]
    return swiglu(h, m["gate"], m["up"], m["down"])


def _ssm_params(lp: Params) -> ssm_mod.SSMParams:
    return ssm_mod.SSMParams(**{f: lp["ssm"][f]
                                for f in ssm_mod.SSMParams._fields})


def _head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ============================================================ train forward
def _dense_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 use_kernel: bool) -> torch.Tensor:
    """Pre-norm attention + SwiGLU of one layer (``lp``: its views)."""
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + attn_mod.attention_train(
        _attn_params(lp), h, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, causal=cfg.causal,
        rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
        use_kernel=use_kernel)
    return x + _mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_eps))


def _ssm_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
               use_kernel: bool) -> torch.Tensor:
    """Pre-norm Mamba-2 block of one layer (``lp``: its views)."""
    h = rms_norm(x, lp["ln"], cfg.rms_eps)
    return x + ssm_mod.ssm_forward(_ssm_params(lp), h, cfg.ssm,
                                   rms_eps=cfg.rms_eps,
                                   use_kernel=use_kernel)


def forward(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            *, use_kernel: bool = False, remat: bool = False,
            activation_spec=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss scalar fp32; 0 for the dense
    and SSM families). ``remat`` recomputes each layer in the backward
    pass (``torch.utils.checkpoint``, non-reentrant), so the forward
    kernel runs twice per layer and step; the stacked leaves are unbound
    once, outside the checkpoints (``_layers``)."""
    _require_ported(cfg)
    if activation_spec is not None:
        raise NotImplementedError(
            "activation_spec (sequence-parallel residual sharding) is not "
            "ported yet (ROADMAP Queue 1 item 9, sharding)")
    block = _ssm_block if cfg.family == "ssm" else _dense_block
    x = params["embed"][batch["tokens"]]
    for lp in _layers(params):      # unbound here, outside the checkpoints
        if remat:
            x = checkpoint(block, cfg, lp, x, use_kernel,
                           use_reentrant=False)
        else:
            x = block(cfg, lp, x, use_kernel)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = x @ _head(cfg, params)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: dict[str, torch.Tensor], *, use_kernel: bool = False,
            remat: bool = False, activation_spec=None) -> torch.Tensor:
    """Mean next-token NLL over labels >= 0 (fp32 log-softmax) + aux."""
    logits, aux = forward(cfg, params, batch, use_kernel=use_kernel,
                          remat=remat, activation_spec=activation_spec)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    keep = labels >= 0
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = torch.where(keep, nll, torch.zeros_like(nll))
    count = torch.clamp(torch.sum(keep).float(), min=1.0)
    return torch.sum(nll) / count + aux


# ============================================================ decode cache
class DecodeCache(NamedTuple):
    """Stacked per-layer decode state; the fields a family does not use
    are size-0, as in the reference's pytree.

    ``k``/``v`` are the hot-tier buffers of the dense family — a ring of W
    slots when the engine runs a hot window (position p at slot ``p %
    W``), else W = Smax. ``conv``/``state`` are the SSM family's conv ring
    and fp32 recurrent state. ``pk``/``pv`` are the paged warm/cold pools
    (final physical block a write sentinel), size-0 unless created with
    paged blocks. Decode steps write these tensors in place.
    """
    k: torch.Tensor          # (L, B, Hkv, W, dh)
    v: torch.Tensor
    conv: torch.Tensor       # (L, B, ck-1, conv_dim)
    state: torch.Tensor      # (L, B, H, N, P) fp32
    pk: torch.Tensor         # (L, NB+1, bs, Hkv, dh) or size 0
    pv: torch.Tensor
    lengths: torch.Tensor    # (B,) int32 tokens already cached


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      paged_blocks: int = 0, block_size: int = 0,
                      hot_window: int = 0,
                      device: str | torch.device | None = None
                      ) -> DecodeCache:
    """Zero decode cache for ``batch`` sequences of up to ``max_len``
    tokens; ``paged_blocks`` > 0 adds the pools, ``hot_window`` > 0
    shrinks ``k``/``v`` to a ring (which needs the pools). The SSM
    family keeps ``conv``/``state`` instead of ``k``/``v`` and refuses
    pools, as the reference does."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if hot_window and not paged_blocks:
        raise ValueError("a hot-window ring cache needs paged pools to "
                         "back evicted tokens (paged_blocks > 0)")
    kv_len = min(hot_window, max_len) if hot_window else max_len

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    k, v, conv, state, pk, pv = z(0), z(0), z(0), z(0), z(0), z(0)
    if paged_blocks:
        if cfg.family != "dense":
            raise ValueError(f"paged KV pools require a GQA k/v cache; "
                             f"family {cfg.family} stores none")
        pk = z(L, paged_blocks + 1, block_size, Hkv, dh)
        pv = z(L, paged_blocks + 1, block_size, Hkv, dh)
    if cfg.family == "ssm":
        di, H, conv_dim = ssm_mod._dims(cfg.d_model, cfg.ssm)
        conv = z(L, batch, cfg.ssm.conv_kernel - 1, conv_dim)
        state = z(L, batch, H, cfg.ssm.d_state, cfg.ssm.head_dim,
                  dt=torch.float32)
    else:
        k, v = z(L, batch, Hkv, kv_len, dh), z(L, batch, Hkv, kv_len, dh)
    return DecodeCache(k=k, v=v, conv=conv, state=state, pk=pk, pv=pv,
                       lengths=torch.zeros(batch, dtype=torch.int32,
                                           device=dev))


# ============================================================ prefill
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int, *, true_len: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Batched prompt processing: next-token logits and a filled decode
    cache padded to ``max_len``.

    tokens: (B, S). ``true_len`` ((B,) or scalar) is the real prompt
    length when ``tokens`` is right-padded to a pow-2 bucket: causality
    keeps the first ``true_len`` positions exact, logits come from
    position ``true_len - 1`` and the padded K/V past it is dead. The SSM
    family takes prompts at their exact length: its running state would
    absorb the padding, so ``true_len`` raises there.
    """
    _require_ported(cfg)
    B, S = tokens.shape
    assert S <= max_len, (max_len, S)
    if true_len is not None and cfg.family == "ssm":
        raise ValueError("bucketed prefill (true_len) requires a "
                         "positional cache; SSM state absorbs padding")
    cache = init_decode_cache(cfg, B, max_len, device=tokens.device)
    if true_len is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        lens = torch.as_tensor(true_len, dtype=torch.int32,
                               device=tokens.device).expand(B).clone()
    x = params["embed"][tokens]
    for i, lp in enumerate(_layers(params)):
        if cfg.family == "ssm":
            out, c = ssm_mod.ssm_prefill(
                _ssm_params(lp), rms_norm(x, lp["ln"], cfg.rms_eps),
                cfg.ssm, rms_eps=cfg.rms_eps)
            cache.conv[i] = c.conv
            cache.state[i] = c.state
            x = x + out
            continue
        hn = rms_norm(x, lp["ln1"], cfg.rms_eps)
        attn_out, k, v = attn_mod.attention_prefill(
            _attn_params(lp), hn, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, causal=cfg.causal,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps)
        cache.k[i, :, :, :S] = k
        cache.v[i, :, :, :S] = v
        x = x + attn_out
        x = x + _mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if true_len is None:
        last = x[:, -1]
    else:   # last REAL token of each (possibly bucket-padded) prompt
        last = x[torch.arange(B, device=x.device), (lens - 1).long()]
    logits = last @ _head(cfg, params)
    return logits, cache._replace(lengths=lens)


# ============================================================ decode
def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: DecodeCache, *,
                decode_attn_fn: Optional[Callable] = None,
                paged_append: Optional[tuple] = None
                ) -> tuple[torch.Tensor, DecodeCache, Optional[torch.Tensor]]:
    """One autoregressive step. tokens: (B,) int. Returns (logits (B, V),
    cache with lengths + 1, scores (B, Smax) or None) — ``scores`` is the
    layer-mean per-token attention mass feeding the importance EMA, None
    for the attention-free SSM family.

    The cache tensors are updated in place. When the cache carries pools,
    ``paged_append=(dst_block, dst_slot)`` ((B,) physical coordinates,
    sentinel for inactive rows) must be given; each layer then mirrors
    its appended K/V into the pool and ``decode_attn_fn`` is called with
    the layer's pool slices ``(q, k_cache, v_cache, pk, pv, kv_lens)``.
    """
    _require_ported(cfg)
    d_fn = decode_attn_fn or attn_mod.dense_decode_attn
    use_paged = cache.pk.numel() > 0
    if use_paged and paged_append is None:
        raise ValueError("cache has paged KV pools; decode_step requires "
                         "paged_append=(dst_block, dst_slot)")
    lens = cache.lengths
    x = params["embed"][tokens]                           # (B, d)
    layers = _layers(params)
    if cfg.family == "ssm":
        for i, lp in enumerate(layers):
            out, new = ssm_mod.ssm_decode(
                _ssm_params(lp), rms_norm(x, lp["ln"], cfg.rms_eps),
                ssm_mod.SSMCache(cache.conv[i], cache.state[i]), cfg.ssm,
                rms_eps=cfg.rms_eps)
            cache.conv[i] = new.conv
            cache.state[i] = new.state
            x = x + out
        scores = None
    else:
        masses = []
        for i, lp in enumerate(layers):
            hn = rms_norm(x, lp["ln1"], cfg.rms_eps)
            paged = ((cache.pk[i], cache.pv[i]) + tuple(paged_append)
                     if use_paged else None)
            res = attn_mod.attention_decode(
                _attn_params(lp), hn, cache.k[i], cache.v[i], lens,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
                rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
                decode_attn_fn=d_fn, paged=paged)
            x = x + res[0]
            masses.append(res[1])
            x = x + _mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
        scores = torch.mean(torch.stack(masses), dim=0)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = x @ _head(cfg, params)
    return logits, cache._replace(lengths=lens + 1), scores
