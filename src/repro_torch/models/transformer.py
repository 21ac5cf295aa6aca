"""Model assembly for the dense, MoE, SSM, hybrid, vlm and audio
families: init, the training forward and loss, prefill, decode.

Counterpart of ``repro.models.transformer`` (dense GQA family, the GQA
mixture-of-experts family — attention as dense, the FFN routed by
``models/moe.py`` — the MLA mixture-of-experts family —
``params["layers"]["mla"]`` in place of ``attn``, a latent decode cache;
it trains through the plain chunked attention of ``mla.mla_train``, as
the reference does — the Mamba-2 ``ssm`` family, and the Zamba2-style
``hybrid`` family: groups of Mamba-2 layers, ``params["mamba_groups"]``
stacked (n_groups, mamba_per_group, ...), each group followed by one
shared attention + MLP block, ``params["shared_attn"]`` unstacked, at its
own KV cache site, then ``params["tail_mamba"]``, the ``vlm`` family — a
dense decoder whose ``params["frontend"]`` projects image
patch embeddings into a prefix before the token embeddings — and the
``audio`` family, a bidirectional encoder whose frames go through
``params["frontend"]`` in place of the embeddings, with no decode).
Layer parameters are stacked on a leading axis exactly as in the JAX
pytree — ``params["layers"]["attn"]["wq"]`` is (L, d, H*dh) in the
``x @ W`` orientation, ``params["layers"]["moe"]`` the stacked ``MoEParams``
fields (zero-size shared leaves without shared experts),
``params["layers"]["ssm"]`` the stacked ``SSMParams`` fields — so
``repro_torch.bridge`` moves weights as plain copies; the layer loop is
a Python loop over per-layer views of that axis, each leaf unbound once
(``_layers``, ``_hybrid_layers``; ``remat`` checkpoints each layer, and
each whole hybrid group, with ``torch.utils.checkpoint``). A sharded
serving engine's tree holds the leaves it splits as per-site slices
(``distributed.tensor_parallel.SiteSplit``); the weight products, the
embedding lookups and the head reach every leaf through
``tensor_parallel.linear`` / ``embedding``. A train step on a (data,
model) grid hands the dense family's forward its leaves the same way,
the stacked ones as ``tensor_parallel.GridLeaf``s that ``_layers``
unbinds (``training.train_step``); the other families train on one
site until their sharded training is ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import perf_flags
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (init_embedding, init_linear,
                                       rms_norm, swiglu)

Params = dict[str, Any]
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _gqa_moe(cfg: ModelConfig) -> bool:
    """The MoE family on GQA attention."""
    return (cfg.family == "moe" and cfg.moe is not None
            and cfg.mla is None)


def _mla_moe(cfg: ModelConfig) -> bool:
    """The MoE family on MLA attention (a latent decode cache)."""
    return (cfg.family == "moe" and cfg.moe is not None
            and cfg.mla is not None)


def _hybrid(cfg: ModelConfig) -> bool:
    """The Zamba2-style hybrid family (Mamba-2 groups around one shared
    attention block)."""
    return (cfg.family == "hybrid" and cfg.hybrid is not None
            and cfg.ssm is not None)


def dense_family(cfg: ModelConfig) -> bool:
    """The dense GQA family (no MoE, no MLA, no frontend): the one whose
    training takes a (data, model) grid and ``activation_spec``."""
    return cfg.family == "dense" and cfg.moe is None and cfg.mla is None


def require_grid_training(cfg: ModelConfig, what: str) -> None:
    """Raise for a family whose sharded training is not ported yet."""
    if not dense_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: {what} is ported for the dense family only; the "
            f"{cfg.family} family's sharded training is not ported yet "
            f"(ROADMAP Queue 1 item 10)")


def _require_ported(cfg: ModelConfig) -> None:
    """Every family of the reference is ported: the dense family and its
    vlm and audio variants (GQA, no MoE / MLA), the GQA and MLA MoE
    families, the pure SSM family and the hybrid family. Any other
    family string raises."""
    dense = (cfg.family in ("dense", "vlm", "audio") and cfg.moe is None
             and cfg.mla is None)
    if not (dense or _gqa_moe(cfg) or _mla_moe(cfg) or _hybrid(cfg)
            or (cfg.family == "ssm" and cfg.ssm is not None)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is no family of the "
            f"reference")



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

    def moe():
        """The stacked MoE leaves, allocated once and filled layer by
        layer (stacking per-layer copies would double the peak: one
        layer's experts are 4.8 GB at qwen3-moe-235b-a22b's width)."""
        st = {n: torch.empty((L,) + s, dtype=torch.float32 if n == "router"
                             else dtype, device=dev)
              for n, s in moe_mod.moe_shapes(d, cfg.moe).items()}
        for i in range(L):
            moe_mod.fill_moe(gen, d, cfg.moe, moe_mod.MoEParams(
                **{n: t[i] for n, t in st.items()}))
        return st

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
    elif _hybrid(cfg):   # the reference's keys: groups, tail, shared block
        hb = cfg.hybrid

        def mamba(*lead):
            """Stacked (*lead, ...) Mamba-2 layers, allocated once and
            filled layer by layer (65 layers are 10 GB at full width)."""
            st = {}
            for i in range(math.prod(lead)):
                p = ssm_mod.init_ssm(gen, d, cfg.ssm, dtype, dev)._asdict()
                for f, t in p.items():
                    if f not in st:
                        st[f] = torch.empty(lead + t.shape, dtype=t.dtype,
                                            device=dev)
                    st[f].view((-1,) + t.shape)[i] = t
            return {"ln": ones(*lead, d), "ssm": st}
        params["mamba_groups"] = mamba(hb.n_groups, hb.mamba_per_group)
        params["tail_mamba"] = mamba(hb.tail_mamba)
        nd = dh if cfg.qk_norm else 0

        def one(d_in, d_out):
            return init_linear(gen, d_in, d_out, dtype, dev)
        params["shared_attn"] = {
            "ln1": ones(d), "ln2": ones(d),
            "attn": {"wq": one(d, H * dh), "wk": one(d, Hkv * dh),
                     "wv": one(d, Hkv * dh), "wo": one(H * dh, d),
                     "q_norm": ones(nd), "k_norm": ones(nd)},
            "mlp": {"gate": one(d, cfg.d_ff), "up": one(d, cfg.d_ff),
                    "down": one(cfg.d_ff, d)}}
    elif _mla_moe(cfg):     # MLA in place of attn, the routed FFN
        layers = [mla_mod.init_mla(gen, d, H, cfg.mla, dtype, dev)
                  for _ in range(L)]
        params["layers"] = {
            "ln1": ones(L, d), "ln2": ones(L, d),
            "mla": {f: torch.stack([getattr(p, f) for p in layers])
                    for f in mla_mod.MLAParams._fields},
            "moe": moe()}
    else:
        nd = dh if cfg.qk_norm else 0
        params["layers"] = {
            "ln1": ones(L, d), "ln2": ones(L, d),
            "attn": {"wq": lin(d, H * dh), "wk": lin(d, Hkv * dh),
                     "wv": lin(d, Hkv * dh), "wo": lin(H * dh, d),
                     "q_norm": ones(L, nd), "k_norm": ones(L, nd)},
        }
        if cfg.moe is not None:      # the routed FFN in place of the MLP
            params["layers"]["moe"] = moe()
        else:
            params["layers"]["mlp"] = {
                "gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                "down": lin(cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, cfg.vocab, dtype, dev)
    if cfg.family in ("vlm", "audio"):
        params["frontend"] = init_linear(gen, cfg.frontend_dim, d, dtype,
                                         dev)
    return params


def _layers(params: Params) -> list[Params]:
    """Per-layer views of the stacked layer leaves, one dict per layer:
    each leaf is unbound once (``torch.unbind(leaf, 0)``), so the
    backward writes each layer's gradient slice once. Indexing a leaf
    per layer instead would give every layer a zero gradient as large as
    the whole stacked leaf, and autograd would add L of them. A sharded
    engine's split leaf unbinds each site's slice, and a train grid's
    ``GridLeaf`` each layer's placed weight (``tensor_parallel.unbind``)."""
    lyr = params["layers"]
    split = [tp.unbind(leaf) for leaf in tree.leaves(lyr)]
    return [tree.unflatten(lyr, [s[i] for s in split])
            for i in range(len(split[0]))]


def _hybrid_layers(cfg: ModelConfig, params: Params
                   ) -> tuple[list[list[Params]], list[Params]]:
    """Per-layer views of a hybrid model's Mamba-2 layers: (one list of
    ``mamba_per_group`` layer dicts per group, the tail's layer dicts).
    Each stacked leaf is unbound once, as in ``_layers`` (a group leaf's
    two layer axes flattened into one first, a view)."""
    def views(sub: Params, lead: int) -> list[Params]:
        split = [torch.unbind(torch.flatten(leaf, 0, lead - 1), 0)
                 for leaf in tree.leaves(sub)]
        return [tree.unflatten(sub, [s[i] for s in split])
                for i in range(len(split[0]))]
    npg = cfg.hybrid.mamba_per_group
    flat = views(params["mamba_groups"], 2)
    groups = [flat[g:g + npg] for g in range(0, len(flat), npg)]
    return groups, views(params["tail_mamba"], 1)


def _attn_params(lp: Params) -> attn_mod.AttnParams:
    a = lp["attn"]
    qn, kn = a["q_norm"], a["k_norm"]
    return attn_mod.AttnParams(a["wq"], a["wk"], a["wv"], a["wo"],
                               qn if qn.numel() else None,
                               kn if kn.numel() else None)


def _mlp(lp: Params, h: torch.Tensor) -> torch.Tensor:
    m = lp["mlp"]
    return swiglu(h, m["gate"], m["up"], m["down"])


def _moe_params(lp: Params) -> moe_mod.MoEParams:
    """One layer's MoE weights (tensors or a sharded engine's
    ``SiteSplit``s); an absent shared expert's size-0 placeholder, told
    by its shape, gives None."""
    m = lp["moe"]
    return moe_mod.MoEParams(**{f: None if 0 in m[f].shape else m[f]
                                for f in moe_mod.MoEParams._fields})


def _moe(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The routed FFN of a serving call, its aux loss unused (as in the
    reference's prefill and decode). h: (B, S, d); the router's capacity
    couples all B * S rows of the call."""
    return moe_mod.moe_forward(_moe_params(lp), h, cfg.moe)[0]


def _mla_params(lp: Params) -> mla_mod.MLAParams:
    return mla_mod.MLAParams(**{f: lp["mla"][f]
                                for f in mla_mod.MLAParams._fields})


def _ssm_params(lp: Params) -> ssm_mod.SSMParams:
    return ssm_mod.SSMParams(**{f: lp["ssm"][f]
                                for f in ssm_mod.SSMParams._fields})


def _head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ============================================================ train forward
def _sp_pin(h: torch.Tensor) -> torch.Tensor:
    """The ``sp_pin`` perf flag: a dense block's input or output held
    split on the sequence over the ambient grid's model sites
    (``tensor_parallel.pin``)."""
    if not perf_flags.enabled("sp_pin") or h.dim() != 3:
        return h
    return tp.pin(h, (None, "model", None))


def _dense_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 use_kernel: bool) -> torch.Tensor:
    """Pre-norm attention + SwiGLU (or the routed FFN) of one layer
    (``lp``: its views). MLA runs the plain chunked attention of
    ``mla_train`` whatever ``use_kernel`` says, as the reference does
    (it has no MLA kernel)."""
    h = _sp_pin(rms_norm(x, lp["ln1"], cfg.rms_eps))
    if cfg.mla is not None:
        x = x + mla_mod.mla_train(
            _mla_params(lp), h, cfg.mla, n_heads=cfg.n_heads,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
            causal=cfg.causal)
    else:
        x = x + attn_mod.attention_train(
            _attn_params(lp), h, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, causal=cfg.causal,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
            use_kernel=use_kernel)
    h = _sp_pin(rms_norm(x, lp["ln2"], cfg.rms_eps))
    if cfg.moe is not None:     # (x, the layer's aux loss)
        y, aux = moe_mod.moe_forward(_moe_params(lp), h, cfg.moe)
        return x + _sp_pin(y), aux
    return x + _sp_pin(_mlp(lp, h))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_dots``' policy: keep the weight products (``mm`` /
    ``addmm``: no batch dims, the reference's
    ``dots_with_no_batch_dims_saveable``), recompute everything else
    (the attention's batched products included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                               _save_dots)


def _ssm_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
               use_kernel: bool) -> torch.Tensor:
    """Pre-norm Mamba-2 block of one layer (``lp``: its views)."""
    h = rms_norm(x, lp["ln"], cfg.rms_eps)
    return x + ssm_mod.ssm_forward(_ssm_params(lp), h, cfg.ssm,
                                   rms_eps=cfg.rms_eps,
                                   use_kernel=use_kernel)


def _hybrid_group(cfg: ModelConfig, shared: Params, layers: list[Params],
                  x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """One group of the hybrid family's training forward (the
    reference's ``group_body``): its Mamba-2 layers (``layers``: their
    views), then the shared attention + MLP block."""
    for lp in layers:
        x = _ssm_block(cfg, lp, x, use_kernel)
    return _dense_block(cfg, shared, x, use_kernel)


def forward(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            *, use_kernel: bool = False, remat: bool = False,
            activation_spec=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), aux_loss scalar fp32: the MoE layers'
    summed load-balance losses, 0 for the other families).
    The audio family reads ``batch["frames"]`` (B, S, frontend_dim) in
    place of tokens; the vlm family puts ``batch["patches"]`` (B, P,
    frontend_dim), projected, before the token embeddings and drops the
    ``num_patches`` prefix positions from the logits.
    The hybrid family runs each group's Mamba-2 layers and then the
    shared block (``_hybrid_group``), then the tail's Mamba-2 layers; the
    shared block's gradient sums over its sites.
    ``remat`` recomputes each layer in the backward
    pass (``torch.utils.checkpoint``, non-reentrant), so the forward
    kernel runs twice per layer and step (with the ``remat_dots`` flag
    the checkpoint keeps the weight products: ``_save_dots``); a hybrid
    group is checkpointed whole, as the reference's ``group_body``, and
    each tail layer on its own. The stacked leaves are unbound once,
    outside the checkpoints (``_layers``, ``_hybrid_layers``).
    ``activation_spec`` (the dense family's): a spec over the residual
    stream's (B, S, d) dims that holds it split between layers as the
    ambient grid's sites do (``tensor_parallel.pin``; its data entries
    are the train step's replica split)."""
    if activation_spec is not None:
        require_grid_training(cfg, "activation_spec")
        activation_spec = tuple(activation_spec)
    _require_ported(cfg)

    def run(fn, *args):
        if remat:
            kw = ({"context_fn": _SAVE_DOTS}
                  if perf_flags.enabled("remat_dots") else {})
            return checkpoint(fn, cfg, *args, use_kernel,
                              use_reentrant=False, **kw)
        return fn(cfg, *args, use_kernel)

    def pin(h):
        return h if activation_spec is None else tp.pin(h, activation_spec)
    x = pin(_embed_inputs(cfg, params, batch))
    if _hybrid(cfg):
        groups, tail = _hybrid_layers(cfg, params)
        for layers in groups:
            x = run(_hybrid_group, params["shared_attn"], layers, x)
        for lp in tail:
            x = run(_ssm_block, lp, x)
        return _logits(cfg, params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    block = _ssm_block if cfg.family == "ssm" else _dense_block
    auxes = []
    for lp in _layers(params):      # unbound here, outside the checkpoints
        x = run(block, lp, x)
        if cfg.moe is not None:
            x, aux = x
            auxes.append(aux)
        x = pin(x)
    logits = _logits(cfg, params, x)
    if cfg.moe is not None:
        return logits, torch.sum(torch.stack(auxes))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def _logits(cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head over the residual stream; the vlm
    family drops its image-prefix positions."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = tp.linear(x, _head(cfg, params))
    if cfg.family == "vlm":      # strip the image-prefix positions
        logits = logits[:, cfg.num_patches:]
    return logits


def _embed_inputs(cfg: ModelConfig, params: Params,
                  batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """The residual stream's input: projected frames (audio), or the
    token embeddings behind the projected patches (vlm), or the token
    embeddings."""
    if cfg.family == "audio":
        return batch["frames"] @ params["frontend"]
    x = tp.embedding(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"] @ params["frontend"], x], dim=1)
    return x


def loss_fn(cfg: ModelConfig, params: Params,
            batch: dict[str, torch.Tensor], *, use_kernel: bool = False,
            remat: bool = False, activation_spec=None,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL over labels >= 0 (fp32 log-softmax) + aux.
    ``count``: the number of labels >= 0 of the whole batch when
    ``batch`` is one data replica's slice of it (the replicas' losses
    then sum to the whole batch's)."""
    logits, aux = forward(cfg, params, batch, use_kernel=use_kernel,
                          remat=remat, activation_spec=activation_spec)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    keep = labels >= 0
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = torch.where(keep, nll, torch.zeros_like(nll))
    if count is None:
        count = torch.clamp(torch.sum(keep).float(), min=1.0)
    return torch.sum(nll) / count + aux


# ============================================================ decode cache
class DecodeCache(NamedTuple):
    """Stacked per-layer decode state; the fields a family does not use
    are size-0, as in the reference's pytree.

    ``k``/``v`` are the hot-tier buffers of the dense family — a ring of W
    slots when the engine runs a hot window (position p at slot ``p %
    W``), else W = Smax — and of the hybrid family, one (B, Hkv, Smax,
    dh) cache per shared-attention site (n_groups of them).
    ``ckv``/``krope`` are the MLA family's latent cache (the normed
    latent and the roped shared key of each token). ``conv``/``state``
    are the SSM family's conv ring and fp32 recurrent state (the
    hybrid's: one a Mamba-2 layer, the groups' in order, then the
    tail's). ``pk``/``pv`` are the paged warm/cold pools (final physical
    block a write sentinel), size-0 unless created with paged blocks.
    Decode steps write these tensors in place.
    """
    k: torch.Tensor          # (L, B, Hkv, W, dh)
    v: torch.Tensor
    conv: torch.Tensor       # (L, B, ck-1, conv_dim)
    state: torch.Tensor      # (L, B, H, N, P) fp32
    pk: torch.Tensor         # (L, NB+1, bs, Hkv, dh) or size 0
    pv: torch.Tensor
    lengths: torch.Tensor    # (B,) int32 tokens already cached
    ckv: torch.Tensor        # (L, B, Smax, r) or size 0
    krope: torch.Tensor      # (L, B, Smax, dr) or size 0


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      paged_blocks: int = 0, block_size: int = 0,
                      hot_window: int = 0,
                      device: str | torch.device | None = None
                      ) -> DecodeCache:
    """Zero decode cache for ``batch`` sequences of up to ``max_len``
    tokens; ``paged_blocks`` > 0 adds the pools, ``hot_window`` > 0
    shrinks ``k``/``v`` to a ring (which needs the pools). The SSM
    family keeps ``conv``/``state`` instead of ``k``/``v``, the MLA
    family ``ckv``/``krope``, the hybrid family both ``conv``/``state``
    and a ``k``/``v`` site a group; all three refuse pools, as the
    reference does."""
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
    ckv, krope = z(0), z(0)
    if not cfg.has_decode:
        raise ValueError(f"family {cfg.family} has no decode step")
    if paged_blocks:
        if not (cfg.family in ("dense", "vlm") or _gqa_moe(cfg)):
            raise ValueError(f"paged KV pools require a GQA k/v cache; "
                             f"family {cfg.family} stores none")
        pk = z(L, paged_blocks + 1, block_size, Hkv, dh)
        pv = z(L, paged_blocks + 1, block_size, Hkv, dh)
    if cfg.family == "ssm":
        di, H, conv_dim = ssm_mod._dims(cfg.d_model, cfg.ssm)
        conv = z(L, batch, cfg.ssm.conv_kernel - 1, conv_dim)
        state = z(L, batch, H, cfg.ssm.d_state, cfg.ssm.head_dim,
                  dt=torch.float32)
    elif _mla_moe(cfg):
        ckv = z(L, batch, max_len, cfg.mla.kv_lora_rank)
        krope = z(L, batch, max_len, cfg.mla.qk_rope_head_dim)
    elif _hybrid(cfg):
        hb = cfg.hybrid
        n_mamba = hb.n_groups * hb.mamba_per_group + hb.tail_mamba
        di, H, conv_dim = ssm_mod._dims(cfg.d_model, cfg.ssm)
        conv = z(n_mamba, batch, cfg.ssm.conv_kernel - 1, conv_dim)
        state = z(n_mamba, batch, H, cfg.ssm.d_state, cfg.ssm.head_dim,
                  dt=torch.float32)
        # one KV cache per shared-attention site
        k = z(hb.n_groups, batch, Hkv, max_len, dh)
        v = z(hb.n_groups, batch, Hkv, max_len, dh)
    else:
        k, v = z(L, batch, Hkv, kv_len, dh), z(L, batch, Hkv, kv_len, dh)
    return DecodeCache(k=k, v=v, conv=conv, state=state, pk=pk, pv=pv,
                       lengths=torch.zeros(batch, dtype=torch.int32,
                                           device=dev),
                       ckv=ckv, krope=krope)


# ============================================================ prefill
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int, *, patches: torch.Tensor | None = None,
            true_len: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Batched prompt processing: next-token logits and a filled decode
    cache padded to ``max_len``.

    tokens: (B, S). ``true_len`` ((B,) or scalar) is the real prompt
    length when ``tokens`` is right-padded to a pow-2 bucket: causality
    keeps the first ``true_len`` positions exact, logits come from
    position ``true_len - 1`` and the padded K/V past it is dead. The SSM
    and hybrid families take prompts at their exact length: their running
    state would absorb the padding, so ``true_len`` raises there.
    A vlm model given ``patches`` (B, P, frontend_dim) prefills them,
    projected, as a prefix of P positions before the tokens: the cache
    holds P + S positions and its lengths count the prefix. The audio
    family has no decode cache and raises.
    """
    _require_ported(cfg)
    B, S = tokens.shape
    x = tp.embedding(params["embed"], tokens)
    n_prefix = 0
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches @ params["frontend"], x], dim=1)
        n_prefix = patches.shape[1]
    S = S + n_prefix
    assert S <= max_len, (max_len, S)
    if true_len is not None and cfg.family in ("ssm", "hybrid"):
        raise ValueError("bucketed prefill (true_len) requires a "
                         "positional cache; SSM state absorbs padding")
    cache = init_decode_cache(cfg, B, max_len, device=tokens.device)
    if true_len is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        lens = torch.as_tensor(true_len, dtype=torch.int32,
                               device=tokens.device).expand(B) + n_prefix
    if _hybrid(cfg):
        x = _hybrid_prefill(cfg, params, x, cache)
    for i, lp in enumerate(() if _hybrid(cfg) else _layers(params)):
        if cfg.family == "ssm":
            out, c = ssm_mod.ssm_prefill(
                _ssm_params(lp), rms_norm(x, lp["ln"], cfg.rms_eps),
                cfg.ssm, rms_eps=cfg.rms_eps)
            cache.conv[i] = c.conv
            cache.state[i] = c.state
            x = x + out
            continue
        if _mla_moe(cfg):
            attn_out, ckv, krp = mla_mod.mla_prefill(
                _mla_params(lp), rms_norm(x, lp["ln1"], cfg.rms_eps),
                cfg.mla, n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
                rms_eps=cfg.rms_eps, causal=cfg.causal)
            cache.ckv[i, :, :S] = ckv
            cache.krope[i, :, :S] = krp
            x = x + attn_out
            x = x + _moe(cfg, lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
            continue
        hn = rms_norm(x, lp["ln1"], cfg.rms_eps)
        attn_out, k, v = attn_mod.attention_prefill(
            _attn_params(lp), hn, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, causal=cfg.causal,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps)
        cache.k[i, :, :, :S] = k
        cache.v[i, :, :, :S] = v
        x = x + attn_out
        if cfg.moe is not None:
            x = x + _moe(cfg, lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
            continue
        x = x + _mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if true_len is None:
        last = x[:, -1]
    else:   # last REAL token of each (possibly bucket-padded) prompt
        last = x[torch.arange(B, device=x.device), (lens - 1).long()]
    logits = tp.linear(last, _head(cfg, params))
    return logits, cache._replace(lengths=lens)


def _hybrid_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor,
                    cache: DecodeCache) -> torch.Tensor:
    """The hybrid blocks of ``prefill`` over x (B, S, d): each group's
    Mamba-2 layers (conv tail and state into their cache rows), then the
    shared attention (causal) + MLP with its K/V into the group's site;
    then the tail. Returns the residual stream."""
    S = x.shape[1]
    shared = params["shared_attn"]
    groups, tail = _hybrid_layers(cfg, params)
    i = 0

    def mamba(lp, x):
        nonlocal i
        out, c = ssm_mod.ssm_prefill(
            _ssm_params(lp), rms_norm(x, lp["ln"], cfg.rms_eps), cfg.ssm,
            rms_eps=cfg.rms_eps)
        cache.conv[i] = c.conv
        cache.state[i] = c.state
        i += 1
        return x + out
    for g, layers in enumerate(groups):
        for lp in layers:
            x = mamba(lp, x)
        attn_out, k, v = attn_mod.attention_prefill(
            _attn_params(shared), rms_norm(x, shared["ln1"], cfg.rms_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            causal=True, rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps)
        cache.k[g, :, :, :S] = k
        cache.v[g, :, :, :S] = v
        x = x + attn_out
        x = x + _mlp(shared, rms_norm(x, shared["ln2"], cfg.rms_eps))
    for lp in tail:
        x = mamba(lp, x)
    return x


def prefill_suffix(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                   prefix_len: torch.Tensor, *,
                   true_len: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Suffix-only prefill of a prefix-cache (or chunked) admission.

    Processes only the novel tail of a prompt whose first ``prefix_len``
    tokens already have cache-resident K/V (gathered from the paged pool
    through the request's block table); by causality the result equals
    a from-scratch prefill's for the suffix positions.

    tokens: (B, S) suffix tokens, right-padded to a bucket; prefix_k/v:
    (L, B, Hkv, P, dh) logical layout, live below ``prefix_len`` ((B,)
    or scalar); true_len: real suffix length per row (``None``: all of
    S). Returns (logits at the last real suffix token (B, V), suffix K/V
    (L, B, Hkv, S, dh)). GQA-cache families only (dense and GQA MoE),
    as in the reference.
    """
    if not (cfg.family == "dense"
            or (cfg.family == "moe" and cfg.mla is None)):
        raise ValueError(f"suffix prefill needs a token-only GQA cache; "
                         f"family {cfg.family} is not supported")
    _require_ported(cfg)
    B, S = tokens.shape
    dev = tokens.device

    def per_row(v):          # an int, or a (B,) / 0-dim tensor -> (B,)
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.int32).expand(B)
        return torch.full((B,), int(v), dtype=torch.int32, device=dev)
    plen = per_row(prefix_len)
    slen = per_row(S if true_len is None else true_len)
    x = tp.embedding(params["embed"], tokens)
    ks, vs = [], []
    for i, lp in enumerate(_layers(params)):
        hn = rms_norm(x, lp["ln1"], cfg.rms_eps)
        attn_out, k, v = attn_mod.attention_prefill_with_prefix(
            _attn_params(lp), hn, prefix_k[i], prefix_v[i], plen,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps)
        x = x + attn_out
        if cfg.moe is not None:
            x = x + _moe(cfg, lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
        else:
            x = x + _mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last = x[torch.arange(B, device=dev), (slen - 1).long()]
    return (tp.linear(last, _head(cfg, params)), torch.stack(ks),
            torch.stack(vs))


# ============================================================ decode
def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: DecodeCache, *,
                decode_attn_fn: Optional[Callable] = None,
                paged_append: Optional[tuple] = None,
                latent_attn_fn: Optional[Callable] = None
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
    The hybrid family calls ``decode_attn_fn`` once a shared-attention
    site (n_groups times a step); its ``scores`` are the sites' mean.
    The MLA family writes its latent cache in place and calls
    ``latent_attn_fn`` (default ``mla.mla_latent_decode_attn``; the
    engine's participation-masked one) in place of ``decode_attn_fn``.
    """
    _require_ported(cfg)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    d_fn = decode_attn_fn or attn_mod.dense_decode_attn
    use_paged = cache.pk.numel() > 0
    if use_paged and paged_append is None:
        raise ValueError("cache has paged KV pools; decode_step requires "
                         "paged_append=(dst_block, dst_slot)")
    lens = cache.lengths
    x = tp.embedding(params["embed"], tokens)             # (B, d)
    layers = () if _hybrid(cfg) else _layers(params)
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
    elif _hybrid(cfg):
        x, scores = _hybrid_decode(cfg, params, x, cache, d_fn)
    elif _mla_moe(cfg):
        l_fn = latent_attn_fn or mla_mod.mla_latent_decode_attn
        masses = []
        for i, lp in enumerate(layers):
            attn_out, mass, _, _ = mla_mod.mla_decode(
                _mla_params(lp), rms_norm(x, lp["ln1"], cfg.rms_eps),
                cache.ckv[i], cache.krope[i], lens, cfg.mla,
                n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
                rms_eps=cfg.rms_eps, latent_attn_fn=l_fn)
            x = x + attn_out
            masses.append(mass)
            hn = rms_norm(x, lp["ln2"], cfg.rms_eps)
            x = x + _moe(cfg, lp, hn[:, None])[:, 0]
        scores = torch.mean(torch.stack(masses), dim=0)
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
            if cfg.moe is not None:  # (B, 1, d) as the reference: T = B
                hn = rms_norm(x, lp["ln2"], cfg.rms_eps)
                x = x + _moe(cfg, lp, hn[:, None])[:, 0]
                continue
            x = x + _mlp(lp, rms_norm(x, lp["ln2"], cfg.rms_eps))
        scores = torch.mean(torch.stack(masses), dim=0)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = tp.linear(x, _head(cfg, params))
    return logits, cache._replace(lengths=lens + 1), scores


def _hybrid_decode(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   cache: DecodeCache, d_fn: Callable
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hybrid blocks of ``decode_step`` for x (B, d): each group's
    Mamba-2 layers (conv ring and state in place), then the shared
    attention at the group's site through ``d_fn`` + MLP, then the tail.
    Returns (x, scores: the mean of the sites' masses (B, Smax))."""
    lens = cache.lengths
    shared = params["shared_attn"]
    groups, tail = _hybrid_layers(cfg, params)
    i = 0

    def mamba(lp, x):
        nonlocal i
        out, new = ssm_mod.ssm_decode(
            _ssm_params(lp), rms_norm(x, lp["ln"], cfg.rms_eps),
            ssm_mod.SSMCache(cache.conv[i], cache.state[i]), cfg.ssm,
            rms_eps=cfg.rms_eps)
        cache.conv[i] = new.conv
        cache.state[i] = new.state
        i += 1
        return x + out
    masses = []
    for g, layers in enumerate(groups):
        for lp in layers:
            x = mamba(lp, x)
        attn_out, mass, _, _ = attn_mod.attention_decode(
            _attn_params(shared), rms_norm(x, shared["ln1"], cfg.rms_eps),
            cache.k[g], cache.v[g], lens, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
            decode_attn_fn=d_fn)
        x = x + attn_out
        x = x + _mlp(shared, rms_norm(x, shared["ln2"], cfg.rms_eps))
        masses.append(mass)
    for lp in tail:
        x = mamba(lp, x)
    return x, torch.mean(torch.stack(masses), dim=0)
