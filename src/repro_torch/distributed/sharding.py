"""Sharding rules of the serving engine: which axis of each parameter
leaf and of each decode-cache field splits over a sharded engine's
sites.

Counterpart of the serving half of ``repro.distributed.sharding``, on
the 1-D ``("model",)`` layout a sharded engine runs on (Megatron-style
tensor parallelism plus PAM's sequence sharding of the KV):

  column-parallel (last dim split):       wq wk wv gate up in_proj w_uk
                                          w_uv w_kr shared_gate shared_up
                                          frontend
  row-parallel (2nd-to-last dim split):   wo down out_proj shared_down
                                          w_dkv
  MoE experts:                            the ffn dim (w_gate / w_up last,
                                          w_down 2nd-to-last)
  embed:                                  vocab when it divides, else d
  lm_head:                                vocab (column) when it divides,
                                          else d (row)
  replicated:                             norms, router, everything else

A rule falls back to replication when the dim does not divide, as the
reference's does. A spec is a tuple with one entry a dim, ``"model"``
on the split dim and None elsewhere (``tuple()`` of the reference's
``PartitionSpec``). The expert-parallel ``data`` axis, the ZeRO-style
optimizer specs and the batch specs belong to multi-device training
(ROADMAP Queue 1 item 10). Plain Python: no device is touched.
"""

from __future__ import annotations

from typing import Any, Optional

MODEL = "model"
Spec = tuple

_COLUMN = ("wq", "wk", "wv", "gate", "up", "in_proj", "w_uk", "w_uv",
           "w_kr", "shared_gate", "shared_up", "frontend")
_ROW = ("wo", "down", "out_proj", "shared_down", "w_dkv")
_EXPERT = ("w_gate", "w_up", "w_down")
_MODEL_VEC = ("out_norm",)       # 1-D activations split on model (d_inner)


def _divides(dim: int, shard: int) -> bool:
    return dim > 0 and dim % shard == 0


def leaf_spec(name: str, parent: str, shape: tuple[int, ...],
              shard: int) -> Spec:
    """The spec of one parameter leaf named ``name`` under ``parent``
    (its dict key and its parent's) with ``shape``, over ``shard``
    sites: the reference's ``_leaf_spec`` on a ``("model",)`` mesh."""
    nd = len(shape)
    none = [None] * nd

    def with_axis(pos: int) -> Spec:
        s = list(none)
        if 0 <= pos < nd and _divides(shape[pos], shard):
            s[pos] = MODEL
        return tuple(s)

    if name == "embed":
        # vocab-parallel when the vocab divides (minicpm's 122,753 does
        # not: d-parallel)
        if _divides(shape[nd - 2], shard):
            return with_axis(nd - 2)
        return with_axis(nd - 1)
    if name == "lm_head":
        if _divides(shape[nd - 1], shard):
            return with_axis(nd - 1)       # column (vocab) parallel
        return with_axis(nd - 2)           # row parallel fallback
    if parent == "moe" and name in _EXPERT:
        return with_axis(nd - 1 if name in ("w_gate", "w_up") else nd - 2)
    if name in _COLUMN:
        return with_axis(nd - 1)
    if name in _ROW:
        return with_axis(nd - 2)
    if name in ("conv_w", "conv_b"):
        return with_axis(nd - 1)           # conv_dim
    if name in _MODEL_VEC:
        return with_axis(nd - 1)
    return tuple(none)


def split_axis(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the sites, or None (replicated)."""
    return spec.index(MODEL) if MODEL in spec else None


def param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shape of every parameter leaf of ``init_params(cfg)`` by dotted
    path, without allocating it (the init runs on fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import tree
    from repro_torch.models import transformer as tf
    with FakeTensorMode():
        params = tf.init_params(cfg, 0, device="cpu")
    return {p: tuple(leaf.shape)
            for p, leaf in tree.leaves_with_paths(params)}


def param_specs(cfg, shard: int, params: Any = None) -> dict[str, Spec]:
    """The spec of every parameter leaf by dotted path (``layers.attn.wq``):
    the reference's ``param_specs`` on a ``("model",)`` mesh of
    ``shard`` sites. The shapes are ``params``' when given, else
    ``init_params(cfg)``'s."""
    if params is None:
        shapes = param_shapes(cfg)
    else:
        from repro_torch import tree
        shapes = {p: tuple(leaf.shape)
                  for p, leaf in tree.leaves_with_paths(params)}
    out = {}
    for path, shape in shapes.items():
        keys = path.split(".")
        parent = keys[-2] if len(keys) > 1 else ""
        out[path] = leaf_spec(keys[-1], parent, shape, shard)
    return out


def serving_cache_shardings(cache, shard: int):
    """Specs of a sharded serving engine's decode cache, a
    ``DecodeCache`` of specs (``()``: replicated).

    The two axes whose sizes are independent of batch and divisible by
    construction (``EngineSpec.validate``) split over the sites:

      * the hot ring's slot axis, ``k`` / ``v`` (L, B, Hkv, W, dh) on W:
        site ``r`` holds slots ``[r W / g, (r + 1) W / g)``, and absolute
        position p lives on the site owning slot ``p % W``;
      * the pool's physical-block axis, ``pk`` / ``pv`` (L, NB+1, bs,
        Hkv, dh) on NB+1 (``paged_kv.shard_block_ranges``), the block
        tables keeping global ids.

    Everything else (the lengths, a family's unused fields) is
    replicated."""
    def spec(name: str, x) -> Spec:
        if x.numel() == 0 or x.dim() != 5:
            return ()
        if name in ("k", "v") and x.shape[3] % shard == 0:
            return (None, None, None, MODEL, None)
        if name in ("pk", "pv") and x.shape[1] % shard == 0:
            return (None, MODEL, None, None, None)
        return ()

    return type(cache)(*[spec(f, x) for f, x in zip(cache._fields, cache)])


def decode_cache_specs(cfg, shard: int):
    """The dry-run decode cache layout over ``shard`` sites (the
    reference's ``decode_cache_specs`` on a ``("model",)`` mesh, where
    the batch axis stays whole): the KV sequence split (each site one
    PIM site holding a KV shard), SSM heads and the conv dim split when
    they divide, pools replicated (the paged pool is the serving
    engine's, ``serving_cache_shardings``). A ``DecodeCache`` of
    specs."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf

    def seq_kv(ndim: int, seq_axis: int) -> Spec:
        s = [None] * ndim
        s[seq_axis] = MODEL
        return tuple(s)

    k = v = ckv = krope = conv = state = ()
    if cfg.family in ("dense", "vlm") or (cfg.family == "moe"
                                          and cfg.mla is None):
        k = v = seq_kv(5, 3)                  # (L, B, Hkv, S, dh)
    elif cfg.family == "moe":
        ckv = krope = seq_kv(4, 2)            # (L, B, S, r)
    if cfg.family in ("ssm", "hybrid"):
        _, H, conv_dim = ssm_mod._dims(cfg.d_model, cfg.ssm)
        conv = (None, None, None,
                MODEL if _divides(conv_dim, shard) else None)
        state = (None, None, MODEL if _divides(H, shard) else None,
                 None, None)                  # (L, B, H, N, P)
    if cfg.family == "hybrid":
        k = v = seq_kv(5, 3)
    return tf.DecodeCache(k=k, v=v, conv=conv, state=state, pk=(), pv=(),
                          lengths=(None,), ckv=ckv, krope=krope)
