"""Sharding rules: which axis of each parameter leaf, optimizer moment,
batch and decode-cache field splits over a grid of sites.

Counterpart of ``repro.distributed.sharding`` (Megatron-style tensor
parallelism over ``model``, data parallelism over ``data``, PAM's
sequence sharding of the KV):

  column-parallel (last dim on model):    wq wk wv gate up in_proj w_uk
                                          w_uv w_kr shared_gate shared_up
                                          frontend
  row-parallel (2nd-to-last on model):    wo down out_proj shared_down
                                          w_dkv
  MoE experts:                            E on data, the ffn dim on model
                                          (w_gate / w_up last, w_down
                                          2nd-to-last)
  embed:                                  vocab on model when it divides,
                                          else d
  lm_head:                                vocab (column) when it divides,
                                          else d (row)
  replicated:                             norms, router, everything else
  optimizer moments (ZeRO-1):             the param spec plus data on the
                                          first free axis that divides
  fsdp:                                   every >= 2-D weight also takes
                                          data so (ZeRO-3 style)
  batch:                                  the leading axis over (pod,
                                          data) when it divides

A rule falls back to replication when the dim does not divide, as the
reference's does. A grid is anything with ``shape`` (axis name -> size)
and ``axis_names`` (``launch.mesh.SiteGrid``, or a stand-in); a sharded
serving engine passes its site count, read as a ``("model",)`` grid. A
spec is a tuple with one entry a dim: an axis name, a tuple of names, or
None (``tuple()`` of the reference's ``PartitionSpec``). Spec trees are
dicts by dotted leaf path (``layers.attn.wq``). Plain Python: no device
is touched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.launch.mesh import dp_axes

MODEL = "model"
DATA = "data"
Spec = tuple

_COLUMN = ("wq", "wk", "wv", "gate", "up", "in_proj", "w_uk", "w_uv",
           "w_kr", "shared_gate", "shared_up", "frontend")
_ROW = ("wo", "down", "out_proj", "shared_down", "w_dkv")
_EXPERT = ("w_gate", "w_up", "w_down")
_MODEL_VEC = ("out_norm",)       # 1-D activations split on model (d_inner)


def _sizes(grid) -> dict[str, int]:
    """Axis sizes of a grid; an int is a serving engine's site count."""
    if isinstance(grid, int):
        return {MODEL: grid}
    return dict(grid.shape)


def _divides(dim: int, sizes: dict[str, int], axis: str) -> bool:
    return axis in sizes and dim > 0 and dim % sizes[axis] == 0


def leaf_spec(name: str, parent: str, shape: tuple[int, ...],
              grid) -> Spec:
    """The spec of one parameter leaf named ``name`` under ``parent``
    (its dict key and its parent's) with ``shape`` over ``grid``: the
    reference's ``_leaf_spec``."""
    sizes = _sizes(grid)
    nd = len(shape)
    none = [None] * nd

    def with_axis(pos: int) -> Spec:
        s = list(none)
        if 0 <= pos < nd and _divides(shape[pos], sizes, MODEL):
            s[pos] = MODEL
        return tuple(s)

    if name == "embed":
        # vocab-parallel when the vocab divides (minicpm's 122,753 does
        # not: d-parallel)
        if _divides(shape[nd - 2], sizes, MODEL):
            return with_axis(nd - 2)
        return with_axis(nd - 1)
    if name == "lm_head":
        if _divides(shape[nd - 1], sizes, MODEL):
            return with_axis(nd - 1)       # column (vocab) parallel
        return with_axis(nd - 2)           # row parallel fallback
    if parent == "moe" and name in _EXPERT:
        # 2-D expert split: the experts over data, the ffn dim over model
        s = list(none)
        if _divides(shape[nd - 3], sizes, DATA):
            s[nd - 3] = DATA
        ffn = nd - 1 if name in ("w_gate", "w_up") else nd - 2
        if _divides(shape[ffn], sizes, MODEL):
            s[ffn] = MODEL
        return tuple(s)
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


_SHAPES: dict = {}


def param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shape of every parameter leaf of ``init_params(cfg)`` by dotted
    path, without allocating it (the init runs on fake tensors; the MoE
    experts' per-layer draws, which fix no shape, are skipped). Kept per
    config."""
    if cfg not in _SHAPES:
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch import tree
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as tf
        fill, moe_mod.fill_moe = moe_mod.fill_moe, lambda *a: None
        try:
            with FakeTensorMode():
                params = tf.init_params(cfg, 0, device="cpu")
        finally:
            moe_mod.fill_moe = fill
        _SHAPES[cfg] = {p: tuple(leaf.shape)
                        for p, leaf in tree.leaves_with_paths(params)}
    return dict(_SHAPES[cfg])


def param_specs(cfg, grid, params: Any = None, *,
                fsdp: bool = False) -> dict[str, Spec]:
    """The spec of every parameter leaf by dotted path: the reference's
    ``param_specs`` over ``grid`` (a sharded serving engine passes its
    site count). The shapes are ``params``' when given, else
    ``init_params(cfg)``'s. ``fsdp`` also splits each >= 2-D weight over
    data on its first free axis that divides (ZeRO-3 style)."""
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
        spec = leaf_spec(keys[-1], parent, shape, grid)
        if fsdp and len(shape) >= 2:
            spec = _zero1_spec(spec, shape, grid)
        out[path] = spec
    return out


def _zero1_spec(spec: Spec, shape: tuple[int, ...], grid) -> Spec:
    """``data`` on the first axis the param spec leaves free and that
    divides (ZeRO-1); a spec that already holds ``data`` (the MoE's
    experts) stays."""
    sizes = _sizes(grid)
    s = list(spec) + [None] * (len(shape) - len(spec))
    if DATA in s:
        return tuple(s)
    for i, (dim, cur) in enumerate(zip(shape, s)):
        if cur is None and _divides(dim, sizes, DATA):
            s[i] = DATA
            break
    return tuple(s)


def opt_state_specs(cfg, grid, *, fsdp: bool = False) -> dict[str, Spec]:
    """Specs of the AdamW moments (mu and nu alike): the param spec plus
    ZeRO-1's ``data`` split."""
    shapes = param_shapes(cfg)
    return {p: _zero1_spec(s, shapes[p], grid)
            for p, s in param_specs(cfg, grid, fsdp=fsdp).items()}


def batch_dp_spec(global_batch: int, grid):
    """The leading batch axis's entry: the data axes (pod, data) when
    the batch divides over them all, else ``("data",)`` when it divides
    over data, else None (replicated)."""
    axes = dp_axes(grid)
    size = 1
    for a in axes:
        size *= grid.shape[a]
    if global_batch % size == 0:
        return axes
    if DATA in axes and global_batch % grid.shape[DATA] == 0:
        return (DATA,)
    return None


def batch_specs(cfg, global_batch: int, grid) -> dict[str, Spec]:
    """Specs of one training batch's leaves, by key."""
    dp = batch_dp_spec(global_batch, grid)
    if cfg.family == "audio":
        return {"frames": (dp, None, None), "labels": (dp, None)}
    specs = {"tokens": (dp, None), "labels": (dp, None)}
    if cfg.family == "vlm":
        specs["patches"] = (dp, None, None)
    return specs


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """A leaf's layout on a grid (the reference's ``NamedSharding``):
    the leaf lives whole on ``grid.device``, each site's slice a view of
    it that ``spec`` names."""
    grid: Any
    spec: Spec

    @property
    def device(self):
        return self.grid.device

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """One site's slice shape of a leaf of ``shape``; raises when
        the spec does not divide it."""
        sizes = _sizes(self.grid)
        out = list(shape)
        for i, entry in enumerate(self.spec):
            for a in entry_axes(entry):
                if out[i] % sizes[a]:
                    raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                     f"split over {a} = {sizes[a]}")
                out[i] //= sizes[a]
        return tuple(out)


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim whose entry names ``axis``, or None."""
    for i, entry in enumerate(spec):
        if axis in entry_axes(entry):
            return i
    return None


def param_shardings(cfg, grid, *, fsdp: bool = False
                    ) -> dict[str, GridSharding]:
    return {p: GridSharding(grid, s)
            for p, s in param_specs(cfg, grid, fsdp=fsdp).items()}


def make_sharded_zeros(specs: dict[str, Spec], shapes: Any, grid) -> Any:
    """Zeros shaped like the tree ``shapes`` (tensors, meta tensors
    included: their shapes and dtypes) on ``grid``'s device, each leaf
    checked against its spec (the reference's launcher helper)."""
    import torch

    from repro_torch import tree
    out = []
    for path, leaf in tree.leaves_with_paths(shapes):
        GridSharding(grid, specs.get(path, ())).shard_shape(tuple(leaf.shape))
        out.append(torch.zeros(tuple(leaf.shape), dtype=leaf.dtype,
                               device=grid.device))
    return tree.unflatten(shapes, out)


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
                MODEL if _divides(conv_dim, _sizes(shard), MODEL) else None)
        state = (None, None,
                 MODEL if _divides(H, _sizes(shard), MODEL) else None,
                 None, None)                  # (L, B, H, N, P)
    if cfg.family == "hybrid":
        k = v = seq_kv(5, 3)
    return tf.DecodeCache(k=k, v=v, conv=conv, state=state, pk=(), pv=(),
                          lengths=(None,), ckv=ckv, krope=krope)
