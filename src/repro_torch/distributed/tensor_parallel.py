"""Tensor-parallel weights over a grid of sites.

A sharded serving engine holds each parameter leaf that
``sharding.param_specs`` splits as a ``SiteSplit``: one slice a site, in
site order. On one card each slice is a view of the one allocation the
weights already have, so a fleet of engines still shares one copy. The
model code reaches every weight product through ``linear`` and every
embedding lookup through ``embedding``, which take a plain tensor as
they would (``x @ w``, ``w[ids]``) and a ``SiteSplit`` per site:

  * column-parallel (the output dim split): each site's product, joined
    in site order (an all-gather) before any per-head op, so a split may
    fall inside a head; when the heads divide over the sites, the
    training attention instead runs each site's heads on their own
    (``head_sites``) and sums the sites' row-parallel ``wo`` products,
    and a SwiGLU's column-split ``gate`` / ``up`` meet its row-split
    ``down`` site by site (``swiglu``), as Megatron does;
  * row-parallel (the input dim split): each site's partial product on
    its slice of the input, summed in site order in fp32 and cast once
    (``pam_shard.site_all_reduce``);
  * a vocab-parallel embedding: each site looks up the ids it owns
    (others read 0) and the sites' rows are summed; a d-parallel one
    joins the sites' columns. The tied head is the embedding's
    transpose, so it splits the other way.

Training on a (data, model) grid (``grid_params``) builds the split from
the leaves inside each step, so autograd carries every site's gradient
back to the whole leaf: a layer leaf becomes a ``GridLeaf`` that unbinds
into per-layer weights, each joined over ``data`` first when FSDP splits
it there (an all-gather a layer) and then split over ``model``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.distributed.pam_shard import (site_all_gather,
                                               site_all_reduce)


class SiteSplit:
    """One weight held as per-site slices ``parts`` (site order), split
    on dim ``axis`` (-1: the output dim of an ``x @ W`` weight, column
    parallel; -2: the input dim, row parallel). A tree leaf."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts: Sequence[torch.Tensor], axis: int):
        if axis not in (-1, -2):
            raise ValueError(f"SiteSplit: axis must be -1 or -2, got {axis}")
        self.parts = tuple(parts)
        self.axis = axis

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> torch.Size:
        """The whole weight's shape (the sites' slices joined)."""
        dims = list(self.parts[0].shape)
        dims[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(dims)

    @property
    def T(self) -> "SiteSplit":
        """The transpose of a 2-D weight (the tied head of an
        embedding): the split moves to the other dim."""
        return SiteSplit([p.T for p in self.parts], -3 - self.axis)

    def unbind(self) -> list["SiteSplit"]:
        """One ``SiteSplit`` a slice of the leading (stacked layer) axis."""
        per_site = [torch.unbind(p, 0) for p in self.parts]
        return [SiteSplit(layer, self.axis) for layer in zip(*per_site)]

    def site_nbytes(self) -> int:
        """Bytes one site holds (the sites' slices are equal)."""
        p = self.parts[0]
        return p.numel() * p.element_size()


def split(t: torch.Tensor, dim: int, shard: int) -> SiteSplit:
    """``t`` as ``shard`` equal views along ``dim`` (non-negative)."""
    n = t.shape[dim] // shard
    return SiteSplit([t.narrow(dim, r * n, n) for r in range(shard)],
                     dim - t.dim())


def shard_params(params: Any, specs: dict[str, tuple], shard: int) -> Any:
    """The engine's parameter tree with every leaf whose spec splits
    (``sharding.param_specs``) as a ``SiteSplit`` of views; replicated
    leaves stay as they are, and so does a leaf with no elements (an
    absent shared expert's ``(L, 0)`` placeholder, whose spec may name
    the stacked layer axis: cutting it would cut the layer count)."""
    from repro_torch.distributed.sharding import split_axis
    leaves = []
    for path, leaf in tree.leaves_with_paths(params):
        ax = split_axis(specs[path])
        whole = ax is None or leaf.numel() == 0
        leaves.append(leaf if whole else split(leaf, ax, shard))
    return tree.unflatten(params, leaves)


def unbind(leaf) -> Sequence:
    """A stacked leaf's per-layer slices (``torch.unbind(leaf, 0)``)."""
    if isinstance(leaf, (SiteSplit, GridLeaf)):
        return leaf.unbind()
    return torch.unbind(leaf, 0)


def site_nbytes(params: Any) -> int:
    """Bytes of ``params`` one site holds: a split leaf at its site shape,
    a replicated leaf whole."""
    return sum(leaf.site_nbytes() if isinstance(leaf, SiteSplit)
               else leaf.numel() * leaf.element_size()
               for leaf in tree.leaves(params))


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``, per site when ``w`` is a ``SiteSplit``."""
    if not isinstance(w, SiteSplit):
        return x @ w
    if w.axis == -1:                                   # column parallel
        return site_all_gather([x @ p for p in w.parts], dim=-1)
    xs = torch.split(x, [p.shape[-2] for p in w.parts], dim=-1)
    partial = [(xi @ p).float() for xi, p in zip(xs, w.parts)]
    return site_all_reduce(partial).to(x.dtype)        # row parallel


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up) @ w_down``. With ``w_gate`` /
    ``w_up`` column-split and ``w_down`` row-split alike, each site runs
    its ffn slice whole and the sites' partials are summed in fp32 in
    site order and cast once (no join of the hidden activations)."""
    if (isinstance(w_gate, SiteSplit) and isinstance(w_up, SiteSplit)
            and isinstance(w_down, SiteSplit) and w_gate.axis == -1
            and w_up.axis == -1 and w_down.axis == -2
            and len(w_gate.parts) == len(w_down.parts)
            and all(g.shape[-1] == dn.shape[-2]
                    for g, dn in zip(w_gate.parts, w_down.parts))):
        partial = [((F.silu(x @ g) * (x @ u)) @ dn).float()
                   for g, u, dn in zip(w_gate.parts, w_up.parts,
                                       w_down.parts)]
        return site_all_reduce(partial).to(x.dtype)
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_up), w_down)


def head_sites(wq, wk, wv, wo, n_heads: int, n_kv: int) -> int:
    """The site count when an attention's heads split whole over the
    sites (``wq`` / ``wk`` / ``wv`` column-split and ``wo`` row-split
    into g slices, ``n_heads`` and ``n_kv`` divisible by g), else 0."""
    if not all(isinstance(w, SiteSplit) for w in (wq, wk, wv, wo)):
        return 0
    g = len(wq.parts)
    ok = (wq.axis == wk.axis == wv.axis == -1 and wo.axis == -2
          and len(wk.parts) == len(wv.parts) == len(wo.parts) == g
          and n_heads % g == 0 and n_kv % g == 0)
    return g if ok else 0


def expert_ffn(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The routed experts' SwiGLU on their batches xe (E, C, d):
    ``silu(xe @ w_gate) * (xe @ w_up) @ w_down``, three ``torch.bmm``s.
    With the weights as ``SiteSplit``s on the expert ffn dim (``w_gate``
    / ``w_up`` its columns, ``w_down`` its rows), each site computes the
    whole product on its ffn slice, and the sites' partials (E, C, d)
    are summed in fp32 in site order and cast once."""
    if not isinstance(w_gate, SiteSplit):
        return torch.bmm(F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up),
                         w_down)
    partial = [torch.bmm(F.silu(torch.bmm(xe, g)) * torch.bmm(xe, u),
                         dn).float()
               for g, u, dn in zip(w_gate.parts, w_up.parts, w_down.parts)]
    return site_all_reduce(partial).to(xe.dtype)


def embedding(w, ids: torch.Tensor) -> torch.Tensor:
    """``w[ids]``, per site when ``w`` is a ``SiteSplit``."""
    if not isinstance(w, SiteSplit):
        return w[ids]
    if w.axis == -1:                                   # d parallel
        return site_all_gather([p[ids] for p in w.parts], dim=-1)
    rows, lo = [], 0                                   # vocab parallel
    for p in w.parts:
        n = p.shape[0]
        local = ids - lo
        own = (local >= 0) & (local < n)
        e = p[torch.where(own, local, torch.zeros_like(local))]
        rows.append(torch.where(own[..., None], e, torch.zeros_like(e))
                    .float())
        lo += n
    return site_all_reduce(rows).to(w.dtype)


# ------------------------------------------------------------ training
def place(t: torch.Tensor, spec: tuple, data: int, model: int):
    """One weight (or one layer's slice of a stacked one) on a (data,
    model) grid: joined over ``data`` when the spec splits it there
    (FSDP: each data site's slice, all-gathered in site order), then
    split over ``model`` into a ``SiteSplit`` of views when the spec
    splits it there; a plain tensor otherwise."""
    from repro_torch.distributed.sharding import axis_dim
    ax = axis_dim(spec, "data")
    if ax is not None and data > 1:
        t = site_all_gather(torch.chunk(t, data, dim=ax), dim=ax)
    mx = axis_dim(spec, "model")
    if mx is not None and model > 1 and t.numel():
        return split(t, mx, model)
    return t


class GridLeaf:
    """A stacked (L, ...) layer leaf on a training grid: ``unbind``
    gives each layer's weight placed by ``spec`` (``place``), so an FSDP
    leaf is joined once a layer. A tree leaf."""

    __slots__ = ("tensor", "spec", "data", "model")

    def __init__(self, tensor: torch.Tensor, spec: tuple, data: int,
                 model: int):
        self.tensor, self.spec = tensor, spec
        self.data, self.model = data, model

    def unbind(self) -> list:
        return [place(t, self.spec[1:], self.data, self.model)
                for t in torch.unbind(self.tensor, 0)]


def grid_params(params: Any, specs: dict[str, tuple], grid) -> Any:
    """The parameter tree a train step's forward reads on ``grid``:
    the stacked layer leaves as ``GridLeaf``s, every other leaf placed
    (``place``). Built from the leaves inside the step, so every view
    carries its gradient to its leaf."""
    data, model = grid.shape.get("data", 1), grid.shape.get("model", 1)
    out = []
    for path, leaf in tree.leaves_with_paths(params):
        spec = specs[path]
        out.append(GridLeaf(leaf, spec, data, model)
                   if path.startswith("layers.")
                   else place(leaf, spec, data, model))
    return tree.unflatten(params, out)


def pin(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``x`` held as the ambient grid's model sites hold it
    (``perf_flags.abstract_mesh``): split into the sites' slices on each
    dim whose ``spec`` entry names ``model`` (when the sites divide it)
    and joined in site order, the all-gather its next reader does. Data
    entries name the train step's replica split, which has already cut
    the batch. The values are ``x``'s."""
    from repro_torch.distributed.sharding import entry_axes
    from repro_torch.models import perf_flags
    g = perf_flags.abstract_mesh().shape.get("model", 1)
    for dim, entry in enumerate(spec):
        if "model" in entry_axes(entry) and g > 1 and x.shape[dim] % g == 0:
            x = site_all_gather(torch.chunk(x, g, dim=dim), dim=dim)
    return x


def site_blocks(shape: Sequence[int], spec: tuple, grid) -> list[tuple]:
    """The index of each distinct block ``spec`` cuts a leaf of
    ``shape`` into over ``grid`` (one tuple of slices a block, in site
    order: the first split dim slowest); ``[()]`` for a replicated
    leaf. ZeRO-1 updates the AdamW moments block by block."""
    from repro_torch.distributed.sharding import entry_axes
    sizes = grid.shape
    dims = [(i, math.prod(sizes[a] for a in entry_axes(e)))
            for i, e in enumerate(spec) if entry_axes(e)]
    blocks = [()]
    for i, n in dims:
        step = shape[i] // n
        blocks = [b + ((i, slice(r * step, (r + 1) * step)),)
                  for b in blocks for r in range(n)]
    out = []
    for b in blocks:
        idx = [slice(None)] * len(shape)
        for i, sl in b:
            idx[i] = sl
        out.append(tuple(idx))
    return out
