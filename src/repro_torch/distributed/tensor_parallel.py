"""Tensor-parallel weights of a sharded serving engine.

A sharded engine holds each parameter leaf that ``sharding.param_specs``
splits as a ``SiteSplit``: one slice a site, in site order. On one card
each slice is a view of the one allocation the weights already have, so
a fleet of engines still shares one copy. The model code reaches every
weight product through ``linear`` and every embedding lookup through
``embedding``, which take a plain tensor as they would (``x @ w``,
``w[ids]``) and a ``SiteSplit`` per site:

  * column-parallel (the output dim split): each site's product, joined
    in site order (an all-gather) before any per-head op, so a split may
    fall inside a head;
  * row-parallel (the input dim split): each site's partial product on
    its slice of the input, summed in site order in fp32 and cast once
    (``pam_shard.site_all_reduce``);
  * a vocab-parallel embedding: each site looks up the ids it owns
    (others read 0) and the sites' rows are summed; a d-parallel one
    joins the sites' columns. The tied head is the embedding's
    transpose, so it splits the other way.
"""

from __future__ import annotations

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
    if isinstance(leaf, SiteSplit):
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
