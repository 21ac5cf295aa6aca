"""Site grids: the port's counterpart of ``repro.launch.mesh``.

The reference lays its devices out as a ``jax.sharding.Mesh`` over named
axes (``("data", "model")``, or ``("pod", "data", "model")`` across
pods). The port runs one controller, as the sharded engine does
(``distributed.pam_shard``): a ``SiteGrid`` names the same axes over
sites that all live on one device, each site holding its slice of a
tensor as a view of the one allocation. The spec rules of
``distributed.sharding`` read a grid the way the reference's read a
mesh, through ``shape`` (axis name -> size) and ``axis_names``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SiteGrid:
    """Sites over named axes (``sizes[i]`` along ``axis_names[i]``), in
    row-major site order, all on ``device``."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: Optional[torch.device] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} vs sizes {self.sizes}")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"grid sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_grid(sizes: Sequence[int] = (1, 1),
              axis_names: Sequence[str] = ("data", "model"),
              device: str | torch.device | None = None) -> SiteGrid:
    """A grid of ``sizes`` sites along ``axis_names`` on ``device`` (CUDA
    unless the caller names another): the reference's
    ``jax.make_mesh(sizes, axis_names)``."""
    return SiteGrid(tuple(axis_names), tuple(int(n) for n in sizes),
                    resolve_device(device))


def grid_from_sites(n_sites: int, model_parallel: int,
                    device: str | torch.device | None = None) -> SiteGrid:
    """The best (data, model) grid over ``n_sites`` sites (the survivors
    of a failure): the reference's ``make_mesh_from_devices``, halving
    ``model_parallel`` until it divides and dropping the remainder."""
    while n_sites % model_parallel and model_parallel > 1:
        model_parallel //= 2
    return make_grid((n_sites // model_parallel, model_parallel),
                     device=device)


def dp_axes(grid) -> tuple[str, ...]:
    """The data-parallel axes of a grid (or of a mesh)."""
    return tuple(a for a in grid.axis_names if a in ("pod", "data"))


def dp_size(grid) -> int:
    out = 1
    for a in dp_axes(grid):
        out *= grid.shape[a]
    return out
