"""Run-time performance switches (counterpart of
``repro.models.perf_flags``), read by the model code as it runs:

  sp_pin      split each dense block's input and output on the sequence
              over the grid's ``model`` sites (``_sp_pin``)
  sp_attn     q-sequence-split attention (``attention.sp_attention``):
              each model site attends its query slice against the whole
              K/V
  bf16_probs  softmax probabilities in bf16 for the PV product (fp32 max
              and sum)
  remat_dots  with ``remat``, the checkpoint saves the weight products
              and recomputes the rest (``torch.utils.checkpoint`` with a
              selective policy)
  moe_pin     the reference's expert-parallel constraints: accepted, no
              number changes (a no-op there too)
  pam_shard_decode  decode attention and the new token's cache write in
              one sequence-sharded pass (``pam_shard.fused_update_decode``)

``REPRO_PERF`` (comma-separated names) sets them through ``from_env``.
Import leaves every flag off. ``abstract_mesh`` is the ambient site grid
(``launch.mesh.SiteGrid``) that ``use_grid`` sets for the code run
inside it, as the reference's ambient mesh; outside one it is a grid
with no axes.
"""

from __future__ import annotations

import contextlib
import os

from repro_torch.launch.mesh import SiteGrid

_FLAGS: set[str] = set()
_GRIDS: list[SiteGrid] = []
_NO_GRID = SiteGrid((), ())


def set_flags(*names: str) -> None:
    _FLAGS.clear()
    _FLAGS.update(names)


def from_env() -> None:
    set_flags(*[f for f in os.environ.get("REPRO_PERF", "").split(",") if f])


def enabled(name: str) -> bool:
    return name in _FLAGS


def active() -> tuple[str, ...]:
    return tuple(sorted(_FLAGS))


def abstract_mesh() -> SiteGrid:
    """The innermost grid ``use_grid`` set, else a grid with no axes."""
    return _GRIDS[-1] if _GRIDS else _NO_GRID


@contextlib.contextmanager
def use_grid(grid: SiteGrid | None):
    """Make ``grid`` the ambient grid inside the block (None: leave the
    ambient grid as it is)."""
    if grid is None:
        yield
        return
    _GRIDS.append(grid)
    try:
        yield
    finally:
        _GRIDS.pop()
