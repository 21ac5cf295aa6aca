"""GPipe-style pipeline parallelism over a grid's stage sites
(counterpart of ``repro.distributed.pipeline``).

Layers are grouped into S stages, one a site of the grid's ``stage``
axis; M microbatches stream through the reference's (M + S - 1)-tick
schedule. On tick t, stage s applies its layers to the activation it
holds (stage 0 takes microbatch t) and the activations rotate one stage
on (the reference's ``ppermute``); the last stage emits microbatch
t - (S - 1). One controller drives every stage, so a (stage, tick) pair
that holds no microbatch (the schedule's bubble, which the reference
computes on garbage and discards) is skipped: the outputs are the
same. The last stage's outputs are every stage's (the reference's
broadcast back).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_map


def pipeline_apply(grid, stage_fn: Callable, n_stages: int,
                   axis: str = "stage"):
    """Build a pipelined apply.

    ``stage_fn(stage_params, x) -> x`` applies ONE stage's layers.
    Returns ``run(stacked_params, xs)``: ``stacked_params`` has a leading
    (n_stages,) axis (``stages_from_layers``), ``xs`` is (M, mb, ...);
    the output is shaped like ``xs``."""
    if grid.shape.get(axis) != n_stages:
        raise ValueError(f"the grid's {axis!r} axis must hold {n_stages} "
                         f"sites, got {grid.shape}")

    def run(stacked_params: Any, xs: torch.Tensor) -> torch.Tensor:
        stages = [tree_map(lambda x, s=s: x[s], stacked_params)
                  for s in range(n_stages)]
        M = xs.shape[0]
        held = [None] * n_stages                  # activation in flight
        outputs = [None] * M
        for t in range(M + n_stages - 1):
            out = [None] * n_stages
            for s in range(n_stages):
                mb = t - s                        # the microbatch at s
                if not 0 <= mb < M:
                    continue
                out[s] = stage_fn(stages[s], xs[t] if s == 0 else held[s])
            if out[-1] is not None:               # the last stage emits
                outputs[t - (n_stages - 1)] = out[-1]
            held = [out[(s - 1) % n_stages] for s in range(n_stages)]
        return torch.stack(outputs)

    return run


def stages_from_layers(layer_params: Any, n_stages: int) -> Any:
    """Regroup stacked per-layer params (L, ...) into (n_stages,
    L // n_stages, ...) views."""
    def regroup(x):
        L = x.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    return tree_map(regroup, layer_params)
