"""Declarative engine construction: ``EngineSpec`` (counterpart of
``repro.serving.spec``).

The spec describes an engine — model, serving policy, shard layout and
name — apart from the runtime inputs (params, latency model, device)
that ``build()`` takes. Frozen and hashable, so specs key caches and
travel through the cluster and CLI layers by value.

``shard > 1`` builds one engine over that many sites
(``distributed.pam_shard``): the parameters tensor-parallel
(``distributed.sharding.param_specs``), the hot ring split on its slot
axis and the pool on its block axis, and each decode step merging the
sites' attention partials with the exact Alg. 1 reduction. Token streams
equal the unsharded engine's. ``validate()`` checks such a spec as the
reference does. Every family with a paged GQA k/v cache shards: dense,
vlm and the GQA mixture-of-experts (its experts split on their ffn
dim). The MLA, hybrid and SSM families keep no such cache: their engine
raises the reference's ``ValueError`` from ``init_decode_cache`` on a
paged spec, at any shard, before ``validate()`` runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import ServingConfig, ServingEngine


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """What an engine is: model + serving policy + shard layout + name.

    ``validate()`` raises actionable ``ValueError``s for spec-level
    inconsistencies (shard divisibility) without touching a device.
    """

    model: ModelConfig
    serving: ServingConfig = ServingConfig()
    shard: int = 1
    name: str = "dev0"

    def validate(self) -> "EngineSpec":
        s, scfg = self.shard, self.serving
        if s < 1:
            raise ValueError(f"EngineSpec.shard must be >= 1, got {s}")
        if s == 1:
            return self
        if scfg.pam is None or not scfg.block_size:
            raise ValueError(
                f"shard={s} requires the PAM paged path (pam config + "
                f"block_size > 0): the sharded decode step splits the "
                f"hot ring and the paged pool across the mesh")
        window = scfg.hot_window or scfg.max_len
        if window % s:
            raise ValueError(
                f"shard={s}: hot ring of {window} slots does not split "
                f"evenly — pick hot_window (or max_len) divisible by "
                f"{s}, e.g. hot_window={-(-window // s) * s}")
        nb = self.total_pool_blocks()
        if nb % s:
            raise ValueError(
                f"shard={s}: pool of {nb} physical blocks (pool_blocks "
                f"+ 1 sentinel) does not split evenly — pass "
                f"pool_blocks={-(-nb // s) * s - 1} instead of "
                f"{nb - 1}")
        return self

    def total_pool_blocks(self) -> int:
        """Physical pool blocks including the sentinel trash block; 0
        when dense."""
        scfg = self.serving
        if not scfg.block_size:
            return 0
        per_seq = scfg.max_len // max(scfg.block_size, 1)
        nb = (scfg.pool_blocks if scfg.pool_blocks is not None
              else scfg.max_batch * per_seq)
        return nb + 1

    def build(self, params: Any, *,
              latency_model: Optional[Callable[[dict], float]] = None,
              device: str | torch.device | None = None) -> ServingEngine:
        """The engine (on CUDA unless ``device`` names another).
        ``params`` are used as they are, never copied."""
        return ServingEngine(self, params, latency_model=latency_model,
                             device=device)
