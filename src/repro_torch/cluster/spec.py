"""Declarative cluster construction: ``ClusterSpec`` (counterpart of
``repro.cluster.spec``).

A frozen spec says what the fleet is (model, device classes, replica
groups, serving template) and which policies run on it (balancer,
router, recovery, timing); runtime instances (params, a chaos injector,
a pre-built balancer, the device) are arguments of ``build``. ``from_cli`` keeps the launcher
syntax (``--devices hbm:1,cxl:2``).

``build`` gives every engine the same params tensors: one copy of the
weights on the device, whatever the fleet's size. The device classes
are the perf model's (``repro_torch.perfmodel.devices``): each engine
gets its class's batch, pool and latency model, and all of them run on
the one device given. A replica group of ``g > 1`` devices is one
engine sharded over ``g`` sites (``EngineSpec(shard=g)``: 1/g of the
weights and of the KV a site), its pool rounded so that the block axis
splits; ``from_cli("hbm:1,cxl:2", shard=2)`` forms a lone hbm engine
beside one 2-way cxl group. The sites of every group share the one
device too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import torch

from repro_torch.cluster.balancer import BalancerConfig, KVBalancer
from repro_torch.cluster.recovery import RecoveryConfig, RecoveryManager
from repro_torch.cluster.router import (ClusterDevice, ClusterRouter,
                                        RouterConfig)
from repro_torch.models.config import ModelConfig
from repro_torch.perfmodel.devices import (DeviceClass,
                                           make_device_latency_model,
                                           parse_devices,
                                           replica_group_class,
                                           step_time_prior)
from repro_torch.serving.engine import ServingConfig
from repro_torch.serving.spec import EngineSpec


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """``devices`` same-class physical devices backing one logical
    engine (one shared, ``devices``-way-sharded param replica)."""
    cls: DeviceClass
    devices: int = 1

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"replica group needs >= 1 device, got "
                             f"{self.devices}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A heterogeneous serving fleet.

    ``groups`` is the device topology (ordered); ``serving`` the
    per-engine template each group specializes by its class's capacity
    (``max_batch``, pool blocks); ``wallclock`` drops the modeled
    latency (each engine's clock is then the host's wall clock)."""
    model: ModelConfig
    groups: tuple[ReplicaGroup, ...]
    serving: ServingConfig
    model_desc: Optional[object] = None
    balancer: Optional[BalancerConfig] = None
    router: RouterConfig = RouterConfig()
    recovery: Optional[RecoveryConfig] = None
    wallclock: bool = False

    def __post_init__(self):
        if not self.groups:
            raise ValueError("cluster spec needs at least one replica "
                             "group (try ClusterSpec.from_cli('hbm:1', "
                             "model=..., serving=...))")

    # ------------------------------------------------------- constructors
    @classmethod
    def of(cls, model: ModelConfig,
           device_classes: Iterable[DeviceClass], *,
           serving: ServingConfig, shard: int = 1,
           **kw) -> "ClusterSpec":
        """Spec from a flat device list (one entry per physical device,
        ``parse_devices`` order). ``shard`` groups consecutive runs of
        the same class into ``shard``-way replica groups; a run shorter
        than ``shard`` forms one group of its own size, and a longer run
        must divide evenly (the error says what to change)."""
        if shard < 1:
            raise ValueError(f"shard must be >= 1, got {shard}")
        entries = list(device_classes)
        groups: list[ReplicaGroup] = []
        i = 0
        while i < len(entries):
            dc = entries[i]
            run = 1
            while i + run < len(entries) and entries[i + run] == dc:
                run += 1
            g = min(shard, run)
            if run % g:
                want = -(-run // shard) * shard
                raise ValueError(
                    f"device class {dc.name!r} has a run of {run} "
                    f"devices, which does not split into {shard}-way "
                    f"replica groups; use {dc.name}:{want} or a shard "
                    f"that divides {run}")
            groups.extend([ReplicaGroup(dc, g)] * (run // g))
            i += run
        return cls(model=model, groups=tuple(groups), serving=serving,
                   **kw)

    @classmethod
    def from_cli(cls, devices: str, *, model: ModelConfig,
                 serving: ServingConfig, shard: int = 1,
                 **kw) -> "ClusterSpec":
        """Launcher syntax: ``from_cli("hbm:1,cxl:2", ...)``. Bad class
        names, counts or shards raise ``ValueError``."""
        return cls.of(model, parse_devices(devices), serving=serving,
                      shard=shard, **kw)

    def cli(self) -> str:
        """Canonical ``--devices`` string for this topology (physical
        devices, consecutive same-class groups merged): the round-trip
        twin of ``from_cli``."""
        parts: list[tuple[str, int]] = []
        for grp in self.groups:
            if parts and parts[-1][0] == grp.cls.name:
                parts[-1] = (grp.cls.name, parts[-1][1] + grp.devices)
            else:
                parts.append((grp.cls.name, grp.devices))
        return ",".join(f"{n}:{c}" for n, c in parts)

    @property
    def physical_devices(self) -> int:
        return sum(g.devices for g in self.groups)

    # ------------------------------------------------------------- build
    def build(self, params: Any, *, balancer: Optional[KVBalancer] = None,
              device: str | torch.device | None = None,
              faults=None, recovery: Optional[RecoveryManager] = None
              ) -> ClusterRouter:
        """The fleet: one engine per replica group on ``device`` (CUDA
        unless named), all sharing ``params``; the perf model's latency
        per class unless ``wallclock``; a balancer and a recovery manager
        from the spec's configs unless instances are passed. A bare
        ``faults`` injector implies a default recovery manager (injected
        faults without a watchdog would hang the stream)."""
        from repro_torch.perfmodel.model import PAM_LLAMA_7B
        model_desc = self.model_desc or PAM_LLAMA_7B
        scfg = self.serving
        devices: list[ClusterDevice] = []
        counts: dict[str, int] = {}
        for grp in self.groups:
            dc, g = grp.cls, grp.devices
            idx = counts.get(dc.name, 0)
            counts[dc.name] = idx + 1
            name = f"{dc.name}{idx}"
            gdc = replica_group_class(dc, g)
            pool = (gdc.pool_blocks(scfg.max_len, scfg.block_size)
                    if scfg.block_size else None)
            if pool is not None and g > 1:
                # the pool's block axis (sentinel included) shards over
                # the group: round up to the next multiple of g
                pool = -(-(pool + 1) // g) * g - 1
            dev_scfg = dataclasses.replace(scfg, max_batch=gdc.max_batch,
                                           pool_blocks=pool)
            lat = (None if self.wallclock
                   else make_device_latency_model(gdc, model_desc))
            eng = EngineSpec(model=self.model, serving=dev_scfg,
                             shard=g, name=name).build(
                                 params, latency_model=lat, device=device)
            prior = (step_time_prior(gdc, model_desc)
                     if not self.wallclock else 0.0)
            ppt = (float(lat({"prefill_tokens": 1, "active": 0}))
                   if lat is not None else 0.0)
            devices.append(ClusterDevice(name=name, cls=gdc, engine=eng,
                                         step_prior=prior,
                                         prefill_tok_prior=ppt,
                                         base_latency=lat))
        if balancer is None and self.balancer is not None:
            balancer = KVBalancer(self.balancer)
        if (balancer is not None and not self.wallclock
                and not balancer.token_bytes):
            balancer.token_bytes = model_desc.kv_bytes_per_token()
        rec = recovery
        if rec is None:
            if self.recovery is not None:
                rec = RecoveryManager(self.recovery, injector=faults)
            elif faults is not None:
                rec = RecoveryManager(injector=faults)
        return ClusterRouter(devices, balancer=balancer,
                             rcfg=self.router, recovery=rec,
                             faults=faults)
