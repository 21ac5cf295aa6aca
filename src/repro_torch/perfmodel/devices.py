"""Heterogeneous PIM device classes for the multi-device cluster
(paper §4.3: "the KV interface ... balances load across heterogeneous
PIM devices").

A ``DeviceClass`` parameterizes one *kind* of serving device by scaling
the Table-1 node hardware: an HBM-PIM-class device is fast but holds a
small KV pool; a CXL/DDR-PIM-class device is slower but holds a much
larger pool and batch. ``make_device_latency_model`` turns a class into
the per-step latency model a ``ServingEngine`` runs under, so a cluster
of engines built from different classes models the paper's
heterogeneous fleet with the same injectable-timing machinery single
engines already use (``perfmodel.latency``). Counterpart of
``repro.perfmodel.devices``.

Class registry + the ``--devices hbm:1,cxl:2`` CLI syntax parser live
here so the router, benchmarks and launcher share one source of truth.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.tiers import DDR_PIM, HBM_PIM, SSD_PIM
from repro_torch.perfmodel.latency import make_latency_model
from repro_torch.perfmodel.model import (PAM_LLAMA_7B, ModelDesc, NodeHW,
                                   SystemKind, make_system)


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One kind of serving device in a heterogeneous cluster.

    ``bw_scale`` multiplies every tier's bandwidth/compute (and the NPU
    roofline) relative to the Table-1 node; ``pool_scale`` sizes the
    paged KV pool relative to full residency (``max_batch`` windows), so
    < 1 overcommits and admission backpressure engages earlier.
    """
    name: str
    kind: SystemKind = SystemKind.PAM
    bw_scale: float = 1.0          # tier + NPU bandwidth multiplier
    max_batch: int = 4             # concurrent sequences on this device
    pool_scale: float = 1.0        # pool blocks / full-residency blocks
    context_scale: int = 4096      # engine token -> hardware tokens

    def pool_blocks(self, max_len: int, block_size: int) -> int:
        """Physical pool blocks for a given engine geometry."""
        full = self.max_batch * (max_len // block_size)
        return max(int(round(self.pool_scale * full)), 1)


# The two classes the paper's heterogeneity argument needs: a fast
# small-capacity device and a slow large-capacity one. "cxl" models a
# CXL-attached DDR-PIM expander at the paper's DDR:HBM bandwidth ratio
# (~1:4, Table 1), with twice the batch room and an uncut pool.
HBM_CLASS = DeviceClass("hbm", bw_scale=1.0, max_batch=4, pool_scale=0.75)
CXL_CLASS = DeviceClass("cxl", bw_scale=0.25, max_batch=8, pool_scale=1.0)
DDR_CLASS = DeviceClass("ddr", bw_scale=0.5, max_batch=6, pool_scale=1.0)

DEVICE_CLASSES: dict[str, DeviceClass] = {
    d.name: d for d in (HBM_CLASS, CXL_CLASS, DDR_CLASS)
}


def get_device_class(name: str) -> DeviceClass:
    try:
        return DEVICE_CLASSES[name]
    except KeyError:
        raise ValueError(f"unknown device class {name!r}; have "
                         f"{sorted(DEVICE_CLASSES)}") from None


def parse_devices(spec: str) -> list[DeviceClass]:
    """Parse the launcher syntax ``"hbm:1,cxl:2"`` into a device list
    (one ``DeviceClass`` entry per physical device, order preserved)."""
    out: list[DeviceClass] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        n = int(count) if count else 1
        if n <= 0:
            raise ValueError(f"device count must be positive: {part!r}")
        out.extend([get_device_class(name)] * n)
    if not out:
        raise ValueError(f"empty device spec: {spec!r}")
    return out


def replica_group_class(dc: DeviceClass, group: int) -> DeviceClass:
    """Aggregate ``group`` same-class devices into ONE replica-group
    device: tier/NPU bandwidth and pool capacity scale with the
    member count (the members serve one request stream cooperatively,
    each holding 1/group of the params and KV), while ``max_batch`` and
    ``context_scale`` describe the shared stream and stay per-group.
    Identity at ``group == 1``."""
    if group <= 1:
        return dc
    return dataclasses.replace(dc, bw_scale=dc.bw_scale * group,
                               pool_scale=dc.pool_scale * group)


def _scaled_hw(scale: float) -> NodeHW:
    base = NodeHW()
    s = lambda tier: dataclasses.replace(
        tier, read_bw=tier.read_bw * scale,
        compute_flops=tier.compute_flops * scale,
        link_bw=tier.link_bw * scale)
    return dataclasses.replace(
        base, npu_flops=base.npu_flops * scale,
        npu_hbm_bw=base.npu_hbm_bw * scale,
        pcie_bw=base.pcie_bw * scale,
        hbm=s(HBM_PIM), ddr=s(DDR_PIM), ssd=s(SSD_PIM))


def make_device_latency_model(dc: DeviceClass,
                              model_desc: ModelDesc = PAM_LLAMA_7B):
    """Latency model (engine step stats -> simulated seconds) for one
    device of class ``dc`` — the per-class timing the router/balancer
    cost signals are computed from."""
    system = make_system(dc.kind, hw=_scaled_hw(dc.bw_scale))
    return make_latency_model(system, model_desc,
                              context_scale=dc.context_scale)


def step_time_prior(dc: DeviceClass, model_desc: ModelDesc = PAM_LLAMA_7B,
                    *, batch: int | None = None, context_tokens: int = 64,
                    compression: int = 4) -> float:
    """A-priori decode-step latency estimate for a device class — the
    router's cost signal before the device has stepped once (afterwards
    the engine's real modeled ``last_step_time`` takes over). Assumes a
    PAM working set: ~``context/compression`` participating tokens per
    sequence, concentrated on the hot tier."""
    import numpy as np
    lat = make_device_latency_model(dc, model_desc)
    b = max(batch if batch is not None else dc.max_batch // 2, 1)
    ctx = np.full((b,), context_tokens, np.int64)
    reads = np.array([b * max(context_tokens // compression, 1), 0, 0],
                     np.int64)
    stats = {"prefill_tokens": 0, "active": b, "tier_reads": reads,
             "moved_tokens": 0, "batch_lengths": ctx}
    return float(lat(stats))
