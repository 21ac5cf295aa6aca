"""Analytical model of PAM + the four baselines (paper §7.1 methodology);
counterpart of ``repro.perfmodel.model``.

The paper evaluates with an in-house simulator (LLMServingSim + LLMCompass
+ Ramulator2 + OpenSSD). This module reproduces that methodology
analytically: every system is reduced to roofline terms over the same
hardware constants (Table 1). The *real* algorithmic state (hit rates,
tier occupancy, migration counts) is fed from the actual serving engine
(``EngineSpec.build(params, latency_model=...)``), closing the loop
between the executable system and the model. Its times are those of the
simulated PIM hardware, not of the device the port runs on.

Platform (paper §7.1): one node = 8 x (H100-80GB-class NPU) + 40xHBM +
40xDDR4 + 64ch SSD; PAM adds near-bank/controller PUs+RUs per Table 1.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from repro_torch.core.tiers import DDR_PIM, HBM_PIM, SSD_PIM, TierSpec


class SystemKind(str, enum.Enum):
    VLLM_OFFLOAD = "vllm-offload"
    ATTACC = "attacc"
    LPIM = "l-pim"
    LSPIM = "ls-pim"
    PAM = "pam"


@dataclasses.dataclass(frozen=True)
class ModelDesc:
    """Decode-step cost descriptor (enough for the paper's models)."""
    name: str
    params: float                 # active parameters
    n_layers: int
    n_kv_heads: int
    head_dim: int
    latent_dim: int = 0           # MLA: cached latent width (0 = GQA)

    def kv_bytes_per_token(self) -> float:
        if self.latent_dim:
            return self.n_layers * self.latent_dim * 2.0
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * 2.0


# paper's evaluation models
QWEN25_32B = ModelDesc("qwen2.5-32b", 32e9, 64, 8, 128)
LLAMA3_70B = ModelDesc("llama3-70b", 70e9, 80, 8, 128)
OPT_175B = ModelDesc("opt-175b", 175e9, 96, 96, 128)
PAM_LLAMA_7B = ModelDesc("pam-llama-7b", 6.7e9, 32, 32, 128)


@dataclasses.dataclass(frozen=True)
class NodeHW:
    """Per-node hardware (8-instance node, DGX-H100-comparable)."""
    npu_flops: float = 8 * 989e12          # bf16 dense
    npu_hbm_bw: float = 8 * 3.35e12
    hbm_cap: float = 8 * 80e9
    pcie_bw: float = 8 * 64e9              # offload path
    nvlink_bw: float = 8 * 450e9           # TP all-reduce path
    hbm: TierSpec = HBM_PIM
    ddr: TierSpec = DDR_PIM
    ssd: TierSpec = SSD_PIM
    # energy constants (pJ)
    pj_per_flop: float = 0.6
    pj_per_byte_pcie: float = 30.0
    pj_per_byte_nvlink: float = 10.0


@dataclasses.dataclass(frozen=True)
class SystemModel:
    kind: SystemKind
    hw: NodeHW = NodeHW()
    sparsity: int = 1             # retrieval compression (8 for LS-PIM/PAM)
    pam_hit_rate: float = 0.9     # hot-set fraction served from HBM tier
    mapping_imbalance: float = 1.0  # intra-device T_intra inflation
    reduction_overhead: float = 0.02  # PAMattention RU time share (<2%, §5.2)
    migrate_fraction: float = 0.001   # working-set fraction migrated/step (§6.3: <0.1%)

    # ------------------------------------------------------------ capacity
    def _caps(self, model: ModelDesc) -> tuple[float, float, float]:
        """Per-tier KV capacity: model weights occupy the top (HBM) tier."""
        hw = self.hw
        wbytes = 2.0 * model.params
        top = hw.hbm_cap if self.kind in (SystemKind.VLLM_OFFLOAD,
                                          SystemKind.ATTACC)             else hw.hbm.capacity_bytes
        return (max(top - wbytes, 0.0), hw.ddr.capacity_bytes,
                hw.ssd.capacity_bytes)

    def kv_capacity(self, model: ModelDesc) -> float:
        caps = self._caps(model)
        if self.kind == SystemKind.ATTACC:
            return caps[0]
        return sum(caps)

    # --------------------------------------------------------- placement
    def _tier_split(self, model: ModelDesc, kv_bytes: float
                    ) -> tuple[float, float, float]:
        """Fill-down placement of the resident KV across tiers."""
        out = []
        rest = kv_bytes
        for c in self._caps(model):
            take = min(rest, c)
            out.append(take)
            rest -= take
        return tuple(out)

    # ------------------------------------------------------------- timing
    def fc_time(self, model: ModelDesc, batch: int) -> float:
        """Projection/FFN step time on the NPU (weight-bandwidth bound at
        small batch, compute bound at large batch) — same for all systems."""
        hw = self.hw
        flops = 2.0 * model.params * batch
        wbytes = 2.0 * model.params
        return max(flops / hw.npu_flops, wbytes / hw.npu_hbm_bw)

    def attention_time(self, model: ModelDesc, batch: int,
                       context: int) -> float:
        """Per-decode-step attention time under this system's policy."""
        hw = self.hw
        tok = model.kv_bytes_per_token()
        kv_total = batch * context * tok
        read_frac = 1.0 / self.sparsity
        h0, d0, s0 = self._tier_split(model, kv_total)

        if self.kind == SystemKind.VLLM_OFFLOAD:
            # attention on NPU; resident-HBM KV reads sparsely at HBM bw;
            # offloaded KV must cross PCIe at FULL volume every step —
            # token selection is per-step/per-head dynamic, so offloaded
            # pages cannot be sparsity-filtered before the transfer
            # (DeepSpeed-Inference offloading, §2.3.3)
            t_hbm = h0 * read_frac / hw.npu_hbm_bw
            t_pcie = (d0 + s0) / hw.pcie_bw
            return t_hbm + t_pcie

        if self.kind == SystemKind.ATTACC:
            if kv_total > self._caps(model)[0]:
                return math.inf                     # OOM (Fig. 10)
            return kv_total * read_frac / hw.hbm.effective_bw

        if self.kind in (SystemKind.LPIM, SystemKind.LSPIM):
            # tiers compute in parallel; sparse reads are UNIFORM across
            # tiers (static placement — no locality exploitation):
            reads = (h0 * read_frac, d0 * read_frac, s0 * read_frac)
            times = (reads[0] / hw.hbm.effective_bw,
                     reads[1] / hw.ddr.effective_bw,
                     reads[2] / hw.ssd.effective_bw)
            return max(times)                        # SSD-Attn bottleneck

        # PAM: the sparse working set is concentrated on fast tiers by
        # importance placement (hit_rate on HBM), Alg. 2 keeps it there.
        ws = kv_total * read_frac                    # working set bytes
        h = self.pam_hit_rate
        caps = self._caps(model)
        hot = min(ws * h, caps[0])
        warm = min(ws - hot, caps[1])    # misses go to DDR; SSD only when
        cold = max(ws - hot - warm, 0.0)  # HBM+DDR truly overflow
        times = (hot * self.mapping_imbalance / hw.hbm.effective_bw,
                 warm * self.mapping_imbalance / hw.ddr.effective_bw,
                 cold / hw.ssd.effective_bw)
        t_local = max(times)
        # inter-tier migration (Alg. 2: ~0.1% of the working set per step,
        # over the HBM<->DDR link through the PAM interface) + RU overhead
        t_mig = self.migrate_fraction * ws / self.hw.hbm.link_bw
        return t_local * (1 + self.reduction_overhead) + t_mig

    def decode_step_time(self, model: ModelDesc, batch: int,
                         context: int) -> float:
        return (self.fc_time(model, batch)
                + self.attention_time(model, batch, context))

    # ------------------------------------------------------------- energy
    def decode_step_energy(self, model: ModelDesc, batch: int,
                           context: int) -> float:
        """Joules per decode step."""
        hw = self.hw
        tok = model.kv_bytes_per_token()
        kv_total = batch * context * tok
        read_frac = 1.0 / self.sparsity
        flops = 2.0 * model.params * batch
        e = flops * hw.pj_per_flop * 1e-12
        e += 2.0 * model.params * 3.5 * 1e-12        # weight read (HBM)
        h0, d0, s0 = self._tier_split(model, kv_total)
        if self.kind == SystemKind.VLLM_OFFLOAD:
            e += h0 * read_frac * 3.5e-12
            e += (d0 + s0) * (hw.pj_per_byte_pcie + 15.0) * 1e-12
        elif self.kind == SystemKind.ATTACC:
            e += kv_total * read_frac * hw.hbm.energy_pj_per_byte * 1e-12
        elif self.kind in (SystemKind.LPIM, SystemKind.LSPIM):
            for b, t in ((h0, hw.hbm), (d0, hw.ddr), (s0, hw.ssd)):
                e += b * read_frac * t.energy_pj_per_byte * 1e-12
        else:
            ws = kv_total * read_frac
            h = self.pam_hit_rate
            caps = self._caps(model)
            hot = min(ws * h, caps[0])
            warm = min(ws - hot, caps[1])
            cold = max(ws - hot - warm, 0.0)
            e += hot * hw.hbm.energy_pj_per_byte * 1e-12
            e += warm * hw.ddr.energy_pj_per_byte * 1e-12
            e += cold * hw.ssd.energy_pj_per_byte * 1e-12
            e += (self.migrate_fraction * ws * 15.0) * 1e-12
        return e


def make_system(kind: SystemKind | str, **kw) -> SystemModel:
    kind = SystemKind(kind)
    defaults = {
        # vLLM-offload: sparse reads only on the HBM-resident part (the
        # offload path transfers full pages); L-PIM: no sparsity (mimics
        # AttAcc placement, §7.1); LS-PIM/PAM/AttAcc: 8x retrieval sparsity.
        SystemKind.VLLM_OFFLOAD: dict(sparsity=8),
        SystemKind.ATTACC: dict(sparsity=8),
        SystemKind.LPIM: dict(sparsity=1),
        SystemKind.LSPIM: dict(sparsity=8),
        SystemKind.PAM: dict(sparsity=8),
    }[kind]
    defaults.update(kw)
    return SystemModel(kind=kind, **defaults)


# ------------------------------------------------------------ simulations
@dataclasses.dataclass(frozen=True)
class StepWorkload:
    model: ModelDesc
    batch: int
    context: int


def simulate_decode_step(system: SystemModel, wl: StepWorkload) -> dict:
    t = system.decode_step_time(wl.model, wl.batch, wl.context)
    e = system.decode_step_energy(wl.model, wl.batch, wl.context)
    return {"time_s": t, "energy_j": e,
            "throughput_tok_s": (wl.batch / t) if math.isfinite(t) else 0.0,
            "energy_per_token_j": (e / wl.batch)
            if math.isfinite(t) else math.inf}


def simulate_online(system: SystemModel, model: ModelDesc, *,
                    avg_context: int, slo_s: float,
                    max_batch: int = 1 << 17) -> dict:
    """Paper Fig. 9 protocol: largest batch whose per-token decode latency
    meets the SLO under the capacity limit; report throughput."""
    tok = model.kv_bytes_per_token()
    best = None
    b = 1
    while b <= max_batch:
        if b * avg_context * tok > system.kv_capacity(model):
            break
        t = system.decode_step_time(model, b, avg_context)
        if t <= slo_s:
            best = (b, b / t)
        b *= 2
    if best is None:
        return {"max_batch": 0, "throughput_tok_s": 0.0}
    # refine between best and 2*best
    lo, hi = best[0], min(best[0] * 2, max_batch)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if (mid * avg_context * tok <= system.kv_capacity(model)
                and system.decode_step_time(model, mid, avg_context)
                <= slo_s):
            lo = mid
        else:
            hi = mid
    t = system.decode_step_time(model, lo, avg_context)
    return {"max_batch": lo, "throughput_tok_s": lo / t}


def simulate_offline(system: SystemModel, model: ModelDesc, *,
                     batch: int, context: int) -> dict:
    """Paper Fig. 10 protocol: fixed batch size; OOM if over capacity."""
    tok = model.kv_bytes_per_token()
    if batch * context * tok > system.kv_capacity(model):
        return {"oom": True, "throughput_tok_s": 0.0}
    t = system.decode_step_time(model, batch, context)
    return {"oom": not math.isfinite(t),
            "throughput_tok_s": (batch / t) if math.isfinite(t) else 0.0}
