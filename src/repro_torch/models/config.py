"""Architecture configuration schema + registry (the PyTorch port's own
copy of ``repro.models.config``: the port imports nothing of the JAX
package, so the schema, the registry and ``reduced`` live here too).

One ``ModelConfig`` describes any of the assigned families:
dense / moe / ssm / hybrid / audio-encoder / vlm. ``reduced()`` derives the
CPU-smoke-test variant of the same family (few layers, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_expert: int = 0               # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0            # 0 = no q compression


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64              # P
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: groups of mamba layers with a shared attention block."""
    n_groups: int = 13
    mamba_per_group: int = 5
    tail_mamba: int = 3             # trailing pure-mamba layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    causal: bool = True             # audio encoder: False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # modality frontends (stub: precomputed embeddings, see input_specs)
    num_patches: int = 0            # vlm: image patch tokens per sample
    frontend_dim: int = 0           # vlm/audio: stub embedding dim

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # trigger config module imports
        import repro_torch.configs  # noqa: F401
    return _REGISTRY[name]



def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128,
        vocab=256,
        d_head=16,
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        num_shared=min(cfg.moe.num_shared, 1),
                                        d_expert=32)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2,
                              n_groups=1, conv_kernel=4, chunk=16)
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(n_groups=2, mamba_per_group=1,
                                    tail_mamba=1)
        kw["n_layers"] = 5
    if cfg.family == "vlm":
        kw["num_patches"] = 4
        kw["frontend_dim"] = 32
    if cfg.family == "audio":
        kw["frontend_dim"] = 32
    return dataclasses.replace(cfg, **kw)
