"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 backbone with a SHARED
attention+MLP block applied between mamba groups (81 blocks total:
13 x (5 mamba + shared attn) + 3 mamba tail = 68 mamba + 13 attn)."""
from repro_torch.models.config import (HybridConfig, ModelConfig, SSMConfig,
                                       register)

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, d_head=112,
    rope_theta=1e4,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk=128),
    hybrid=HybridConfig(n_groups=13, mamba_per_group=5, tail_mamba=3),
))
