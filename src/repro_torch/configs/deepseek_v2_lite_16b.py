"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE
64 routed top-6 + 2 shared experts."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
))
