"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf] — GQA w/ qk-norm,
128 experts top-8."""
from repro_torch.models.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, d_head=128, qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, num_shared=0, d_expert=1536),
))
