"""qwen3-0.6b [hf:Qwen/Qwen3-8B family; hf] — small dense GQA w/ qk-norm."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, d_head=128, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True,
))
