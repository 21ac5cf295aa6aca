"""qwen3-14b [hf:Qwen/Qwen3-8B family; hf] — dense GQA w/ qk-norm."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, d_head=128, qk_norm=True,
    rope_theta=1e6,
))
