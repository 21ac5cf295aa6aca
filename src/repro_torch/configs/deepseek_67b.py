"""deepseek-67b [arXiv:2401.02954; hf] — llama-arch dense GQA."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, d_head=128,
    rope_theta=1e4,
))
