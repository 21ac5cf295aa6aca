"""internvl2-1b [arXiv:2404.16821; hf] — InternViT frontend (STUB: patch
embeddings via input_specs) + Qwen2-0.5B-like LM backbone."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, d_head=64,
    rope_theta=1e6, tie_embeddings=True,
    num_patches=256, frontend_dim=1024,
))
