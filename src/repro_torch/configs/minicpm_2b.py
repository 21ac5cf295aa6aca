"""minicpm-2b [arXiv:2404.06395; hf] — llama-like MHA; WSD schedule lives
in the trainer (repro.training.optim.wsd_schedule)."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, d_head=64,
    rope_theta=1e4,
))
