"""The paper's own evaluation family (LLaMA-2-7B-like, §7.1) — used by the
perfmodel benchmarks to reproduce Figs. 9-13 at familiar scale."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pam-llama-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000, d_head=128,
    rope_theta=1e4,
))
