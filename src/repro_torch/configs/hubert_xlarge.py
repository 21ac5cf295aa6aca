"""hubert-xlarge [arXiv:2106.07447; unverified] — encoder-only audio
transformer (w2v2 arch); conv feature extractor is a STUB: input_specs
provides precomputed frame embeddings (frontend_dim=512)."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, d_head=80, causal=False,
    frontend_dim=512,
))
