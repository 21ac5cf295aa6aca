"""mamba2-780m [arXiv:2405.21060; unverified] — pure SSD (attention-free).
d_inner=3072, P=64 -> 48 ssm heads, N=128."""
from repro_torch.models.config import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk=128),
))
