"""Model configs the port serves (copies of ``repro.configs`` entries).

Importing this package registers every config; select with
``repro_torch.models.config.get_config(name)`` or ``--arch <id>``.
"""

from repro_torch.configs import (mamba2_780m, pam_llama_7b,  # noqa: F401
                                 qwen3_0_6b, qwen3_moe_235b_a22b)
